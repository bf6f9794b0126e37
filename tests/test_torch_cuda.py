"""Each CUDA kernel of ``repro_torch`` against its plain PyTorch version,
on the card, bit for bit (flash attention within the JAX parity test's
tolerances), and a reduced serving run on the card against the CPU.
Marked ``cuda``: they skip where there is no GPU.  This file imports neither JAX nor ``repro``, so it runs on the GPU
machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.core import ocs
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.maxpool import ops as MPO
from repro_torch.kernels.maxpool import ref as MPR
from repro_torch.kernels.ocs_contention import ops as CO
from repro_torch.kernels.ocs_contention import ref as CR
from repro_torch.kernels.ocs_quant import ops as QO
from repro_torch.kernels.ocs_quant import ref as QR
from repro_torch.models import model as TM
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

_DT = {"float32": (torch.float32, torch.int32),
       "bfloat16": (torch.bfloat16, torch.int16),
       "float16": (torch.float16, torch.int16)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _as_ints(t: torch.Tensor) -> torch.Tensor:
    if t.dtype in (torch.bfloat16, torch.float16, torch.uint16):
        return t.view(torch.int16)
    if t.dtype in (torch.float32, torch.uint32):
        return t.view(torch.int32)
    return t


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_as_ints(a.cpu()), _as_ints(b.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_quant_and_maxpool_match_plain(cuda_device, bits, dtype):
    tdt = _DT[dtype][0]
    gen = torch.Generator().manual_seed(bits)
    x = (torch.randn((4, 4, 4099), generator=gen) * 5).to(tdt)
    x.view(-1)[:4] = torch.tensor([0.0, -0.0, float("inf"), -float("inf")])
    xc = x.to(cuda_device)
    codes = QO.encode(xc, bits)
    _same(QR.encode(x, bits), codes)
    # an offset view: the kernel's unaligned (scalar) path
    _same(QR.encode(x.reshape(-1)[1:], bits),
          QO.encode(xc.reshape(-1)[1:], bits))
    _same(QR.decode(codes.cpu(), bits, tdt), QO.decode(codes, bits, tdt))
    for h in (codes, xc):
        v, w = MPO.maxpool_fused(h, 1)
        rv, rw = MPR.maxpool_fused(h.cpu(), 1)
        _same(rv, v)
        _same(rw, w)
    g = torch.randn(w.shape, generator=gen).to(tdt)
    _same(MPR.maxpool_winner_bwd(rw, g, 4, 1),
          MPO.maxpool_winner_bwd(w, g.to(cuda_device), 4, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_real,bits,id_pad", [(4, 4, 8, 0), (4, 4, 16, 0),
                                                  (9, 6, 8, 2), (64, 64, 8, 0),
                                                  (33, 20, 16, 3)])
@pytest.mark.parametrize("p_miss", [0.0, 0.1, 0.6])
def test_contend_matches_plain(cuda_device, n, n_real, bits, id_pad,
                               p_miss):
    """Lanes x padded workers x padded scan bound, packed draws and all."""
    lanes, k, rounds = 3, 1000, 3
    id_bits = ocs.host_id_bits(n_real)
    n_slots = bits + id_bits + id_pad
    gen = torch.Generator().manual_seed(n)
    h = torch.randn((lanes, n, k), generator=gen)
    word = CR.contention_words(h, bits, id_bits)
    mask = torch.arange(n) < n_real
    keys = jr.split(jr.PRNGKey(n), lanes)
    p_keep = ocs.sensing_keep_prob(torch.full((lanes,), p_miss), lanes=True)
    heard = CR.draw_heard_packed(keys, p_keep, n, k, n_slots=n_slots,
                                 max_rounds=rounds)
    heard_c = CR.draw_heard_packed(keys.to(cuda_device),
                                   p_keep.to(cuda_device), n, k,
                                   n_slots=n_slots, max_rounds=rounds)
    _same(heard, heard_c)
    kw = dict(n_slots=n_slots, max_rounds=rounds)
    want = CO.contend(word, heard, mask, bits + id_bits, **kw)
    got = CO.contend(word.to(cuda_device), heard_c, mask.to(cuda_device),
                     bits + id_bits, **kw)
    for a, b in zip(want, got):
        _same(a, b)


# maxpool.decode: (lanes, workers, elements, bits, output dtype, how the
# operands lie): the curves' and serving's shapes, an odd E, views one
# element past an aligned address, and 64 workers (four batches of rows)
_DECODE_CASES = {
    "curves-bits8": (4, 4, 4096, 8, torch.float32, "fresh"),
    "curves-bits16": (4, 4, 4096, 16, torch.float32, "fresh"),
    "serve-bf16": (1, 16, 8192, 8, torch.bfloat16, "fresh"),
    "odd-e": (3, 5, 4099, 8, torch.float16, "fresh"),
    "misaligned": (2, 4, 4096, 16, torch.bfloat16, "offset"),
    "n64": (2, 64, 776, 8, torch.float32, "fresh"),
}
_DECODE_OUTPUTS = [(w, m, a, c) for w in (False, True) for m in (False, True)
                   for a in (False, True) for c in ((False, True) if w
                                                    else (False,))]


def _offset(t: torch.Tensor) -> torch.Tensor:
    """The same values in a contiguous view one element past an aligned
    address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _decode_source(lanes, n, e, bits, dtype, gen, src):
    """The pooling epilogue's input: codes with the lowest code (-inf) on
    every 11th element, or the float features themselves (with zeros of
    both signs, infinities and, on every 11th element, a float whose code
    is the lowest)."""
    h = (torch.randn((lanes, n, e), generator=gen) * 3).to(dtype)
    if src == "codes":
        codes = QR.encode(h, bits)
        codes.view(-1)[::11] = 0                # the lowest code -> -inf
        return codes
    h.view(-1)[::11] = -float("inf")
    h.view(-1)[1:4] = torch.tensor([0.0, -0.0, float("inf")], dtype=dtype)
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", _DECODE_OUTPUTS, ids=str)
@pytest.mark.parametrize("case", sorted(_DECODE_CASES))
@pytest.mark.parametrize("src", ["codes", "floats"])
def test_maxpool_decode_matches_plain(cuda_device, case, outputs, src):
    """The fused pooling epilogue against its plain version, bit for bit,
    from codes and from the float features (the codes formed in the
    kernel), per lane mask with dark workers (lane 0 all dark), for every
    subset of its outputs, with and without a winner."""
    lanes, n, e, bits, dtype, lay = _DECODE_CASES[case]
    with_winner, max_code, argmax, correct = outputs
    gen = torch.Generator().manual_seed(n + e)
    codes = _decode_source(lanes, n, e, bits, dtype, gen, src)
    mask = torch.rand((lanes, n), generator=gen) < 0.7
    mask[0] = False
    winner = torch.randint(0, n, (lanes, e), generator=gen,
                           dtype=torch.int32) if with_winner else None
    kw = dict(max_code=max_code, argmax=argmax, correct=correct)
    want = MPR.maxpool_decode(codes, bits, dtype, mask=mask, winner=winner,
                              **kw)
    dev = [t if t is None else t.to(cuda_device)
           for t in (codes, mask, winner)]
    if lay == "offset":
        dev = [t if t is None else _offset(t) for t in dev]
        assert dev[0].data_ptr() % 8 != 0
    got = MPO.maxpool_decode(dev[0], bits, dtype, mask=dev[1],
                             winner=dev[2], **kw)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)
    # the main paths' mask: one (N,) row expanded over the lanes
    all_on = torch.ones(n, dtype=torch.bool, device=cuda_device)
    got = MPO.maxpool_decode(dev[0], bits, dtype,
                             mask=all_on.expand(lanes, n), winner=dev[2],
                             **kw)
    want = MPR.maxpool_decode(codes, bits, dtype, winner=winner, **kw)
    for a, b in zip(want, got):
        if a is not None:
            _same(a, b)


@pytest.mark.cuda
def test_maxpool_decode_writes_into_out(cuda_device):
    """``out=``: the ideal lane's pooled value and winner land in the last
    row of the stack's buffers, the other rows untouched."""
    gen = torch.Generator().manual_seed(5)
    h = torch.randn((1, 4, 4096), generator=gen).to(cuda_device)
    pooled = torch.full((5, 4096), 7.0, device=cuda_device)
    winner = torch.full((5, 4096), -1, dtype=torch.int32,
                        device=cuda_device)
    got = MPO.maxpool_decode(h, 8, torch.float32, argmax=True,
                             out=MPR.PoolDecode(pooled[4:], None,
                                                winner[4:], None))
    want = MPR.maxpool_decode(h.cpu(), 8, torch.float32, argmax=True)
    assert got.pooled.data_ptr() == pooled[4:].data_ptr()
    _same(want.pooled, pooled[4:])
    _same(want.argmax, winner[4:])
    assert bool((pooled[:4] == 7.0).all()) and bool((winner[:4] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,e,dtype", [
    (5, 4, 4096, torch.float32),         # the curves' stack: 4 lanes + ideal
    (5, 4, 32768, torch.float32),        # the evaluation's stack
    (3, 9, 1001, torch.bfloat16), (2, 16, 700, torch.float16)])
def test_winner_bwd_stack_matches_plain(cuda_device, lanes, n, e, dtype):
    """The winner-routed backward over a whole lane stack in one launch:
    g at each lane's winner, g * 0 (a zero with g's sign) elsewhere."""
    gen = torch.Generator().manual_seed(lanes * e)
    winner = torch.randint(0, n, (lanes, e), generator=gen,
                           dtype=torch.int32)
    g = torch.randn((lanes, e), generator=gen).to(dtype)
    g.view(-1)[:2] = torch.tensor([0.0, -0.0], dtype=dtype)
    want = MPR.maxpool_winner_bwd(winner, g, n, 1)
    got = MPO.maxpool_winner_bwd(winner.to(cuda_device),
                                 g.to(cuda_device), n, 1)
    _same(want, got)


def _on_card(x: torch.Tensor, dev, offset: int) -> torch.Tensor:
    """``x`` on the card, ``offset`` elements past an allocation's start
    (1: a misaligned base, the kernels' scalar path)."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
    out = buf[offset:].view(x.shape)
    out.copy_(x.to(dev))
    return out


def _same_nan_as_nan(a: torch.Tensor, b: torch.Tensor) -> None:
    """Bitwise where not NaN, NaN at the same places: the CPU and the card
    give ``inf * 0`` NaNs of other payloads."""
    a, b = a.cpu(), b.cpu()
    na, nb = torch.isnan(a), torch.isnan(b)
    assert torch.equal(na, nb)
    _same(torch.where(na, torch.zeros_like(a), a),
          torch.where(nb, torch.zeros_like(b), b))


# maxpool.fwd's optional outputs and maxpool.ties_bwd: (workers, columns,
# dtype, offset) -- 16-worker bf16 as at the LM site, a ragged width, a
# misaligned base, more than 16 workers (two and three mask words), codes
_TIES_CASES = [(16, 2048, "bfloat16", 0), (16, 1003, "bfloat16", 0),
               (16, 1000, "bfloat16", 1), (17, 512, "float32", 0),
               (33, 96, "float16", 1), (3, 64, "float32", 0),
               (16, 256, "uint8", 0), (5, 130, "uint16", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,dtype,offset", _TIES_CASES)
def test_maxpool_fwd_outputs_and_ties_bwd_match_plain(cuda_device, n, e,
                                                      dtype, offset):
    """``maxpool.fwd`` bitwise against its plain version for every subset
    of its optional outputs (winner, tie mask) on partials with forced
    ties, -0.0 beside +0.0 at a zero max, +-inf and a NaN row; then
    ``maxpool.ties_bwd`` from the kernel's mask against its plain version
    for a cotangent with +-0 and +-inf (NaN as NaN)."""
    gen = torch.Generator().manual_seed(n * e)
    h = torch.randint(-4, 3, (2, n, e), generator=gen) / 2.0
    h[:, :, 1::7] = -1.0
    h[:, n // 2, 1::7], h[:, n - 1, 1::7] = -0.0, 0.0
    h[:, 0, 2::11] = float("inf")
    h[1, n // 3, 4::64] = float("nan")
    if dtype in ("uint8", "uint16"):
        h = QR.encode(h, 8 if dtype == "uint8" else 12)
    else:
        h = h.to(_DT[dtype][0])
        # a negative NaN (sign bit set) alone in its 8-column group
        _as_ints(h)[0, n - 1, 41::64] = -1
    hc = _on_card(h, cuda_device, offset)
    for winner in (False, True):
        for ties in (False, True):
            got = MPO.maxpool_fwd(hc, 1, winner=winner, ties=ties)
            want = MPR.maxpool_fwd(h, 1, winner=winner, ties=ties)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    _same(b, a)
    if dtype in ("uint8", "uint16"):
        return
    mask = MPO.maxpool_ties(hc, 1)[1]
    g = torch.randn((2, e), generator=gen).to(h.dtype)
    g.view(-1)[:6] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                   1.0, -1.0])
    gc = _on_card(g, cuda_device, offset)
    got = MPO.maxpool_ties_bwd(mask, gc, n, 1)
    _same_nan_as_nan(MPR.ties_bwd(mask.cpu(), g, n, 1), got)
    _same_nan_as_nan(MPR.ties_bwd(mask, gc, n, 1), got)


# the max sites of the MoE, recurrent and encoder-decoder models over a (1
# x 2) mesh, a rank's 8 of 16 workers: (rows x width, dtype) of
# qwen3-moe's attention site in a step and a tick of 8, xlstm's mLSTM
# site in a step of 2 x 256 and a tick of 2, jamba's in a 64-token prefill
# and a tick of 2, whisper's mlp site in a step and in a prefill of 2 x
# 1,408 frames, pixtral's in a prefill of 2 x 1,024 patches; float32 at a
# one-row prefill of each logits reading
_TP_MODEL_SITES = [(8 * 256 * 2048, "bfloat16"), (8 * 2048, "bfloat16"),
                   (2 * 256 * 768, "bfloat16"), (2 * 768, "bfloat16"),
                   (64 * 8192, "bfloat16"), (2 * 8192, "bfloat16"),
                   (8 * 384 * 512, "bfloat16"), (2 * 1408 * 512, "bfloat16"),
                   (2 * 1024 * 5120, "bfloat16"), (256 * 2048, "float32"),
                   (1408 * 512, "float32"), (1024 * 5120, "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("e,dtype", _TP_MODEL_SITES)
def test_tp_model_sites_match_plain(cuda_device, e, dtype):
    """At each site a rank of the (1 x 2) mesh gives ``maxpool.fwd`` (8
    of 16 workers): every subset of its optional outputs bitwise its
    plain version on partials with forced ties, -0.0 beside +0.0 and a
    NaN; ``maxpool.ties_bwd`` from the kernel's mask bitwise its plain
    version (NaN as NaN)."""
    n = 8
    gen = torch.Generator().manual_seed(e)
    h = torch.randint(-4, 3, (n, e), generator=gen) / 2.0
    h[:, 1::7] = -1.0
    h[n // 2, 1::7], h[n - 1, 1::7] = -0.0, 0.0
    h[3, 4::64] = float("nan")
    h = h.to(_DT[dtype][0])
    hc = h.to(cuda_device)
    for winner in (False, True):
        for ties in (False, True):
            got = MPO.maxpool_fwd(hc, 0, winner=winner, ties=ties)
            want = MPR.maxpool_fwd(h, 0, winner=winner, ties=ties)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    _same(b, a)
    mask = MPO.maxpool_ties(hc, 0)[1]
    g = torch.randn((e,), generator=gen).to(h.dtype)
    got = MPO.maxpool_ties_bwd(mask, g.to(cuda_device), n, 0)
    _same_nan_as_nan(MPR.ties_bwd(mask.cpu(), g, n, 0), got)


# flash over a rank's half of the heads: (batch, heads, KV heads, S,
# causal, head dim) of qwen3-moe's step, jamba's prefill, whisper's
# encoder (a step, a serving prefill) and 4-token decoder prompt,
# pixtral's prefill
_TP_FLASH = [(8, 16, 2, 256, True, 128), (1, 32, 4, 64, True, 128),
             (8, 4, 4, 384, False, 64), (2, 4, 4, 1408, False, 64),
             (2, 4, 4, 4, True, 64), (2, 16, 4, 1024, True, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,causal,d", _TP_FLASH)
def test_flash_over_a_ranks_heads_matches_plain(cuda_device, b, h, hkv, s,
                                                causal, d):
    gen = torch.Generator().manual_seed(b * h + s)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               .to(cuda_device)
               for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    _assert_flash_close(FO.flash_attention(q, k, v, causal),
                        FR.flash_attention(q, k, v, causal))


# the fused kernel's cases: (lanes, workers, real workers, elements, the
# features' dtype (and p_keep's), bits, id sub-slots past the real ones,
# p_miss per lane, per worker, rounds)
_NOISY_CASES = {
    "curves-bits8": (4, 4, 4, 4096, torch.float32, 8, 0,
                     (0.0, 0.02, 0.05, 0.1), False, 3),
    "curves-bits16": (4, 4, 4, 4096, torch.float32, 16, 0,
                      (0.0, 0.02, 0.05, 0.1), False, 3),
    "serve-bf16": (1, 16, 16, 8192, torch.bfloat16, 8, 0, (0.05,), False, 3),
    "f16": (2, 8, 8, 1000, torch.float16, 8, 0, (0.1, 0.3), False, 3),
    "per-worker": (3, 9, 6, 700, torch.float32, 8, 0, (0.05, 0.2, 0.5),
                   True, 3),
    "padded-id": (2, 33, 20, 900, torch.bfloat16, 16, 3, (0.1, 0.4), False,
                  3),
    "n64": (2, 64, 64, 777, torch.float32, 8, 0, (0.02, 0.3), False, 3),
    "one-round": (3, 4, 4, 4096, torch.float32, 8, 0, (0.1, 0.3, 0.6),
                  False, 1),
    "64-rounds": (3, 4, 4, 4096, torch.float32, 8, 0, (0.1, 0.3, 0.6),
                  False, 64),
    "64-rounds-bf16": (2, 16, 12, 2048, torch.bfloat16, 8, 1, (0.2, 0.7),
                       True, 64),
}


def noisy_operands(dev, lanes, n, n_real, k, dtype, bits, id_pad, p_miss,
                   per_worker, rounds, seed=0):
    """Float features, mask, lane keys, p_keep, bits, id bits and the
    tournament's keywords of one case."""
    id_bits = ocs.host_id_bits(n_real)
    gen = torch.Generator().manual_seed(seed + n)
    h = (torch.randn((lanes, n, k), generator=gen) * 3).to(dtype)
    h[:, :, :16] = h[:, :1, :16]        # every worker ties on 16 columns
    mask = torch.arange(n) < n_real
    keys = jr.split(jr.PRNGKey(seed + bits), lanes)
    p = torch.tensor(p_miss)
    if per_worker:      # worker i misses a little more than worker i - 1
        p = p[:, None] + 0.01 * torch.arange(n)[None]
    p_keep = ocs.sensing_keep_prob(p, dtype, lanes=True)
    kw = dict(n_slots=bits + id_bits + id_pad, max_rounds=rounds)
    return [t.to(dev) for t in (h, mask, keys, p_keep)], bits, id_bits, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_NOISY_CASES))
def test_noisy_matches_plain(cuda_device, case):
    """The tournament over the float features (words formed and sensing
    bits hashed in the kernel) against the words, the packed draw, the
    tournament and the accounting on the CPU, bit for bit: winners,
    per-round counts and each lane's rounds, collisions and contention
    slots (the kernel's last-block reduction), at 1, 3 and 64 rounds."""
    ops_in, bits, id_bits, kw = noisy_operands(cuda_device,
                                               *_NOISY_CASES[case])
    h, mask, keys, p_keep = ops_in
    got = CO.noisy_contention(h, mask, bits, id_bits, keys, p_keep, **kw)
    want = CR.noisy_contention(h.cpu(), mask.cpu(), bits, id_bits,
                               keys.cpu(), p_keep.cpu(), **kw)
    for a, b in zip(want, got):
        _same(a, b)
    # and against the packed-plane kernel on the same words and draws
    heard = CR.draw_heard_packed(keys, p_keep, h.shape[1], h.shape[2], **kw)
    word = CR.contention_words(h, bits, id_bits)
    for a, b in zip(CO.contend(word, heard, mask, bits + id_bits, **kw),
                    got):
        _same(a, b)
    # the winner written into a slice of a larger buffer
    buf = torch.full((h.shape[0] + 1, h.shape[2]), -1, dtype=torch.int32,
                     device=cuda_device)
    CO.noisy_contention(h, mask, bits, id_bits, keys, p_keep, out=buf[:-1],
                        **kw)
    _same(want.winner, buf[:-1])
    assert bool((buf[-1] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_stack_pool_card_matches_cpu(cuda_device, bits):
    """The curves' lane stack (4 noisy lanes + the ideal lane) on the card
    against the CPU: pooled values, accounting and the gradient, bitwise,
    through ``Protocol.aggregate_with_ideal``."""
    from repro_torch.protocol import Protocol

    gen = torch.Generator().manual_seed(bits)
    h = torch.randn((5, 4, 64, 64), generator=gen)
    g = torch.randn((5, 64, 64), generator=gen)
    proto = Protocol.ocs(bits).with_p_miss(np.array([0.0, 0.02, 0.05, 0.1],
                                                    np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        x = h.to(dev).requires_grad_(True)
        pooled, acct = proto.aggregate_with_ideal(
            x, jr.split(jr.PRNGKey(bits), 4).to(dev))
        (grad,) = torch.autograd.grad(pooled, x, g.to(dev))
        outs.append((pooled.detach(), grad, acct.rounds, acct.collisions,
                     acct.contention_slots, acct.correct_frac))
    for a, b in zip(*outs):
        _same(a, b)


# flash attention: the prefill shapes (bf16, causal) up to long prompts,
# float16, head_dim 128, and the JAX parity test's float32 GQA cases at
# blocks of 64.  float32 within the JAX test's 3e-5; a 16-bit output within
# two ulps of its type at each query row's largest |plain| value (the kernel
# sums in another order than the whole-matrix softmax and rounds P to 16
# bits before PV, yet both round nearly the same float32 sum to 16 bits, so
# a sound kernel is off by at most one ulp there; an absolute limit would be
# as large as the outputs of a long non-causal row, |out| ~ 0.04 at 1,408
# keys, where a lost key tile would pass)
_FLASH_CASES = ([(16, 16, s, torch.bfloat16, True, 128, 64)
                 for s in (128, 512, 1024, 4096)]
                + [(16, 16, 256, torch.float16, True, 128, 64),
                   (8, 2, 384, torch.float16, False, 128, 64),
                   (4, 2, 256, torch.bfloat16, True, 128, 128),
                   (4, 4, 192, torch.bfloat16, True, 64, 32)]
                + [(4, hkv, 192, torch.float32, causal, 64, 64)
                   for hkv in (1, 2, 4) for causal in (True, False)])


def _assert_flash_close(got, want):
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        assert float((g - w).abs().max()) <= 3e-5
        return
    rel = ((g - w).abs().amax(-1) / w.abs().amax(-1)).max()
    assert float(rel) <= 2 * torch.finfo(got.dtype).eps, float(rel)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,s,dtype,causal,block,d", _FLASH_CASES)
def test_flash_matches_plain(cuda_device, h, hkv, s, dtype, causal, block,
                             d):
    gen = torch.Generator().manual_seed(s + hkv)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(cuda_device)
               for shape in ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d)))
    got = FO.flash_attention(q, k, v, causal, block, block)
    want = FR.flash_attention(q, k, v, causal)
    assert got.dtype == dtype
    _assert_flash_close(got, want)


@pytest.mark.cuda
def test_reduced_serving_card_matches_cpu(cuda_device):
    """The reduced qwen config in float32 with the flash prefill: prefill
    logits within 1e-4 of the CPU's (float order), and a channel-free run
    serves the same tokens."""
    cfg = get_reduced("qwen1.5-0.5b", use_flash=True)
    m = TM.build(cfg)
    values = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 64)).astype(np.int32))
    cpu_logits, _ = m.prefill(values, {"tokens": toks}, max_seq=96)
    gpu_values = tree.map(lambda t: t.to(cuda_device), values)
    gpu_logits, _ = m.prefill(gpu_values, {"tokens": toks.to(cuda_device)},
                              max_seq=96)
    assert float((gpu_logits.cpu() - cpu_logits).abs().max()) <= 1e-4
    reqs = [Request(rid=i, prompt=np.random.default_rng(i).integers(
        0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=6,
        arrival_tick=i) for i in range(4)]
    config = ServeConfig(batch_slots=2, max_seq=96, eos_id=-1)
    want = ServeEngine(m, values, config, device="cpu").run(reqs)
    got = ServeEngine(m, values, config, device=cuda_device).run(reqs)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens


# ---------------------------------------------------------------------------
# the fault paths' operands: a dark lane, per-lane per-worker p_keep
# ---------------------------------------------------------------------------

def dark_lane_operands(dev, lanes, n, k, dtype, bits, seed=0):
    """Float features, a per-lane ``online (L, N)`` mask whose lane 0 is
    all dark (lane 1 keeps one worker), lane keys and a per-lane,
    per-worker ``p_keep (L, N, 1)``: the fault engine's operands."""
    gen = torch.Generator().manual_seed(seed + n + bits)
    h = (torch.randn((lanes, n, k), generator=gen) * 3).to(dtype)
    h[:, :, :16] = h[:, :1, :16]
    online = torch.rand((lanes, n), generator=gen) < 0.6
    online[0] = False
    if lanes > 1:
        online[1] = False
        online[1, n - 1] = True
    p = torch.rand((lanes, n), generator=gen) * 0.6
    p_keep = ocs.sensing_keep_prob(p, dtype, lanes=True)
    keys = jr.split(jr.PRNGKey(seed + bits), lanes)
    return [t.to(dev) for t in (h, online, keys, p_keep)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,k,dtype,bits", [
    (4, 4, 4096, torch.float32, 8), (4, 4, 4096, torch.float32, 16),
    (4, 4, 32768, torch.float32, 8), (1, 16, 8192, torch.bfloat16, 8),
    (3, 16, 8192, torch.bfloat16, 8)])
def test_noisy_dark_lane_matches_plain(cuda_device, lanes, n, k, dtype,
                                       bits):
    """``ocs_contention.noisy`` under a per-lane mask with a dark lane and
    a per-lane, per-worker ``p_keep``, at the fault curves' and the faulty
    serve tick's shapes: winners, per-round counts and accounting bit for
    bit against the plain version."""
    h, online, keys, p_keep = dark_lane_operands(cuda_device, lanes, n, k,
                                                 dtype, bits)
    id_bits = ocs.host_id_bits(n)
    kw = dict(n_slots=bits + id_bits, max_rounds=3)
    got = CO.noisy_contention(h, online, bits, id_bits, keys, p_keep, **kw)
    want = CR.noisy_contention(h.cpu(), online.cpu(), bits, id_bits,
                               keys.cpu(), p_keep.cpu(), **kw)
    for a, b in zip(want, got):
        _same(a, b)
    # a dark lane has no contender: winner 0 and nothing collides
    assert not bool(got.winner[0].any())
    assert int(got.collisions[0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["zero_fill", "stale", "retry"])
def test_fault_pool_outage_lane_card_matches_cpu(cuda_device, policy):
    """The fault curves' pool (4 fault lanes, lane 0 in total outage, +
    the ideal lane) on the card against the CPU: pooled value, new state,
    accounting and the gradients of h and of the stale cache, bit for bit;
    nothing NaN, and no gradient reaches h on the outage lane."""
    from repro_torch import faults
    from repro_torch.protocol import Protocol

    lanes, n, b, k = 4, 4, 64, 64
    gen = torch.Generator().manual_seed(3)
    h = torch.randn((lanes + 1, n, b, k), generator=gen) * 2
    h[:, :, 0, :8] = -float("inf")          # columns that decode to -inf
    stale = torch.randn((lanes, b, k), generator=gen)
    g1 = torch.randn((lanes + 1, b, k), generator=gen)
    g2 = torch.randn((lanes, b, k), generator=gen)
    pol = {"zero_fill": faults.DegradePolicy.zero_fill(),
           "stale": faults.DegradePolicy.stale(),
           "retry": faults.DegradePolicy.retry(2)}[policy]
    models = [faults.FaultModel.iid(0.0, policy=pol).with_dropout(1.0, 0.0)]
    models += [faults.FaultModel.burst(burst_len=2.0 + i, gap_len=3.0,
                                       p_miss_bad=0.5, p_miss_good=0.05,
                                       policy=pol).with_dropout(0.3, 0.4)
               for i in range(lanes - 1)]
    outs = []
    for dev in ("cpu", cuda_device):
        fm = faults.stack_models(models, n, dev)
        st = faults.init_state(n, (b, k), device=dev).map(
            lambda t: t[None].expand((lanes,) + t.shape).clone())
        st = faults.FaultState(bad=st.bad, offline=st.offline,
                               stale=stale.to(dev).requires_grad_(True),
                               age=st.age, consec=st.consec)
        x = h.to(dev).requires_grad_(True)
        pooled, ns, acct = faults.aggregate_with_ideal(
            Protocol.ocs(8), fm, st, x, jr.split(jr.PRNGKey(5), lanes).to(
                dev))
        gh, gs = torch.autograd.grad([pooled, ns.stale], [x, st.stale],
                                     [g1.to(dev), g2.to(dev)])
        outs.append([pooled.detach(), ns.stale.detach(), ns.bad, ns.offline,
                     ns.age, ns.consec, gh, gs] + [
            getattr(acct, f) for f in ("rounds", "collisions",
                                       "contention_slots", "correct_frac",
                                       "dropped_frames", "outage",
                                       "retry_slots")])
    for a, b_ in zip(*outs):
        _same(a, b_)
    pooled, gh = outs[1][0], outs[1][6]
    assert int(outs[1][-2][0]) == 1                  # lane 0 is an outage
    assert not bool(torch.isnan(pooled[:lanes]).any())
    assert not bool(torch.isnan(gh).any())
    assert not bool(gh[0].any())


@pytest.mark.cuda
def test_scheduled_and_fault_lanes_train_run_curves_lanes_on_card(
        cuda_device):
    """On the card, as on the CPU: FixedBits(8) and a grid of iid fault
    lanes train the noisy lanes of run_curves(bits=(8,)) bit for bit."""
    from repro_torch.faults import FaultModel
    from repro_torch.protocol import FixedBits
    from repro_torch.sim import train_curves as tc

    cfg = tc.CurveConfig(bits=(8,), p_miss=(0.0, 0.3), steps=8, batch=16,
                         n_train=128, n_val=64, hw=8, encoder_dims=(8,),
                         embed_dim=8, head_dims=(8,), log_every=4)
    plain = tc.run_curves(cfg, device=cuda_device)
    sched = tc.run_scheduled_curves(cfg, FixedBits(8), device=cuda_device)
    fault = tc.run_fault_curves(cfg, [FaultModel.iid(p) for p in cfg.p_miss],
                                device=cuda_device)
    assert np.array_equal(sched.loss_history, plain.loss_history[0])
    assert np.array_equal(sched.acc, plain.acc[0])
    assert np.array_equal(fault.loss_history, plain.loss_history)
    assert np.array_equal(fault.acc, plain.acc)
    for params in (sched.params, fault.params[0]):
        for a, b in zip(tree.leaves(params),
                        tree.leaves(plain.noisy_params[0])):
            _same(a, b)


@pytest.mark.cuda
def test_faulty_serving_on_card(cuda_device):
    """The reduced qwen config served on the card under bursts and
    outages: every request finishes, outage ticks degrade tokens (stale)
    or hold the batch (retry), and the billing adds up."""
    from repro_torch.faults import DegradePolicy, FaultModel
    from repro_torch.protocol import Protocol

    cfg = get_reduced("qwen1.5-0.5b")
    m = TM.build(cfg)
    values = m.init(torch.Generator().manual_seed(0))
    reqs = [Request(rid=i, prompt=np.random.default_rng(i).integers(
        0, cfg.vocab_size, 32).astype(np.int32), max_new_tokens=8,
        arrival_tick=i) for i in range(4)]
    proto = Protocol.ocs(bits=8, p_miss=np.full((cfg.n_workers,), 0.05,
                                                np.float32))
    seen = {}
    for pol in (DegradePolicy.stale(), DegradePolicy.retry(2)):
        fm = FaultModel.burst(burst_len=4, gap_len=16, p_miss_bad=0.5,
                              p_miss_good=0.01, policy=pol).with_dropout(
                                  0.9, 0.1)
        eng = ServeEngine(m, values, ServeConfig(
            batch_slots=2, max_seq=64, eos_id=-1, protocol=proto, fault=fm),
            device=cuda_device)
        outs = eng.run(reqs)
        assert sorted(outs) == list(range(4))
        for c in outs.values():
            assert len(c.tokens) == 8 and c.channel_slots > 0
        seen[pol.kind] = (sum(c.degraded_tokens for c in outs.values()),
                          sum(c.retry_ticks for c in outs.values()))
    assert seen["stale"][0] > 0 and seen["retry"][1] > 0, seen


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits", [(33, 16), (48, 8), (64, 16), (64, 8)])
def test_noisy_wide_padded_lanes_match_plain(cuda_device, n, bits):
    """``ocs_contention.noisy`` at the sweep's operands, 33-64 workers
    (two per lane of a warp): a per-lane mask whose real worker counts
    differ from lane to lane, padded rows past them, one lane all real,
    per-worker ``p_keep`` and the scan of the widest lane's id bits, bit
    for bit against the plain version."""
    lanes, k = 6, 777
    gen = torch.Generator().manual_seed(n + bits)
    h = torch.randn((lanes, n, k), generator=gen) * 3
    h[:, :, :16] = h[:, :1, :16]
    reals = torch.tensor([1, 2, 5, 17, n - 1, n])
    mask = torch.arange(n)[None] < reals[:, None]
    h[~mask] = 1e9                        # padded rows would win anything
    p = torch.rand((lanes, n), generator=gen) * 0.3
    p_keep = ocs.sensing_keep_prob(p, torch.float32, lanes=True)
    keys = jr.split(jr.PRNGKey(n), lanes)
    id_bits = ocs.host_id_bits(17)        # one sub-group's id bits
    kw = dict(n_slots=bits + ocs.host_id_bits(n), max_rounds=3)
    got = CO.noisy_contention(*(t.to(cuda_device) for t in (h, mask)), bits,
                              id_bits, keys.to(cuda_device),
                              p_keep.to(cuda_device), **kw)
    want = CR.noisy_contention(h, mask, bits, id_bits, keys, p_keep, **kw)
    for a, b in zip(want, got):
        _same(a, b)
    assert bool((got.winner.cpu() < reals[:, None]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k_frac", [1 / 64, 1 / 8, 1.0])
def test_batched_topk_card_matches_cpu(cuda_device, k_frac):
    """The DP curves' top-k over a (lane, rank) stack on the card: the
    masks (ties to the lowest flat index), the sparse values, the error
    memory and the kept counts equal the CPU's, bit for bit; and the
    compressed reduce over the rank axis as well."""
    from repro_torch.optim import compressed_allreduce as CA
    from repro_torch.optim import grad_compression as GC

    gen = torch.Generator().manual_seed(int(1 / k_frac))
    g = torch.randint(-3, 4, (3, 2, 4099), generator=gen).float()
    g[0, 0] = 0.0                                   # one tensor all tied
    err = torch.randn((3, 2, 4099), generator=gen) * 0.01
    err[:, :, ::2] = 0.0
    want = GC.compress_counted(g, err, k_frac, batch_dims=2)
    got = GC.compress_counted(g.to(cuda_device), err.to(cuda_device),
                              k_frac, batch_dims=2)
    for a, b in zip(want, got):
        _same(a, b)
    _same(GC.topk_mask(g, k_frac, 2),
          GC.topk_mask(g.to(cuda_device), k_frac, 2))
    car = CA.CompressedAllReduce.topk(k_frac)
    tree_ = {"w": g.reshape(3, 2, 4099), "b": g[..., :7]}
    errs = {"w": err, "b": err[..., :7]}
    outs = [car.reduce(tree.map(lambda t: t.to(dev), tree_),
                       tree.map(lambda t: t.to(dev), errs), rank_dim=1)
            for dev in ("cpu", cuda_device)]
    for a, b in zip(tree.leaves(outs[0][:2]), tree.leaves(outs[1][:2])):
        _same(a, b)
    for f in ("payload_bits", "kept_elems", "dense_bits"):
        _same(getattr(outs[0][2], f), getattr(outs[1][2], f))


@pytest.mark.cuda
def test_sweep_subgroups_on_card_match_plain_per_lane(cuda_device):
    """The sweep's noisy engine on the card launches once per (bits,
    id_bits) sub-group; lanes are independent, so every (scenario, round)
    lane equals one plain call of the noisy core on that lane alone (its
    id bits, the bits group's scan bound, the grid's padded N), and the
    whole sweep, clean engine included, equals the CPU's."""
    from repro_torch import kernels
    from repro_torch.sim import scenarios as SC
    from repro_torch.sim import sweep as SW

    cells = [SC.Scenario("t/a", n_workers=3, bits=8, p_miss=0.2),
             SC.Scenario("t/b", n_workers=40, bits=8,
                         p_miss=SC.near_far_p_miss(40, 0.0, 0.3)),
             SC.Scenario("t/c", n_workers=9, bits=8, p_miss=0.05,
                         n_channels=4),
             SC.Scenario("t/d", n_workers=64, bits=16, p_miss=0.1)]
    kw = dict(k_elems=48, rounds=2, seed=4, rng_seed=6)
    kernels.reset_launch_counts()
    got = SW.run_sweep(cells, device=cuda_device, **kw)
    counts = kernels.launch_counts()
    # id_bits 2, 6 and 4 at bits 8, 6 at bits 16; one encode per bits
    assert counts["ocs_contention.noisy"] == 4, counts
    assert counts["maxpool.decode"] == 4, counts
    assert counts["ocs_quant.encode"] == 2, counts
    want = SW.run_sweep(cells, device="cpu", **kw)
    for eng in ("clean", "noisy"):
        for f in getattr(want, eng).__dataclass_fields__:
            a, b = getattr(getattr(want, eng), f), getattr(getattr(got, eng),
                                                          f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (eng, f)
        assert np.array_equal(getattr(want, eng + "_latency_slots"),
                              getattr(got, eng + "_latency_slots"))
    keys = jr.split(jr.PRNGKey(kw["rng_seed"]), len(cells) * 2).reshape(
        len(cells), 2, 2)
    for i, s in enumerate(cells):
        max_id = max(ocs.host_id_bits(c.n_workers) for c in cells
                     if c.bits == s.bits)
        p = torch.zeros((1, got.n_max))
        p[0, :s.n_workers] = torch.tensor(s.p_miss_per_worker())
        for r in range(2):
            one = ocs.ocs_maxpool_noisy_core(
                torch.from_numpy(got.h[i, r])[None],
                torch.from_numpy(got.mask[i])[None],
                ocs.host_id_bits(s.n_workers), keys[i, r][None], p,
                bits=s.bits, max_id_bits=max_id)
            cell = got.noisy_cell(i, r)
            for f in one.__dataclass_fields__:
                assert np.array_equal(getattr(one, f)[0].numpy(),
                                      getattr(cell, f)), (s.name, r, f)


@pytest.mark.cuda
def test_dp_curves_card_accounting_matches_cpu(cuda_device):
    """``run_curves_dp`` on the card: the measured payload equals the
    analytic bill and the CPU's, every step; losses within phase 6's
    1e-3 of the CPU's (float order can move an embedding across a D-bit
    bucket edge)."""
    from repro_torch.optim.compressed_allreduce import CompressedAllReduce
    from repro_torch.sim import train_curves as tc

    cfg = tc.CurveConfig(bits=(8, 16), p_miss=(0.0, (0.0, 0.1, 0.1, 0.3)),
                         steps=6, batch=16, n_train=128, n_val=64, hw=8,
                         encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                         log_every=3, dp_shards=4)
    car = CompressedAllReduce.topk(1 / 8)
    got = tc.run_curves_dp(cfg, car, device=cuda_device)
    want = tc.run_curves_dp(cfg, car, device="cpu")
    assert np.all(got.dp_payload_bits == got.dp_payload_bits_step)
    for f in ("dp_payload_bits", "dp_payload_bits_total",
              "dp_payload_bits_step", "dp_dense_bits_step"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.max(np.abs(got.loss_history - want.loss_history)) < 1e-3


def _same_result(a, b, what="") -> None:
    """Two results of one engine, every field bitwise."""
    import dataclasses
    if dataclasses.is_dataclass(b) and not isinstance(b, type):
        for f in dataclasses.fields(b):
            _same_result(getattr(a, f.name), getattr(b, f.name),
                         f"{what}.{f.name}")
    elif isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same_result(a[k], b[k], f"{what}[{k}]")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _same_result(x, y, what)
    elif isinstance(b, torch.Tensor):
        _same(a, b)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


@pytest.mark.cuda
def test_global_norm_of_a_lane_is_its_own_run_on_card(cuda_device):
    """A lane's global norm on the card is bitwise the same in a stack of
    5 lanes, of 3 and run alone (the fedocs-cifar encoder's largest leaf
    and a bias): a rank's block of lanes clips as the whole stack does."""
    from repro_torch.optim.optimizers import global_norm

    gen = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn((5, 4, 256, 256), generator=gen),
             "b": torch.randn((5, 4, 256), generator=gen)}
    grads = tree.map(lambda x: x.to(cuda_device), grads)
    five = global_norm(grads, 1)
    three = global_norm(tree.map(lambda x: x[[0, 1, 4]], grads), 1)
    assert torch.equal(five[[0, 1, 4]], three)
    for i in range(5):
        one = global_norm(tree.map(lambda x, i=i: x[i], grads))
        assert torch.equal(five[i], one), i


@pytest.mark.cuda
def test_engines_on_one_nccl_rank_bitwise(cuda_device, tmp_path):
    """``n_devices`` over a one-rank NCCL group (``None`` and ``1``):
    ``run_curves``, ``run_sweep`` and ``run_curves_dp`` bitwise their runs
    without a group, every field."""
    import datetime

    import torch.distributed as dist

    from repro_torch.optim.compressed_allreduce import CompressedAllReduce
    from repro_torch.sim import scenarios, sweep
    from repro_torch.sim import train_curves as tc

    cfg = tc.CurveConfig(bits=(8, 16), p_miss=(0.0, 0.3, 0.05), steps=6,
                         batch=16, n_train=128, n_val=64, hw=8,
                         encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                         log_every=3, dp_shards=2)
    car = CompressedAllReduce.topk(1 / 8)
    cells = scenarios.scenario_grid(n_workers=(4, 16), bits=(8, 16),
                                    p_miss=(0.0, 0.1))
    runs = {
        "curves": lambda n: tc.run_curves(cfg, device=cuda_device,
                                          n_devices=n),
        "dp": lambda n: tc.run_curves_dp(cfg, car, device=cuda_device,
                                         n_devices=n),
        "sweep": lambda n: sweep.run_sweep(cells, k_elems=16, rounds=2,
                                           device=cuda_device, n_devices=n)}
    plain = {k: fn(None) for k, fn in runs.items()}
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        for n in (None, 1):
            for k, fn in runs.items():
                _same_result(fn(n), plain[k], f"{k} n_devices={n}")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_lm_on_a_one_nccl_rank_mesh_bitwise(cuda_device, tmp_path):
    """A (1 x 1) mesh over a one-rank NCCL group: the reduced qwen config
    in bf16 with flash and the max fusion, the loss and every gradient,
    a prefill and 4 decode ticks under OCS, and 3 trainer steps (its
    shardings given) bitwise the run without a mesh."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.protocol import Protocol
    from repro_torch.train import trainer
    from repro_torch.train.train_step import value_and_grad

    def runs(mesh):
        run, launch_train = _train_setup(cuda_device, steps=3)
        m, values = run.m, run.values
        shd = None if mesh is None else sh.tree_shardings_for_values(
            m.axes(), values, mesh)
        batch = run.data(0)
        out = {"grad": value_and_grad(m.loss, values, batch)}
        tokens = batch["tokens"][:2, :8]
        logits, cache = m.prefill(values, {"tokens": tokens}, max_seq=16)
        proto = Protocol.ocs(bits=8, p_miss=np.full(
            (m.cfg.n_workers,), 0.05, np.float32))
        tok = logits.argmax(-1)[:, None].int()
        pos = torch.full((2,), 8, dtype=torch.int32, device=cuda_device)
        seq = [logits]
        for t in range(4):
            logits, cache, _ = m.decode_step_channel(
                values, tok, pos + t, cache, proto,
                jr.PRNGKey(t, cuda_device))
            tok = logits.argmax(-1)[:, None].int()
            seq.append(logits)
        out["decode"] = seq
        res = trainer.train(m.loss, values, run.opt, run.data, run.tcfg,
                            shardings=shd)
        out["train"] = (res.values, res.opt_state,
                        [r["loss"] for r in res.history])
        return out

    plain = runs(None)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = lmesh.make_mesh(1, 1)
        with sh.use_mesh(mesh):
            meshed = runs(mesh)
    finally:
        dist.destroy_process_group()
    _same(meshed["grad"][0], plain["grad"][0])
    _same_tree(meshed["grad"][2], plain["grad"][2])
    _same_tree(meshed["decode"], plain["decode"])
    _same_tree(meshed["train"][:2], plain["train"][:2])
    assert meshed["train"][2] == plain["train"][2]


# ---------------------------------------------------------------------------
# the trainer, checkpoints and sampling
# ---------------------------------------------------------------------------

def _train_setup(dev, ckpt_dir=None, steps=6, ckpt_every=3):
    """The reduced qwen config in bf16 with the flash kernel and the max
    fusion (``maxpool.fwd`` and ``maxpool.ties_bwd``), through
    ``launch/train``'s code path."""
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", str(dev),
            "--steps", str(steps), "--batch", "4", "--seq", "32"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", ckpt_dir]
    run = launch_train.setup(launch_train.parse_args(argv))
    run.m = TM.build(run.cfg.with_(dtype=torch.bfloat16,
                                   param_dtype=torch.bfloat16))
    run.values = tree.map(lambda t: t.to(torch.bfloat16), run.values)
    run.tcfg.ckpt_every, run.tcfg.log_every = ckpt_every, 1
    return run, launch_train


def _same_tree(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        _same(x, y)


@pytest.mark.cuda
def test_trainer_resume_bitwise_on_card(cuda_device, tmp_path):
    """Two uninterrupted runs on the card agree bit for bit (deterministic
    backward passes), and a run preempted after its step-3 checkpoint and
    relaunched equals them from step 3 on."""
    from repro_torch import kernels

    runs = []
    for _ in range(2):
        run, lt = _train_setup(cuda_device)
        kernels.reset_launch_counts()
        runs.append(lt.launch(run))
        counts = kernels.launch_counts()
        assert counts["maxpool.fwd"] == 2 * 2 * 6, counts
        assert counts["maxpool.ties_bwd"] == 2 * 2 * 6, counts
        assert counts["flash_attention.fwd"] == 2 * 6, counts
    _same_tree(runs[0].values, runs[1].values)
    _same_tree(runs[0].opt_state, runs[1].opt_state)
    d = str(tmp_path)
    run, lt = _train_setup(cuda_device, d, steps=3)
    lt.launch(run)
    run, lt = _train_setup(cuda_device, d)
    resumed = lt.launch(run)
    assert resumed.history[0]["step"] == 3
    _same_tree(resumed.values, runs[0].values)
    _same_tree(resumed.opt_state, runs[0].opt_state)
    strip = [{k: v for k, v in r.items() if k != "step_time_s"}
             for r in runs[0].history[3:]]
    assert [{k: v for k, v in r.items() if k != "step_time_s"}
            for r in resumed.history] == strip


@pytest.mark.cuda
def test_checkpoint_roundtrip_cuda_tensors(cuda_device, tmp_path):
    """CUDA leaves of every stored type (bf16 as raw words, a FaultState)
    come back bitwise, on the template's device or on ``device``."""
    from repro_torch import faults
    from repro_torch.checkpoint import checkpointer as ck

    gen = torch.Generator().manual_seed(4)
    t = {"w": torch.randn((5, 7), generator=gen).to(torch.bfloat16),
         "m": [torch.randn((3,), generator=gen),
               torch.tensor(3, dtype=torch.int32)],
         "aux": faults.init_state(4, (2, 3))}
    t["aux"] = t["aux"].map(lambda x: x.to(cuda_device))
    t = {"w": t["w"].to(cuda_device),
         "m": [x.to(cuda_device) for x in t["m"]], "aux": t["aux"]}
    ck.save(str(tmp_path), 1, t)
    got, _, _ = ck.restore(str(tmp_path), template=t)
    assert got["w"].device.type == cuda_device.type
    _same(got["w"], t["w"])
    for x, y in zip(got["m"], t["m"]):
        _same(x, y)
    for f in ("bad", "offline", "stale", "age", "consec"):
        _same(getattr(got["aux"], f), getattr(t["aux"], f))
    on_cpu, _, _ = ck.restore(str(tmp_path), template=t, device="cpu")
    assert on_cpu["w"].device.type == "cpu"
    _same(on_cpu["w"], t["w"])


@pytest.mark.cuda
def test_sampling_card_matches_cpu(cuda_device):
    """``random.categorical`` and a channel-free ``greedy=False`` serving
    run of the reduced config on the card: the same samples as the CPU
    (the Gumbel draws within two ulps of their logs, the logits within
    float order; a flip on a near-tie would show here)."""
    from repro_torch import random as jr

    logits = torch.randn((16, 300), generator=torch.Generator().manual_seed(1))
    for seed in range(5):
        want = jr.categorical(jr.PRNGKey(seed), logits)
        got = jr.categorical(jr.PRNGKey(seed, cuda_device),
                             logits.to(cuda_device))
        assert torch.equal(got.cpu(), want)
    cfg = get_reduced("qwen1.5-0.5b", use_flash=True)
    m = TM.build(cfg)
    values = m.init(torch.Generator().manual_seed(0))
    reqs = [Request(rid=i, prompt=np.random.default_rng(i).integers(
        0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=6,
        arrival_tick=i) for i in range(4)]
    config = ServeConfig(batch_slots=2, max_seq=96, eos_id=-1, greedy=False,
                         seed=3)
    want = ServeEngine(m, values, config, device="cpu").run(reqs)
    got = ServeEngine(m, values, config, device=cuda_device).run(reqs)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["sort_scatter", "gather"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_moe_card_matches_cpu_and_repeats(cuda_device, arch, impl):
    """The MoE FFN (capacity drops; llama4's shared expert through the
    max law's kernels) on the card: the output, aux and every gradient of
    ``sum(y**2) + 0.01 * aux`` within 1e-4 of the CPU's (float order),
    and two card runs bit for bit (no atomics in the dispatch, the
    combine or their backward passes)."""
    from repro_torch.models import moe

    cfg = get_reduced(arch, moe_impl=impl, capacity_factor=0.5,
                      tp_fusion="max")
    params = moe.moe_init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def run(dev):
        leaves = [t.to(dev).requires_grad_(True) for t in tree.leaves(params)]
        xt = x.to(dev).requires_grad_(True)
        y, aux = moe.moe_apply(cfg, tree.unflatten(params, leaves), xt)
        grads = torch.autograd.grad(torch.sum(y ** 2) + 0.01 * aux,
                                    [xt] + leaves)
        return [t.detach().cpu() for t in (y, aux) + grads]

    want = run("cpu")
    first, second = run(cuda_device), run(cuda_device)
    for a, b, w in zip(first, second, want):
        _same(a, b)
        scale = max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_moe_train_and_serve_on_card(cuda_device):
    """The reduced qwen3-moe config: 3 launcher steps twice on the card,
    bit for bit; losses within 1e-4 of the CPU's; greedy serving tokens
    equal to the CPU's, 0 channel slots and 0 uplink bits under OCS."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train as lt
    from repro_torch.protocol import Protocol

    def train(dev):
        # one init (the CPU generator's draws) for both devices
        run = lt.setup(lt.parse_args([
            "--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "32"]))
        run.values = tree.map(lambda t: t.to(dev), run.values)
        pcfg = pipeline.for_model(run.cfg, batch=4, seq_len=32, seed=0)
        run.data = lambda s: pipeline.batch_for_step(pcfg, s, device=dev)
        return lt.launch(run)

    a, b, c = train(cuda_device), train(cuda_device), train("cpu")
    _same_tree(a.values, b.values)
    _same_tree(a.opt_state, b.opt_state)
    for ra, rc in zip(a.history, c.history):
        assert abs(ra["loss"] - rc["loss"]) <= 1e-4 * abs(rc["loss"])
    cfg = get_reduced("qwen3-moe-30b-a3b", use_flash=True)
    m = TM.build(cfg)
    cpu_values = m.init(torch.Generator().manual_seed(0))
    gpu_values = tree.map(lambda t: t.to(cuda_device), cpu_values)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 32).astype(
        np.int32), max_new_tokens=8) for i in range(4)]
    proto = Protocol.ocs(bits=8, p_miss=np.full((cfg.n_workers,), 0.05,
                                                np.float32))
    config = ServeConfig(batch_slots=2, max_seq=48, eos_id=-1,
                         protocol=proto)
    want = ServeEngine(m, cpu_values, config, device="cpu").run(reqs)
    got = ServeEngine(m, gpu_values, config, device=cuda_device).run(reqs)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].channel_slots == got[rid].uplink_bits == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_quantize_st_kernel_matches_plain(cuda_device, dtype, bits):
    """``quantize_st`` on the card (the encode and decode kernels) bitwise
    against its plain version on the CPU, forward and straight-through
    gradient."""
    tdt = _DT[dtype][0]
    gen = torch.Generator().manual_seed(bits)
    x = (torch.randn((64, 1031), generator=gen) * 10).to(tdt)
    g = torch.randn((64, 1031), generator=gen).to(tdt)
    outs = []
    for dev in ("cpu", cuda_device):
        xt = x.to(dev, copy=True).requires_grad_(True)
        y = QO.quantize_st(xt, bits)
        (y * g.to(dev)).sum().backward()
        outs.append((y.detach().cpu(), xt.grad.cpu()))
    _same(outs[0][0], outs[1][0])
    _same(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 2 * 256, 768), (16, 64, 8192)],
                         ids=["mlstm site", "mamba site"])
def test_maxpool_fwd_at_the_recurrent_sites(cuda_device, shape):
    """``maxpool.fwd`` bitwise against its plain version at the new site
    widths: xlstm-125m's mLSTM down-projection (16 workers, B x 256
    tokens, d_model 768) and jamba's mamba out-projection at one 64-token
    prefill (d_model 8192), bf16, every subset of its outputs."""
    gen = torch.Generator().manual_seed(shape[-1])
    h = torch.randn(shape, generator=gen).to(torch.bfloat16)
    hc = h.to(cuda_device)
    for winner in (False, True):
        for ties in (False, True):
            got = MPO.maxpool_fwd(hc, 1, winner=winner, ties=ties)
            want = MPR.maxpool_fwd(h, 1, winner=winner, ties=ties)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    _same(b, a)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_recurrent_plans_card_match_cpu(cuda_device, arch):
    """The reduced xlstm and jamba configs (``tp_fusion="max"``): 3
    launcher steps on the card twice, bit for bit, losses within 1e-4 of
    the CPU's; the sequential and the associative mamba scans on the card
    within 1e-3 of each other; greedy tokens equal to the CPU's,
    channel-free, under OCS p 0.05 and under ``retry(2)`` with bursts and
    outages (the held ticks restore the recurrent states)."""
    from repro_torch import faults
    from repro_torch.data import pipeline
    from repro_torch.launch import train as lt
    from repro_torch.models import mamba
    from repro_torch.protocol import Protocol

    def train(dev):
        run = lt.setup(lt.parse_args([
            "--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "32"]))
        run.values = tree.map(lambda t: t.to(dev), run.values)
        pcfg = pipeline.for_model(run.cfg, batch=4, seq_len=32, seed=0)
        run.data = lambda s: pipeline.batch_for_step(pcfg, s, device=dev)
        return lt.launch(run)

    a, b, c = train(cuda_device), train(cuda_device), train("cpu")
    _same_tree(a.values, b.values)
    _same_tree(a.opt_state, b.opt_state)
    for ra, rc in zip(a.history, c.history):
        assert abs(ra["loss"] - rc["loss"]) <= 1e-4 * abs(rc["loss"])
    cfg = get_reduced(arch, tp_fusion="max")
    if arch.startswith("jamba"):
        p = mamba.mamba_init(cfg, torch.Generator().manual_seed(1))
        p = tree.map(lambda t: t.to(cuda_device), p)
        x = torch.randn((2, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(2))
        seq = mamba.mamba_full(cfg, p, x.to(cuda_device))
        assoc = mamba.mamba_full(cfg.with_(mamba_assoc_scan=True), p,
                                 x.to(cuda_device))
        assert float((seq - assoc).abs().max()) <= 1e-3
    m = TM.build(cfg)
    cpu_values = m.init(torch.Generator().manual_seed(0))
    gpu_values = tree.map(lambda t: t.to(cuda_device), cpu_values)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(
        np.int32), max_new_tokens=8, arrival_tick=i) for i in range(4)]
    p_miss = np.full((cfg.n_workers,), 0.05, np.float32)
    fault = faults.FaultModel.burst(
        burst_len=4, gap_len=16, p_miss_bad=0.5, p_miss_good=0.01,
        policy=faults.DegradePolicy.retry(2)).with_dropout(0.5, 0.3)
    for proto, fm in ((None, None),
                      (Protocol.ocs(bits=8, p_miss=p_miss), None),
                      (Protocol.ocs(bits=8, p_miss=p_miss), fault)):
        config = ServeConfig(batch_slots=2, max_seq=32, eos_id=-1,
                             protocol=proto, fault=fm)
        want = ServeEngine(m, cpu_values, config, device="cpu").run(reqs)
        got = ServeEngine(m, gpu_values, config, device=cuda_device).run(
            reqs)
        for rid in want:
            assert got[rid].tokens == want[rid].tokens, (rid, fm)
            assert got[rid].retry_ticks == want[rid].retry_ticks


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (2, 8, 8, 384, 384, 64, False), (2, 8, 8, 1408, 1408, 64, False),
    (2, 8, 8, 4, 4, 64, True), (1, 32, 8, 256, 256, 128, True)],
    ids=["whisper encoder", "whisper serve encoder", "whisper 4-token "
         "prefill", "pixtral"])
def test_flash_at_the_encdec_shapes(cuda_device, b, h, hkv, sq, sk, d,
                                    causal):
    """Flash at the encoder-decoder slice's shapes, bf16, within two ulps
    of each query row's largest plain value (``_assert_flash_close``):
    whisper's non-causal encoder (384 and 1,408 frames), its 4-token
    decoder prefill (a query tile taller than the sequence) and pixtral's
    GQA 4:1 at head_dim 128."""
    gen = torch.Generator().manual_seed(sq + h)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               .to(cuda_device) for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                              (b, hkv, sk, d)))
    _assert_flash_close(FO.flash_attention(q, k, v, causal),
                        FR.flash_attention(q, k, v, causal))


def _greedy(m, values, batch, ticks, protocol, dev):
    """``prefill`` then ``ticks`` greedy ``decode_step_channel`` ticks
    (``decode_step`` without a protocol): the tokens, (B, ticks + 1)."""
    from repro_torch import random as jrand
    batch = {k: v.to(dev) for k, v in batch.items()}
    s = batch["tokens"].shape[1] if "tokens" in batch else \
        batch["feats"].shape[1]
    logits, cache = m.prefill(values, batch, max_seq=s + ticks)
    tok = torch.argmax(logits, -1)
    out = [tok]
    for t in range(ticks):
        pos = torch.full_like(tok, s + t, dtype=torch.int32)
        if protocol is None:
            logits, cache = m.decode_step(values, tok[:, None].int(), pos,
                                          cache)
        else:
            logits, cache, _ = m.decode_step_channel(
                values, tok[:, None].int(), pos, cache, protocol,
                jrand.fold_in(jrand.PRNGKey(0), t))
        tok = torch.argmax(logits, -1)
        out.append(tok)
    return torch.stack(out, 1).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_encdec_plans_card_match_cpu(cuda_device, arch):
    """The reduced whisper and pixtral configs (``tp_fusion="max"``,
    flash): 3 launcher steps on the card twice, bit for bit, losses within
    1e-4 of the CPU's; the greedy tokens of a prefill and 8 decode ticks
    equal to the CPU's, channel-free and under OCS p 0.05."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train as lt
    from repro_torch.protocol import Protocol

    def train(dev):
        run = lt.setup(lt.parse_args([
            "--arch", arch, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "32"]))
        run.values = tree.map(lambda t: t.to(dev), run.values)
        pcfg = pipeline.for_model(run.cfg, batch=4, seq_len=32, seed=0)
        run.data = lambda s: pipeline.batch_for_step(pcfg, s, device=dev)
        return lt.launch(run)

    a, b, c = train(cuda_device), train(cuda_device), train("cpu")
    _same_tree(a.values, b.values)
    _same_tree(a.opt_state, b.opt_state)
    for ra, rc in zip(a.history, c.history):
        assert abs(ra["loss"] - rc["loss"]) <= 1e-4 * abs(rc["loss"])
    cfg = get_reduced(arch, tp_fusion="max", use_flash=True)
    m = TM.build(cfg)
    cpu_values = m.init(torch.Generator().manual_seed(0))
    if cfg.tie_embeddings:
        # logits flat enough that greedy tokens are not the prompt's
        cpu_values["embed"]["tokens"].mul_(0.02)
    gpu_values = tree.map(lambda t: t.to(cuda_device), cpu_values)
    rng = np.random.default_rng(0)
    batch = {"feats": torch.from_numpy(rng.standard_normal(
        (2, 32, cfg.frontend_dim)).astype(np.float32))}
    if cfg.encoder_decoder:
        batch["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 4)).astype(np.int32))
    p_miss = np.full((cfg.n_workers,), 0.05, np.float32)
    for proto in (None, Protocol.ocs(bits=8, p_miss=p_miss)):
        want = _greedy(m, cpu_values, batch, 8, proto, "cpu")
        got = _greedy(m, gpu_values, batch, 8, proto, cuda_device)
        assert torch.equal(got, want), (proto, got, want)


# ---------------------------------------------------------------------------
# the dry-run's fake impls and fake-CUDA traces
# ---------------------------------------------------------------------------

def _layout(ts):
    return [(tuple(t.shape), t.dtype, t.stride()) for t in ts]


def _fake_outputs(fn, *args):
    """``fn``'s outputs on fake copies of the CUDA tensors ``args``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    fakes = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
             for a in args]
    with mode:
        return fn(*fakes)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,s,d,causal",
                         [(1, 16, 16, 256, 64, True),
                          (2, 8, 2, 384, 128, False)])
def test_flash_fake_impl_is_the_kernels_layout(cuda_device, b, h, hkv, s,
                                               d, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((b, h, s, d), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    real = FO.flash_fwd(q, k, v, causal)
    fake = _fake_outputs(FO.flash_fwd, q, k, v, causal)
    assert _layout([real]) == _layout([fake])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim", [((16, 8, 256, 64), 0),
                                       ((2, 33, 100), 1)])
@pytest.mark.parametrize("winner,ties", [(True, False), (False, True),
                                         (True, True)])
def test_maxpool_fake_impls_are_the_kernels_layout(cuda_device, shape, dim,
                                                   winner, ties):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    h = torch.randn(shape, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    real = MPO._fwd(h, dim, winner, ties)
    fake = _fake_outputs(MPO._fwd, h, dim, winner, ties)
    assert _layout(real) == _layout(fake)
    if ties:
        g = torch.randn(real[0].shape, generator=gen, device=cuda_device,
                        dtype=torch.bfloat16)
        n = shape[dim]
        got = MPO._ties_bwd(real[-1], g, n, dim)
        want = _fake_outputs(MPO._ties_bwd, real[-1], g, n, dim)
        assert _layout([got]) == _layout([want])


@pytest.mark.cuda
def test_dryrun_fake_cuda_counts_the_fake_cpu_counts(cuda_device):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    cfg = get_reduced("glm4-9b", n_workers=4, tp_fusion="max",
                      use_flash=True)
    for shape in (ShapeConfig("t", "train", 16, 8),
                  ShapeConfig("p", "prefill", 32, 4),
                  ShapeConfig("d", "decode", 32, 8)):
        got = {}
        for dev in ("cpu", "cuda"):
            with dryrun.fake_world(8):
                mesh = tmesh.make_mesh(2, 4)
                rules = tmesh.rules_for(shape.name, shape.global_batch, mesh)
                got[dev] = dryrun.trace(dryrun.build_step, cfg, shape, mesh,
                                        rules, 1, dev)
        assert got["cuda"]["flops"] == got["cpu"]["flops"] > 0
        assert got["cuda"]["records"] == got["cpu"]["records"]


# -- the analysis on the card ----------------------------------------------

def _analysis_names():
    from repro_torch.analysis import registry
    return registry.contract_names()


@pytest.mark.cuda
@pytest.mark.parametrize("name", _analysis_names())
def test_analysis_entry_runs_sync_free(cuda_device, name):
    """Each registered entry on real CUDA tensors completes under
    ``set_sync_debug_mode("error")`` and launches its kernels; its
    fake-CUDA op stream is its fake-CPU stream but for the device and the
    port's documented device branches."""
    from repro_torch.analysis import contracts, registry
    contract = registry.get_contract(name)
    entry = contract.build()
    args = contracts.map_tensors(lambda t: t.to(cuda_device),
                                 entry.argsf(0.05))
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        entry.fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in contract.kernels), counts
    cpu = registry.trace_entry(contract, "cpu", entry)
    cuda = registry.trace_entry(contract, "cuda", entry)
    assert cpu.error is None and cuda.error is None
    assert contracts.stream_differences(cpu.stream, cuda.stream,
                                        registry.DEVICE_BRANCHES) == []


@pytest.mark.cuda
def test_analysis_cli_on_the_card(tmp_path):
    import pathlib
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    from repro_torch.analysis.__main__ import main
    root = pathlib.Path(__file__).resolve().parents[1]
    assert main(["--root", str(root), "--device", "cuda", "--json",
                 str(tmp_path / "r.json")]) == 0


@pytest.mark.cuda
def test_channel_custom_ops_on_fake_cuda(cuda_device):
    """The channel kernels' six wrappers take fake CUDA tensors through
    their custom ops, with the kernels' output layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.contracts import OpRecorder
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    h = torch.randn((3, 4, 256), generator=gen, device=cuda_device)
    mask = torch.tensor([True, True, False, True], device=cuda_device)
    rng = jr.split(jr.PRNGKey(0, device=cuda_device), 3)
    p = torch.full((3, 1, 1), 0.9, device=cuda_device)
    win = torch.randint(0, 4, (3, 256), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    word = CR.contention_words(h, 8, 2)
    heard = CR.draw_heard_packed(rng, p, 4, 256, n_slots=10, max_rounds=3)
    calls = {
        "ocs_encode": (lambda h: QO.encode(h, 8), (h,)),
        "ocs_decode": (lambda c: QO.decode(c, 8, torch.bfloat16),
                       (QO.encode(h, 8),)),
        "maxpool_decode": (lambda h, m, w: MPO.maxpool_decode(
            h, 8, torch.float32, mask=m, winner=w, max_code=True,
            argmax=True, correct=True), (h, mask, win)),
        "maxpool_winner_bwd": (lambda w, g: MPO.maxpool_winner_bwd(
            w, g, 4, 1), (win, h[:, 0].contiguous())),
        "ocs_noisy": (lambda h, m, r, q: CO.noisy_contention(
            h, m, 8, 2, r, q, n_slots=10, max_rounds=3), (h, mask, rng, p)),
        "ocs_contend": (lambda w, d, m: CO.contend(
            w, d, m, 10, n_slots=10, max_rounds=3), (word, heard, mask)),
    }

    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [
            t for t in x if t is not None]

    for op, (fn, args) in calls.items():
        kernels.reset_launch_counts()
        real = flat(fn(*args))
        assert sum(kernels.launch_counts().values()) == 1, op
        mode = FakeTensorMode()
        fakes = [mode.from_tensor(a) for a in args]
        with mode, OpRecorder() as rec:
            fake = flat(fn(*fakes))
        assert [o.name for o in rec.stream if o.name.startswith(
            "repro_torch.")] == [f"repro_torch.{op}.default"], op
        assert [(tuple(t.shape), t.dtype) for t in real] == \
            [(tuple(t.shape), t.dtype) for t in fake], op
        assert all(t.device.type == "cuda" for t in fake), op
