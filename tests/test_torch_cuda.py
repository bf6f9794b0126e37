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

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.core import ocs
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.maxpool import ops as MPO
from repro_torch.kernels.maxpool import ref as MPR
from repro_torch.kernels.ocs_contention import ops as CO
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
    codes = QR.to_int64(QR.encode(h, bits))
    word = QR.from_int64((codes << id_bits)
                         | ocs._id_codes(n, id_bits)[:, None], torch.uint32)
    mask = torch.arange(n) < n_real
    keys = jr.split(jr.PRNGKey(n), lanes)
    p_keep = ocs.sensing_keep_prob(torch.full((lanes,), p_miss), lanes=True)
    heard = CO.draw_heard_packed(keys, p_keep, n, k, n_slots=n_slots,
                                 max_rounds=rounds)
    heard_c = CO.draw_heard_packed(keys.to(cuda_device),
                                   p_keep.to(cuda_device), n, k,
                                   n_slots=n_slots, max_rounds=rounds)
    _same(heard, heard_c)
    kw = dict(n_slots=n_slots, max_rounds=rounds)
    want = CO.contend(word, heard, mask, bits + id_bits, **kw)
    got = CO.contend(word.to(cuda_device), heard_c, mask.to(cuda_device),
                     bits + id_bits, **kw)
    for a, b in zip(want, got):
        _same(a, b)


# flash attention: the prefill shapes (bf16, causal) and the JAX parity
# test's float32 GQA cases at blocks of 64; tolerances are the JAX test's
# (the kernel sums in another order than the whole-matrix softmax)
_FLASH_CASES = ([(16, 16, 128, torch.bfloat16, True, 128),
                 (16, 16, 512, torch.bfloat16, True, 128)]
                + [(4, hkv, 192, torch.float32, causal, 64)
                   for hkv in (1, 2, 4) for causal in (True, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,s,dtype,causal,block", _FLASH_CASES)
def test_flash_matches_plain(cuda_device, h, hkv, s, dtype, causal, block):
    gen = torch.Generator().manual_seed(s + hkv)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(cuda_device)
               for shape in ((1, h, s, 64), (1, hkv, s, 64),
                             (1, hkv, s, 64)))
    got = FO.flash_attention(q, k, v, causal, block, block)
    want = FR.flash_attention(q, k, v, causal)
    atol = 0.05 if dtype == torch.bfloat16 else 3e-5
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= atol


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
