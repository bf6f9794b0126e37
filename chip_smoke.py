"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` for
   ``sm_90a`` and print the build seconds;
3. for each kernel, at the shapes the main path gives it (4 p_miss lanes x
   4 workers x a 64 x 64 batch of embeddings; contention at bits 8 and 16),
   check the kernel bitwise against its plain PyTorch version on the card
   and time both (CUDA events);
4. check that at ``p_miss=0`` ``Protocol.ocs(bits).aggregate`` equals
   ``Protocol.ideal_max(bits, tie_break="first").aggregate`` bitwise,
   forward and input gradient, at bits 8 and 16;
5. run ``run_curves`` at the fedocs-cifar width (4 workers, 32 x 32 images,
   encoders (256, 128), K = 64, head (512, 512, 512), 10 classes) for 60
   steps with every launch count set to 0 just before and read just after;
   every kernel must have launched, every loss be finite, and the
   ``p_miss=0`` lanes must have trained bit for bit as the ideal runs;
6. run a small grid on the card and on the CPU (plain versions) and
   compare losses and accuracies;
7. profile a short run at the main path's width (device busy time, idle
   share, time by kernel; the table goes to ``chiprun_out/``);
8. print one ``{"kernels": [...]}`` line and, last, the device line.

It imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port itself: a copy of this script alone fails here
from repro_torch import kernels, tree  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.core import ocs  # noqa: E402
from repro_torch.kernels.maxpool import ops as mp_ops  # noqa: E402
from repro_torch.kernels.maxpool import ref as mp_ref  # noqa: E402
from repro_torch.kernels.ocs_contention import ops as ct_ops  # noqa: E402
from repro_torch.kernels.ocs_contention import ref as ct_ref  # noqa: E402
from repro_torch.kernels.ocs_quant import ops as q_ops  # noqa: E402
from repro_torch.kernels.ocs_quant import ref as q_ref  # noqa: E402
from repro_torch.protocol import Protocol  # noqa: E402
from repro_torch.sim import results  # noqa: E402
from repro_torch.sim import train_curves as tc  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
NONTENSOR_OPS_PER_S = 67e12    # H100 SXM float32 rate outside tensor cores
LANES, N, B, K, ROUNDS = 4, 4, 64, 64, 3
EVAL_ROWS = 512                # CurveConfig.n_val
SOURCES = {"ocs_quant.encode": "ocs_quant.cu",
           "ocs_quant.decode": "ocs_quant.cu", "maxpool.fwd": "maxpool.cu",
           "maxpool.winner_bwd": "maxpool.cu",
           "ocs_contention.contend": "ocs_contention.cu"}
REPLACES = {
    "ocs_quant.encode": "src/repro/kernels/ocs_quant/ocs_quant.py:27",
    "ocs_quant.decode": "src/repro/kernels/ocs_quant/ocs_quant.py:37",
    "maxpool.fwd": "src/repro/kernels/maxpool/maxpool.py:31",
    "maxpool.winner_bwd": "src/repro/kernels/maxpool/maxpool.py:72",
    "ocs_contention.contend":
        "src/repro/kernels/ocs_contention/ocs_contention.py:50"}


def _time_ms(fn, iters: int = 200) -> float:
    """Mean time per call of ``fn`` called back to back, between two CUDA
    events: for launches this small it is the host's issue rate."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters: int = 50):
    """(ms, source): the device time per call of ``fn``, the summed
    duration of every kernel and memory operation it runs on the card, from
    a profiled window of ``iters`` calls (source ``"profiler"``).  Where
    the profiler sees no device time, CUDA-event timing of calls back to
    back, which is the host's issue rate (source ``"events"``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us == 0:
        print("profiler saw no device time; timing with CUDA events",
              flush=True)
        return _time_ms(fn), "events"
    return total_us / iters / 1e3, "profiler"


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        a = a.view(torch.int32 if a.element_size() == 4 else torch.int16)
        b = b.view(a.dtype)
    elif a.dtype in (torch.uint16, torch.uint32):
        a = a.view(torch.int16 if a.dtype == torch.uint16 else torch.int32)
        b = b.view(a.dtype)
    return bool(torch.equal(a, b))


def _check_equal(name, launch, plain, extra) -> float:
    """Run the kernel and its plain version on the same inputs; raise
    unless every output is bitwise equal.  Returns the max abs error."""
    out_k, out_p = launch(), plain()
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip(outs_k, outs_p):
        if not _bitwise_equal(a, b):
            raise AssertionError(f"{name} {extra}: kernel != plain")
        if a.dtype.is_floating_point:
            d = (a.float() - b.float()).abs()
            d = d[torch.isfinite(d)]
            err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def _kernel_cases(dev, lanes: int, cols: int, bits: int, seed: int):
    """(name, launch, plain, nbytes, ops, library call or None, shape) of
    each kernel at ``lanes`` x N workers x ``cols`` pooled elements: the
    embeddings flattened the way the pooling laws hand them over."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    h = (torch.randn((lanes, N, cols), generator=gen) * 3.0).to(dev)
    g = torch.randn((lanes, cols), generator=gen).to(dev)
    codes = q_ops.encode(h, bits)
    cb = codes.element_size()
    pooled, winner = mp_ops.maxpool_fused(codes, 1)
    # the contention word and the packed sensing planes of one step
    id_bits = ocs.host_id_bits(N)
    word = q_ref.from_int64((codes.to(torch.int64) << id_bits)
                            | ocs._id_codes(N, id_bits, dev)[:, None],
                            torch.uint32)
    total = n_slots = bits + id_bits
    keys = jr.split(jr.PRNGKey(bits, dev), lanes)
    p_keep = ocs.sensing_keep_prob(
        torch.tensor([0.0, 0.02, 0.05, 0.1][:lanes], device=dev), lanes=True)
    heard = ct_ops.draw_heard_packed(keys, p_keep, N, cols, n_slots=n_slots,
                                     max_rounds=ROUNDS)
    mask = torch.ones((N,), dtype=torch.bool, device=dev)
    kw = dict(n_slots=n_slots, max_rounds=ROUNDS)
    shape = [lanes, N, cols]
    return [
        ("ocs_quant.encode", lambda: q_ops.encode(h, bits),
         lambda: q_ref.encode(h, bits), h.numel() * (4 + cb), 4 * h.numel(),
         None, shape),
        ("ocs_quant.decode", lambda: q_ops.decode(pooled, bits, torch.float32),
         lambda: q_ref.decode(pooled, bits, torch.float32),
         pooled.numel() * (cb + 4), 8 * pooled.numel(), None,
         list(pooled.shape)),
        ("maxpool.fwd", lambda: mp_ops.maxpool_fused(codes, 1),
         lambda: mp_ref.maxpool_fused(codes, 1),
         codes.numel() * cb + pooled.numel() * (cb + 4),
         pooled.numel() * (N - 1),
         (lambda: torch.max(codes, dim=1)) if bits == 8 else None, shape),
        ("maxpool.winner_bwd", lambda: mp_ops.maxpool_winner_bwd(
            winner, g, N, 1), lambda: mp_ref.maxpool_winner_bwd(
            winner, g, N, 1), winner.numel() * 8 + g.numel() * N * 4,
         g.numel() * N, None, shape),
        ("ocs_contention.contend",
         lambda: ct_ops.contend(word, heard, mask, total, **kw),
         lambda: ct_ref.contend(word, heard, mask, total, **kw),
         word.numel() * 4 + heard.numel() * 4 + lanes * cols * 4,
         lanes * cols * ROUNDS * n_slots * (6 * N + 3), None, shape),
    ]


def check_kernels(dev) -> dict:
    """Phase 3: every kernel bitwise against its plain version at the
    training step's shape (4 lanes x 4 workers x a 64 x 64 batch of
    embeddings), timed; and bitwise, untimed, at the other shapes the main
    path launches: the ideal run's single lane, and the evaluation's 512 x
    64 elements (4 noisy lanes and the ideal lane)."""
    rows = {}

    def row(name, launch, plain, nbytes, ops, lib, extra):
        err = _check_equal(name, launch, plain, extra)
        (ms, src_k), (plain_ms, src_p) = _device_ms(launch), _device_ms(plain)
        lib_ms, src_l = _device_ms(lib) if lib is not None else (None, None)
        bound_ms, bound_by = _bound(nbytes, ops)
        # "events": the profiler saw no device time and a number is the
        # host's issue rate, not device time
        ms_source = ("profiler" if {src_k, src_p, src_l} <= {"profiler", None}
                     else "events")
        rec = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/" + SOURCES[name],
               "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "ms_source": ms_source, "host_ms": _time_ms(launch), **extra}
        print(f"kernel {name} {extra}: bitwise equal; device {ms:.6f} ms "
              f"kernel, {plain_ms:.6f} ms plain, bound {bound_ms:.6f} ms "
              f"({bound_by}, {ms_source}); {rec['host_ms']:.6f} ms per call "
              "back to back", flush=True)
        return rec

    for bits in (8, 16):
        for name, launch, plain, nbytes, ops, lib, shape in _kernel_cases(
                dev, LANES, B * K, bits, seed=0):
            if name == "maxpool.winner_bwd" and bits == 16:
                continue            # takes the float cotangent, not codes
            rows[(name, bits)] = row(name, launch, plain, nbytes, ops, lib,
                                     dict(bits=bits, shape=shape))
        for lanes, cols in ((1, B * K), (LANES, EVAL_ROWS * K),
                            (1, EVAL_ROWS * K)):
            for name, launch, plain, *_, shape in _kernel_cases(
                    dev, lanes, cols, bits, seed=lanes + bits):
                _check_equal(name, launch, plain, dict(bits=bits, shape=shape))
        print(f"kernels at bits={bits}: bitwise equal also at the ideal "
              "lane and the evaluation shapes", flush=True)
    return rows


def check_p0_equivalence(dev) -> None:
    """Phase 4: at p_miss=0 the OCS law is the ideal 'first' law."""

    gen = torch.Generator(device="cpu").manual_seed(1)
    h0 = (torch.randn((N, B, K), generator=gen) * 2.0).to(dev)
    g = torch.randn((B, K), generator=gen).to(dev)
    for bits in (8, 16):
        outs = []
        for proto, rng in ((Protocol.ocs(bits, p_miss=0.0),
                            jr.PRNGKey(7, dev)),
                           (Protocol.ideal_max(bits, tie_break="first"),
                            None)):
            h = h0.clone().requires_grad_(True)
            pooled, _ = proto.aggregate(h, rng)
            (grad,) = torch.autograd.grad(pooled, h, g)
            outs.append((pooled.detach(), grad))
        (pa, ga), (pb, gb) = outs
        assert _bitwise_equal(pa, pb), f"bits={bits}: p0 forward differs"
        assert _bitwise_equal(ga, gb), f"bits={bits}: p0 gradient differs"
        print(f"p0: Protocol.ocs({bits}) == ideal_max({bits}, 'first'), "
              "forward and gradient, bitwise", flush=True)


def cifar_config(**overrides):
    """``configs/fedocs_cifar.cifar10_like`` as a curve grid."""

    kw = dict(grid=2, hw=32, n_classes=10, encoder_dims=(256, 128),
              embed_dim=64, head_dims=(512, 512, 512), bits=(8, 16),
              p_miss=(0.0, 0.02, 0.05, 0.1))
    kw.update(overrides)
    return tc.CurveConfig(**kw)


def run_main_path(dev):
    """Phase 5: run_curves at the fedocs-cifar width, counted."""

    ccfg = cifar_config()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tc.run_curves(ccfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"run_curves fedocs-cifar width: {ccfg.steps} steps x "
          f"{len(ccfg.bits)} bits x {len(ccfg.p_miss)} lanes + ideal: "
          f"{wall:.3f} s wall; launches {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    for arr in (res.loss_history, res.ideal_loss_history, res.nll,
                res.nll_ideal):
        assert np.all(np.isfinite(arr)), "non-finite loss"
    assert res.acc.shape == (2, 4) and np.all((0 <= res.acc) & (res.acc <= 1))
    for bi in range(len(ccfg.bits)):
        for x, y in zip(tree.leaves(res.noisy_params[bi]),
                        tree.leaves(res.ideal_params[bi])):
            assert torch.equal(x[0], y[0]), "p0 lane diverged from ideal"
        assert res.acc[bi, 0] == res.acc_ideal[bi]
    print("p0 lanes trained bit for bit as the ideal runs", flush=True)
    for line in results.curve_rows(results.summarize_curves(res)):
        print(line)
    return counts, wall, res


def profile_main_path(dev) -> None:
    """Phase 7: where a training step's time goes — torch.profiler over
    10 steps at the fedocs-cifar width (one depth, bits=8).  The device
    time is the summed duration of the card's kernels and copies; the idle
    share compares it with the same run's wall time unprofiled.  The full
    table goes to chiprun_out/profile_main.txt."""
    ccfg = cifar_config(steps=10, bits=(8,))
    tc.run_curves(ccfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tc.run_curves(ccfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tc.run_curves(ccfg, device=dev)
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            launches += 1
    device_s = sum(by_name.values()) / 1e6
    # int64 elementwise kernels: the threefry draws (sensing, batches)
    int64_s = sum(us for name, us in by_name.items()
                  if "<long" in name or "Functor<long" in name) / 1e6
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_main.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))
    print(f"profile, 10 steps + eval at bits=8: wall {wall:.4f} s "
          f"unprofiled, device busy {device_s:.4f} s, idle share "
          f"{1 - device_s / wall:.3f}; {launches} device kernels and "
          f"copies; int64 elementwise kernels {int64_s:.4f} s of the "
          "device time", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:10.3f} ms  {name[:100]}", flush=True)


def check_against_cpu(dev) -> None:
    """Phase 6: a small grid on the card against the plain CPU path.

    Float sums differ in order between the card and the CPU (~1e-6
    relative), and such a difference can move an embedding across a D-bit
    bucket edge and so change a winner; the tolerances cover that."""

    ccfg = tc.CurveConfig(bits=(8, 16), p_miss=(0.0, 0.3), steps=8,
                          batch=16, n_train=128, n_val=64, hw=8,
                          encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                          log_every=4)
    gpu = tc.run_curves(ccfg, device=dev)
    cpu = tc.run_curves(ccfg, device="cpu")
    loss_err = float(np.max(np.abs(gpu.loss_history - cpu.loss_history)))
    acc_err = float(np.max(np.abs(gpu.acc - cpu.acc))) * ccfg.n_val
    print(f"small grid card vs CPU: max loss diff {loss_err:.3g}, "
          f"max accuracy diff {acc_err:.0f} of {ccfg.n_val} samples",
          flush=True)
    assert loss_err < 1e-3, loss_err
    assert acc_err <= 2, acc_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    kernels.library()
    print(f"kernels built and loaded in {kernels.build_seconds:.2f} s",
          flush=True)

    rows = check_kernels(dev)
    check_p0_equivalence(dev)
    counts, wall, _ = run_main_path(dev)
    check_against_cpu(dev)
    profile_main_path(dev)

    line = []
    for name in kernels.KERNELS:
        # the rows timed at the main path's first depth (bits=8)
        rec = rows[(name, 8)]
        line.append(dict(rec, launches=counts[name]))
    print(f"run_curves wall seconds: {wall}", flush=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
