"""Compare this checkout of the port with another on one NVIDIA GPU, in
turns (this, other, other, this), so that both see the same card and host.

    python3 chip_ab.py OTHER --flash     # the flash forward's device time
    python3 chip_ab.py OTHER --kernels   # the channel kernels' device time
    python3 chip_ab.py OTHER --paths     # the curves and serving paths
    python3 chip_ab.py OTHER --ops       # device ops of a channel site (CPU)

``OTHER`` is the root of another checkout (the parent commit unpacked with
``git archive``, say) or a directory that holds another version of
``src/repro_torch/kernels/csrc``.

``--flash``: both checkouts' kernel libraries loaded in one process; the
device time per call of ``flash_attention.fwd`` alone (profiler) at
(1, 16, S, 64) bf16 causal, S 256, 1024 and 4096, and that of
``scaled_dot_product_attention`` beside.

``--kernels``: each turn a fresh process that builds its side's kernels
and prints the device time per call of each channel kernel alone
(profiler) at the curves' shape (4 lanes x 4 workers x 4096, bits 8,
float32) and serving's (1 x 16 x 8192, bits 8, bfloat16), as its side's
``chip_smoke._kernel_cases`` forms the calls (another checkout's own
cases: its kernels may take other operands), and the ideal lane's
``maxpool.decode``; then, at one max-fusion site of the LM train step
((16, 8 x 256 x 1024) bf16 partials), the device time of the side's
``fedocs.maxpool(h, "all")`` forward and backward (every kernel of the
call), of ``maxpool.fwd`` alone in the law's form (the tie mask where
the side has it, else the winner) and in the winner form, of the side's
tie-routed backward alone where it has one, and of ``torch.max(dim=0)``.

``--paths``: each turn a fresh process that runs the checkout's own
``chip_smoke.py`` phases 5, 7, 8 and 11 (``run_curves`` at the
fedocs-cifar width, its 10-step profile, serving qwen1.5-0.5b at full
width, its 10-tick profile) and prints their lines.

``--serve``: each turn a fresh process that runs the checkout's own
``chip_smoke.py`` phases 8 and 11 (serving qwen1.5-0.5b at full width,
8 requests, prefills included, and its 10-tick profile) and prints
their lines: the host cost of a change to the serving path's wrappers.

``--ops`` needs no GPU: for each checkout, a fresh process runs the card
path on ``meta`` tensors (the kernel wrappers' operand checks off, each
launch counted) under a ``TorchDispatchMode`` that counts every other
aten op that launches on a card (allocations and views do not) and
prints the device ops of one serving channel site (16 workers x 8 slots
x 1024 bf16, OCS p 0.05) and of the curves' pooling of one step (4 noisy
lanes + the ideal lane, 4 workers x 64 x 64; forward, and forward and
backward).

Exits non-zero without a GPU (but for ``--ops``); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent


def _csrc(other: pathlib.Path) -> pathlib.Path:
    nested = other / "src" / "repro_torch" / "kernels" / "csrc"
    return nested if nested.is_dir() else other


def kernel_turn(other: pathlib.Path) -> None:
    """One turn of --kernels, in this process: ``other`` is a checkout
    root (its own cases and kernels) or a ``csrc`` directory (this
    checkout's cases over those sources)."""
    import torch

    root = other if (other / "chip_smoke.py").is_file() else ROOT
    sys.path.insert(0, str(root))
    import chip_smoke as C  # noqa: E402  (puts that checkout's src first)
    from repro_torch import kernels

    if root == ROOT and other != ROOT:
        kernels.CSRC = _csrc(other)
    kernels.library()
    dev = torch.device("cuda")
    shapes = {"curves": dict(lanes=C.LANES, cols=C.B * C.K),
              "serve": dict(lanes=1, cols=C.SERVE_SLOTS * C.QWEN_D,
                            n=C.QWEN_WORKERS, dtype=torch.bfloat16,
                            p_miss=(0.05,))}
    for what, kw in shapes.items():
        cases = [(name, launch) for name, launch, *_ in C._kernel_cases(
            dev, bits=8, seed=0, **kw)]
        # the ideal lane's form: no mask, no winner, the first argmax, from
        # the features where the checkout's decode takes them
        dtype = kw.get("dtype", torch.float32)
        h = torch.randn((kw["lanes"], kw.get("n", C.N), kw["cols"]),
                        device=dev).to(dtype)
        try:
            C.mp_ops.maxpool_decode(h, 8, dtype, argmax=True)
            x = h
        except ValueError:
            x = C.q_ops.encode(h, 8)
        cases.append(("maxpool.decode (ideal form)", lambda x=x, dtype=dtype:
                      C.mp_ops.maxpool_decode(x, 8, dtype, argmax=True)))
        for name, launch in cases:
            symbol = C.SYMBOLS[name.split("[")[0].split(" ")[0]]
            ms = C._device_ms(launch, symbol=symbol)[2]
            print(f"kernel-ab {name} {what}: {ms:.6f} ms", flush=True)
    train_site_turn(C, dev)


def train_site_turn(C, dev) -> None:
    """--kernels at the LM train step's max-fusion site, in this turn's
    checkout."""
    import torch
    from repro_torch.core import fedocs

    gen = torch.Generator(device="cpu").manual_seed(18)
    h = torch.randn((C.QWEN_WORKERS, C.TRAIN_BATCH, C.TRAIN_SEQ, C.QWEN_D),
                    generator=gen).to(torch.bfloat16).to(dev)
    g = torch.randn(h.shape[1:], generator=gen).to(torch.bfloat16).to(dev)
    hg = h.clone().requires_grad_(True)
    ops = C.mp_ops
    law = getattr(ops, "maxpool_ties", ops.maxpool_fused)
    cases = [("site all-law fwd+bwd", lambda: torch.autograd.grad(
                  fedocs.maxpool(hg, "all"), hg, g), None),
             ("maxpool.fwd law form", lambda: law(h, 0), "maxpool_fwd_"),
             ("maxpool.fwd winner form", lambda: ops.maxpool_fused(h, 0),
              "maxpool_fwd_"),
             ("torch.max(dim=0)", lambda: torch.max(h, dim=0), None)]
    if hasattr(ops, "maxpool_ties_bwd"):
        mask = ops.maxpool_ties(h, 0)[1]
        cases.append(("maxpool.ties_bwd", lambda: ops.maxpool_ties_bwd(
            mask, g, C.QWEN_WORKERS, 0), "ties_bwd_kernel"))
    for name, fn, symbol in cases:
        ms, _, own = C._device_ms(fn, symbol=symbol)
        print(f"kernel-ab {name} train: "
              f"{own if symbol else ms:.6f} ms", flush=True)


# aten ops that allocate or view and launch nothing on a card
_NO_LAUNCH = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided", "view", "_reshape_alias", "reshape",
              "_unsafe_view", "expand", "select", "slice", "as_strided",
              "detach", "alias", "unsqueeze", "squeeze", "t", "transpose",
              "permute", "unbind", "split", "split_with_sizes",
              "lift_fresh", "is_same_size"}


def ops_turn(root: pathlib.Path) -> None:
    """One side of --ops, in this process: ``root``'s own package."""
    import collections

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    sys.path.insert(0, str(root / "src"))
    from repro_torch import kernels
    from repro_torch.protocol import Protocol

    launched = collections.Counter()
    kernels.check_operands = lambda *tensors: None
    kernels.launch = lambda name, fn, device, *args: launched.update([name])

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name not in _NO_LAUNCH:
                self.ops[name] += 1
            return func(*args, **(kwargs or {}))

    def report(what, mode):
        ops = sum(mode.ops.values()) + sum(launched.values())
        print(f"ops {what}: {ops} device ops ({sum(launched.values())} "
              f"kernel launches {dict(launched)}; torch {dict(mode.ops)})",
              flush=True)

    meta = torch.device("meta")
    h = torch.empty((16, 8, 1024), dtype=torch.bfloat16, device=meta)
    proto = Protocol.ocs(bits=8, p_miss=torch.full((16,), 0.05))
    with Count() as mode:
        proto.aggregate(h, torch.empty((2,), dtype=torch.int64, device=meta))
    report("serving site", mode)
    noisy = Protocol.ocs(8).with_p_miss(torch.tensor([0.0, 0.02, 0.05,
                                                      0.1]))
    keys = torch.empty((4, 2), dtype=torch.int64, device=meta)
    for backward in (False, True):
        launched.clear()
        hs = torch.empty((5, 4, 64, 64), device=meta, requires_grad=True)
        with Count() as mode:
            if hasattr(Protocol, "aggregate_with_ideal"):
                v, _ = noisy.aggregate_with_ideal(hs, keys)
            else:           # a checkout from before the stack pool
                v_n, _ = noisy.aggregate(hs[:4], keys, lanes=True)
                v_i, _ = Protocol.ideal_max(8, tie_break="first").aggregate(
                    hs[4:], lanes=True)
                v = torch.cat([v_n, v_i])
            if backward:
                torch.autograd.grad(v, hs, torch.empty_like(v))
        report("curves pooling" + (", forward and backward" if backward
                                   else ", forward"), mode)


def compare_flash(other: pathlib.Path) -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    import chip_smoke as C  # noqa: E402  (puts this checkout's src first)
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa

    libs = {"this": kernels.library()}
    kernels.CSRC, kernels._lib = _csrc(other), None
    libs["other"] = kernels.library()
    dev = torch.device("cuda")
    for s in (256, 1024, 4096):
        q, k, v = C._flash_inputs(dev, 16, 16, s, torch.bfloat16, seed=1)
        got = {}
        for name in ("this", "other", "other", "this"):
            kernels._lib = libs[name]
            _, _, ms = C._device_ms(lambda: fa.flash_attention(q, k, v),
                                    symbol="flash_")
            got.setdefault(name, []).append(ms)
        lib_ms = C._device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))[0]
        print(f"flash (1, 16, {s}, 64) bf16 causal: this {got['this']} ms, "
              f"other {got['other']} ms, scaled_dot_product_attention "
              f"{lib_ms:.6f} ms", flush=True)


def run_paths(root: pathlib.Path) -> None:
    """One turn of --paths, in this process: ``root``'s own phases."""
    import torch

    sys.path.insert(0, str(root))
    import chip_smoke as C  # noqa: E402

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    C.kernels.library()
    C.run_main_path(dev)
    C.profile_main_path(dev)
    C.profile_serving(dev, C.run_serving(dev))


def run_serve(root: pathlib.Path) -> None:
    """One turn of --serve, in this process: ``root``'s own phases 8 and
    11."""
    import torch

    sys.path.insert(0, str(root))
    import chip_smoke as C  # noqa: E402

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    C.kernels.library()
    C.profile_serving(dev, C.run_serving(dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--one-turn", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--serve-turn", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--kernel-turn", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--ops-turn", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ops_turn:
        ops_turn(args.other.resolve())
        return 0
    if args.ops:
        for name, root in (("this", ROOT), ("other", args.other.resolve())):
            out = subprocess.run(
                [sys.executable, __file__, str(root), "--ops-turn"],
                capture_output=True, text=True, check=True).stdout
            for line in out.splitlines():
                print(f"[{name}] {line}", flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one_turn:
        run_paths(args.other.resolve())
        return 0
    if args.serve_turn:
        run_serve(args.other.resolve())
        return 0
    if args.kernel_turn:
        kernel_turn(args.other.resolve())
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.flash:
        compare_flash(args.other.resolve())
    turns = (("this", ROOT), ("other", args.other.resolve()),
             ("other", args.other.resolve()), ("this", ROOT))
    if args.kernels:
        for name, root in turns:
            out = subprocess.run(
                [sys.executable, __file__, str(root), "--kernel-turn"],
                capture_output=True, text=True, check=True).stdout
            for line in out.splitlines():
                if line.startswith("kernel-ab"):
                    print(f"[{name}] {line}", flush=True)
    for flag, turn in (("paths", "--one-turn"), ("serve", "--serve-turn")):
        if not getattr(args, flag):
            continue
        keep = ("wall", "profile", "launches", "tokens per second")
        for name, root in turns:
            out = subprocess.run(
                [sys.executable, __file__, str(root), turn],
                capture_output=True, text=True, check=True).stdout
            for line in out.splitlines():
                if any(k in line for k in keep):
                    print(f"[{name}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
