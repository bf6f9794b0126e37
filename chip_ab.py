"""Compare this checkout of the port with another on one NVIDIA GPU, in
turns (this, other, other, this), so that both see the same card and host.

    python3 chip_ab.py OTHER --flash     # the flash forward's device time
    python3 chip_ab.py OTHER --kernels   # the channel kernels' device time
    python3 chip_ab.py OTHER --paths     # the curves and serving paths

``OTHER`` is the root of another checkout (the parent commit unpacked with
``git archive``, say) or a directory that holds another version of
``src/repro_torch/kernels/csrc``.

``--flash``: both checkouts' kernel libraries loaded in one process; the
device time per call of ``flash_attention.fwd`` alone (profiler) at
(1, 16, S, 64) bf16 causal, S 256, 1024 and 4096, and that of
``scaled_dot_product_attention`` beside.

``--kernels``: both checkouts' kernel libraries loaded in one process; the
device time per call of each channel kernel alone (profiler) at the
curves' shape (4 lanes x 4 workers x 4096, bits 8, float32) and serving's
(1 x 16 x 8192, bits 8, bfloat16), for every kernel both libraries have.

``--paths``: each turn a fresh process that runs the checkout's own
``chip_smoke.py`` phases 5, 7, 8 and 11 (``run_curves`` at the
fedocs-cifar width, its 10-step profile, serving qwen1.5-0.5b at full
width, its 10-tick profile) and prints their lines.

Exits non-zero without a GPU; imports nothing of JAX.
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


def _load(csrc: pathlib.Path):
    """Build and load the kernel library of ``csrc``, binding the entries
    it has (another checkout may lack a newer one)."""
    import ctypes

    from repro_torch import kernels

    kernels.CSRC = csrc
    lib = ctypes.CDLL(str(kernels.build()))
    for fn, argtypes in kernels._ARGTYPES.items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes, f.restype = argtypes, ctypes.c_int
    return lib


def compare_kernels(other: pathlib.Path) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as C  # noqa: E402  (puts this checkout's src first)
    from repro_torch import kernels

    csrc = kernels.CSRC
    libs = {"this": _load(csrc), "other": _load(_csrc(other))}
    kernels.CSRC, kernels._lib = csrc, libs["this"]
    dev = torch.device("cuda")
    shapes = {"curves": dict(lanes=C.LANES, cols=C.B * C.K),
              "serve": dict(lanes=1, cols=C.SERVE_SLOTS * C.QWEN_D,
                            n=C.QWEN_WORKERS, dtype=torch.bfloat16,
                            p_miss=(0.05,))}
    entry = {"maxpool.fwd": "maxpool_fwd", "maxpool.decode": "maxpool_decode",
             "ocs_quant.decode": "ocs_decode", "ocs_quant.encode": "ocs_encode"}
    for what, kw in shapes.items():
        cases = [(name, launch) for name, launch, *_ in C._kernel_cases(
            dev, bits=8, seed=0, **kw) if name in entry]
        # the ideal lane's form: no mask, no winner, the first argmax
        dtype = kw.get("dtype", torch.float32)
        codes = C._contention_operands(dev, kw["lanes"], kw.get("n", C.N),
                                       kw["cols"], 8, 0, dtype,
                                       (0.0,) * kw["lanes"])[1]
        cases.append(("maxpool.decode", lambda codes=codes, dtype=dtype:
                      C.mp_ops.maxpool_decode(codes, 8, dtype, argmax=True)))
        for i, (name, launch) in enumerate(cases):
            if not all(hasattr(lib, entry[name]) for lib in libs.values()):
                continue
            form = " (ideal form)" if i == len(cases) - 1 else ""
            got = {}
            for turn in ("this", "other", "other", "this"):
                kernels._lib = libs[turn]
                got.setdefault(turn, []).append(
                    C._device_ms(launch, symbol=C.SYMBOLS[name])[2])
            print(f"{name}{form} {what}: this {got['this']} ms, other "
                  f"{got['other']} ms", flush=True)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--one-turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one_turn:
        run_paths(args.other.resolve())
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.flash:
        compare_flash(args.other.resolve())
    if args.kernels:
        compare_kernels(args.other.resolve())
    if args.paths:
        keep = ("wall", "profile", "launches", "tokens per second")
        for name, root in (("this", ROOT), ("other", args.other.resolve()),
                           ("other", args.other.resolve()), ("this", ROOT)):
            out = subprocess.run(
                [sys.executable, __file__, str(root), "--one-turn"],
                capture_output=True, text=True, check=True).stdout
            for line in out.splitlines():
                if any(k in line for k in keep):
                    print(f"[{name}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
