"""Hand-written Hopper kernels and their build.

Each kernel package (``ocs_quant``, ``maxpool``, ``ocs_contention``,
``flash_attention``) holds ``ops.py``, the wrapper the port calls, and
``ref.py``, the kernel's plain PyTorch version.  A wrapper runs the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.  Every wrapper
sends a fake tensor (a trace: the dry-run's, the analysis's) through a
``torch.library`` custom op (``repro_torch::<name>``) whose fake impl
gives the kernel's outputs alone.

The CUDA C++ sources live in ``csrc/``.  :func:`library` compiles them at
first use with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all
started together, then one link) into ``build/torch_kernels/`` at the root
of the checkout, and loads the shared library with ``ctypes``.  The library
name carries a hash of the sources, so an edited source rebuilds.  Nothing
is compiled on import: the CPU tests import every module.

Every launch adds one to its kernel's count in :data:`_LAUNCHES`
(:func:`launch_counts`, :func:`reset_launch_counts`), so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

CSRC = pathlib.Path(__file__).with_name("csrc")
SOURCES = ("ocs_quant.cu", "maxpool.cu", "ocs_contention.cu",
           "flash_attention.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

KERNELS = ("ocs_quant.encode", "ocs_quant.decode", "maxpool.fwd",
           "maxpool.decode", "maxpool.winner_bwd", "maxpool.ties_bwd",
           "ocs_contention.contend", "ocs_contention.noisy",
           "flash_attention.fwd")
_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
_ARGTYPES = {
    # (x, out, n, in_bytes, out_bytes, bits, stream)
    "ocs_encode": (_P, _P, _I64, _I, _I, _I, _P),
    # (codes, out, n, code_bytes, out_kind, bits, stream)
    "ocs_decode": (_P, _P, _I64, _I, _I, _I, _P),
    # (h, v, winner, ties, batch, n, e, kind, stream)
    "maxpool_fwd": (_P, _P, _P, _P, _I64, _I, _I64, _I, _P),
    # (src, mask, mask_stride, winner, pooled, max_code, argmax, correct,
    #  batch, n, e, src_kind, out_kind, bits, stream)
    "maxpool_decode": (_P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I, _I64, _I,
                       _I, _I, _P),
    # (winner, g, out, batch, n, e, kind, stream)
    "maxpool_winner_bwd": (_P, _P, _P, _I64, _I, _I64, _I, _P),
    # (ties, g, out, batch, n, e, kind, stream)
    "maxpool_ties_bwd": (_P, _P, _P, _I64, _I, _I64, _I, _P),
    # (word, heard, mask, winner, contending, collided, lanes, n, k,
    #  n_slots, max_rounds, total_bits, mask_lane_stride, stream)
    "ocs_contend": (_P, _P, _P, _P, _P, _P, _I, _I, _I64, _I, _I, _I, _I,
                    _P),
    # (h, h_kind, bits, id_bits, mask, lane_keys, p_keep, p_kind,
    #  p_worker_stride, winner, contending, collided, acct, lanes, n, k,
    #  n_slots, max_rounds, mask_lane_stride, stream)
    "ocs_noisy": (_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                  _I, _I64, _I, _I, _I, _P),
    # (q, k, v, out, batch, heads, kv_heads, sq, sk, head_dim, kind,
    #  causal, scale, stream)
    "flash_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_seconds: Optional[float] = None


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "GPU machine with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + ("common.cuh",):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile ``csrc/*.cu`` (in parallel) and link one shared library.

    Returns the library's path; a library already built from the same
    sources is reused.  The compiler's output goes to ``build.log``."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / f"libreprotorch_{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    procs, objs = [], []
    for name in SOURCES:
        obj = build_dir / f"{pathlib.Path(name).stem}.{tag}.o"
        objs.append(obj)
        procs.append((name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for name, p in procs:
        out, _ = p.communicate()
        log.append(f"== {name} (rc={p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(name)
    (build_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = build_dir / f"{lib_path.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True, check=False)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    with _lib_lock:
        if _lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _ARGTYPES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            build_seconds = time.perf_counter() - t0
            _lib = lib
        return _lib


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call kernel entry ``fn`` on ``device``'s current stream; raise on a
    CUDA error; count the launch under ``name``.  The library's runtime
    launches on the current device: a rank of a job over several cards
    sets its own with ``torch.cuda.set_device``."""
    current = torch.cuda.current_device()
    if device.index not in (None, current):
        raise ValueError(f"the kernels run on the current device "
                         f"cuda:{current}, got {device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(library(), fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")
    _LAUNCHES[name] += 1


def check_cuda(*tensors: torch.Tensor) -> None:
    """A kernel's tensors lie on one CUDA device (a fake one too: a custom
    op's fake impl stands for the kernel in a trace)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"a kernel takes CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")


def check_operands(*tensors: torch.Tensor) -> None:
    """A kernel's tensors lie on one CUDA device and are contiguous."""
    check_cuda(*tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


# dtype tags of csrc/common.cuh (rt::Kind)
KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
        torch.uint8: 3, torch.uint16: 4}
