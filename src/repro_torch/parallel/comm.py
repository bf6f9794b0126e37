"""Collectives and rank processes of the port's multi-rank paths.

A placement is a world of ``torch.distributed`` ranks, one process per
device, started by ``torchrun`` or by :func:`spawn`.  Where the JAX
package's ``shard_map`` bodies call ``lax.all_gather`` over a mesh axis, the
port calls :func:`all_gather`: every rank's tensors, in rank order.  The
tensors travel as the bytes of one packed buffer, so a call is one
collective whatever their number and types (unsigned codes and booleans
included, which not every backend reduces or gathers as such).

Nothing here falls back: a rank that is missing or fails raises in its
collective at the process group's timeout, and :func:`spawn` kills the
ranks it started when one fails or the deadline passes.
"""

from __future__ import annotations

import datetime
import math
import os
import pathlib
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# every packed tensor starts on this many bytes, so a gathered segment can
# be viewed as its type in place
_ALIGN = 8

Spec = Tuple[Tuple[int, ...], torch.dtype]


def initialized() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default process group; 1 without one."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if initialized() else 0


def _specs(tensors: Sequence[torch.Tensor]) -> List[Spec]:
    return [(tuple(t.shape), t.dtype) for t in tensors]


def _nbytes(spec: Spec) -> int:
    shape, dtype = spec
    return math.prod(shape) * dtype.itemsize


def _offsets(spec_list: Sequence[Spec]) -> Tuple[List[int], int]:
    offs, at = [], 0
    for s in spec_list:
        offs.append(at)
        at += -(-_nbytes(s) // _ALIGN) * _ALIGN
    return offs, at


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes in one uint8 buffer, each at an aligned offset."""
    offs, total = _offsets(_specs(tensors))
    buf = torch.zeros((total,), dtype=torch.uint8, device=tensors[0].device)
    for t, at in zip(tensors, offs):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        buf[at:at + raw.numel()].copy_(raw)
    return buf


def _unpack(buf: torch.Tensor, spec_list: Sequence[Spec]
            ) -> List[torch.Tensor]:
    """:func:`_pack`'s tensors back, as views of ``buf``."""
    offs, _ = _offsets(spec_list)
    return [buf[at:at + _nbytes(s)].view(s[1]).reshape(s[0])
            for s, at in zip(spec_list, offs)]


def all_gather(tensors: Optional[Sequence[torch.Tensor]], group=None, *,
               spec_list: Optional[Sequence[Spec]] = None,
               device=None) -> List[List[torch.Tensor]]:
    """Every rank's ``tensors`` in group-rank order: ``out[r][i]`` is rank
    ``r``'s ``i``-th tensor.  One collective over ``group`` (the default
    group for ``None``).

    The ranks pass tensors of the same shapes and types.  A rank that holds
    none passes ``None`` with their ``spec_list`` (``(shape, dtype)`` of
    each) and the ``device`` of the others' tensors; what it sends is
    dropped by the caller.
    """
    if tensors is None:
        if spec_list is None:
            raise ValueError("a rank without tensors passes their spec_list")
        buf = torch.zeros((_offsets(spec_list)[1],), dtype=torch.uint8,
                          device=device)
    else:
        spec_list = _specs(tensors)
        buf = _pack(tensors)
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, buf, group=group)
    return [_unpack(o, spec_list) for o in outs]


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------

def _rank_main(local: int, world: int, store: str, timeout: float,
               threads: int, fn: Callable, args: tuple, kwargs: dict,
               workdir: str) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=local,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(*args, **kwargs)
        torch.save(out, os.path.join(workdir, f"rank{local}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (),
          kwargs: Optional[dict] = None, *, workdir, timeout: float = 60.0,
          threads: int = 1) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` in ``world`` new processes, rank ``r``
    of a fresh gloo process group in process ``r``; return what each rank
    returned, in rank order.

    ``fn`` is a module-level function (the ``spawn`` start method pickles
    it by name).  The group meets in a ``FileStore`` under ``workdir``,
    where each rank also saves its result, and its collectives time out
    after ``timeout`` seconds.  A rank that raises fails the call; the
    ranks still running after twice ``timeout`` are killed and the call
    raises ``TimeoutError``.  Each rank runs ``threads`` intra-op CPU
    threads.
    """
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    if store.exists():
        raise ValueError(f"{store} exists: each spawn needs a fresh workdir")
    limit = time.monotonic() + 2 * timeout
    ctx = mp.spawn(_rank_main, nprocs=world, join=False,
                   start_method="spawn",
                   args=(world, str(store), timeout, threads, fn,
                         tuple(args), dict(kwargs or {}), str(work)))
    try:
        while not ctx.join(timeout=max(0.0, limit - time.monotonic())):
            if time.monotonic() >= limit:
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} still "
                    f"running after the deadline; killed")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
