"""Collectives and rank processes of the port's multi-rank paths.

A placement is a world of ``torch.distributed`` ranks, one process per
device, started by ``torchrun`` or by :func:`spawn`.  Where the JAX
package's ``shard_map`` bodies call ``lax.all_gather`` over a mesh axis, the
port calls :func:`all_gather`: every rank's tensors, in rank order.  The
tensors travel as the bytes of one packed buffer, so a call is one
collective whatever their number and types (unsigned codes and booleans
included, which not every backend reduces or gathers as such).

The model functions under a mesh (``repro_torch.parallel.sharding``) call
:func:`all_reduce` (``MAX``, ``SUM`` or ``MIN`` over a group) and the
autograd-aware pair of Megatron's tensor parallelism:
:func:`copy_to_group` (identity forward, ``SUM`` backward: *f*) and
:func:`reduce_from_group` (``SUM`` forward, identity backward: *g*);
:func:`gather_from_group` concatenates every rank's tensor in rank order.
:func:`reduce_scatter` and :func:`sum_ordered` add every rank's tensor in
rank order, whatever the tensors' layout (an ``all_to_all`` and a local
sum, then for the latter an ``all_gather``: the bytes of a ring
all-reduce): the data-axis gradient sum of the train step, so that a
leaf's sum is the same bits whether it is summed whole or block by block
(ZeRO and FSDP).  :func:`gather_block` is FSDP's gather of a parameter
block.  Each collective adds one entry (op, dtype, bytes this rank sends
into it, the group's size) to the lists that :func:`recording` opens.

Nothing here falls back: a rank that is missing or fails raises in its
collective at the process group's timeout, and :func:`spawn` kills the
ranks it started when one fails or the deadline passes.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import pathlib
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.utils.weak

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
    _note("all_gather", torch.uint8, buf.numel(), len(outs))
    dist.all_gather(outs, buf, group=group)
    return [_unpack(o, spec_list) for o in outs]


# ---------------------------------------------------------------------------
# reductions and the tensor-parallel pair
# ---------------------------------------------------------------------------

_RECORDS: List[list] = []


@contextlib.contextmanager
def recording():
    """A list that every collective of this process appends one dict to
    while the context is open: ``op`` (``all_gather``, ``all_reduce.max``,
    ``all_to_all``, ...), ``dtype`` (what travels), ``bytes`` (what this
    rank puts in; an ``all_gather``'s packed buffer) and ``group`` (the
    ranks of the collective)."""
    rec: list = []
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def _note(op: str, dtype: torch.dtype, nbytes: int, group: int) -> None:
    for rec in _RECORDS:
        rec.append({"op": op, "dtype": str(dtype).replace("torch.", ""),
                    "bytes": int(nbytes), "group": int(group)})


def summarize(rec: list) -> dict:
    """A record's bytes summed by ``"op dtype"``, and its call count."""
    out: dict = {}
    for e in rec:
        key = f"{e['op']} {e['dtype']}"
        calls, nbytes = out.get(key, (0, 0))
        out[key] = (calls + 1, nbytes + e["bytes"])
    return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(out.items())}


_OPS = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM,
        "min": dist.ReduceOp.MIN}
# types that no backend reduces, widened exactly for the call: neither
# gloo nor NCCL reduces uint16 (the 16-bit Eq. 7 codes)
_WIDEN = {torch.uint16: torch.int32}


def all_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """``op`` (``"max"``, ``"sum"`` or ``"min"``) of every rank's ``x``
    over ``group``, as a new tensor of ``x``'s type; ``x`` is not
    written.  A type that the backends do not reduce travels widened
    (uint16 as int32); a backend that refuses any other type raises."""
    wide = _WIDEN.get(x.dtype, x.dtype)
    y = x.detach().to(wide).clone()
    _note(f"all_reduce.{op}", wide, y.numel() * y.element_size(),
          dist.get_world_size(group))
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.to(x.dtype)


def _gather_whole(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return torch.cat([p[0] for p in all_gather([x], group)], dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``group`` of every
    rank's ``x``, whose ``dim`` the group's size divides.  The ranks'
    blocks meet in one ``all_to_all`` and are added here in rank order,
    so each element's sum is the same bits however the tensor is laid
    out or cut."""
    n = dist.get_world_size(group)
    rows = x.detach().movedim(dim, 0).contiguous()
    if rows.shape[0] % n:
        raise ValueError(f"{rows.shape[0]} rows over {n} ranks")
    got = torch.empty_like(rows)
    _note("all_to_all", rows.dtype, rows.numel() * rows.element_size(), n)
    dist.all_to_all_single(got, rows, group=group)
    parts = got.chunk(n)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total.movedim(0, dim).contiguous()


def sum_ordered(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``, added in rank order
    (:func:`reduce_scatter` of the flat tensor, then an ``all_gather``):
    the same bits for an element whatever else travels with it."""
    n = dist.get_world_size(group)
    flat = x.detach().reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    whole = _gather_whole(reduce_scatter(flat, group), group, 0)
    return whole[:x.numel()].view(x.shape)


class _Copy(torch.autograd.Function):
    """Identity forward, the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


class _Reduce(torch.autograd.Function):
    """Sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``dim`` in rank order.
    Backward: this rank's slice of the cotangent, summed over the group
    first where the ranks' cotangents differ (``sum_grads``)."""

    @staticmethod
    def forward(ctx, x, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.sum_grads = group, dim, sum_grads
        ctx.size = x.shape[dim]
        return _gather_whole(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = all_reduce(g, "sum", ctx.group)
        at = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, at, ctx.size), None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is, its gradient summed over ``group``
    (the input of a product split over the group's ranks)."""
    return _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: the sum of every rank's ``x`` over ``group``, the
    gradient passed through."""
    return _Reduce.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = 0,
                      sum_grads: bool = False) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``, in rank order.  The cotangent of
    a replicated consumer is the same on every rank and each keeps its
    slice; with ``sum_grads`` (consumers that differ by rank) the slices
    are summed over the group first."""
    return _Gather.apply(x, group, dim % x.ndim, sum_grads)


# ---------------------------------------------------------------------------
# FSDP: a parameter block gathered where it is used
# ---------------------------------------------------------------------------


# each gathered parameter -> (its block, group, dim), for the saved-tensor
# hooks of :func:`regather_saved`
_GATHERED = torch.utils.weak.WeakIdKeyDictionary()


class _GatherBlock(torch.autograd.Function):
    """A parameter's block gathered over its FSDP group.  Backward: this
    rank's block of the cotangent summed over the group where it splits
    the batch (``rows_summed``), or that block alone where no group splits
    the batch (every rank's cotangent is the whole one)."""

    @staticmethod
    def forward(ctx, block, group, dim, rows_summed):
        ctx.group, ctx.dim, ctx.rows_summed = group, dim, rows_summed
        whole = _gather_whole(block, group, dim)
        _GATHERED[whole] = (block.detach(), group, dim)
        return whole

    @staticmethod
    def backward(ctx, g):
        if ctx.rows_summed:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        size = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        at = dist.get_rank(ctx.group) * size
        return g.narrow(ctx.dim, at, size), None, None, None


def gather_block(block: torch.Tensor, group, dim: int,
                 rows_summed: bool) -> torch.Tensor:
    """The whole parameter of which ``block`` is this rank's block along
    ``dim`` over ``group`` (rank order).  Its gradient is this rank's
    block of the whole one, summed over ``group`` where that group splits
    the batch (``rows_summed``): the data-summed gradient, as
    ``train_step.value_and_grad`` gives an unsplit leaf."""
    return _GatherBlock.apply(block, group, dim, rows_summed)


def _pack_saved(t: torch.Tensor):
    whole = t if t in _GATHERED else t._base
    if whole is None or whole not in _GATHERED:
        return t
    return (_GATHERED[whole], t.shape, t.stride(), t.storage_offset())


def _unpack_saved(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    (block, group, dim), shape, stride, offset = packed
    return _gather_whole(block, group, dim).as_strided(shape, stride,
                                                       offset)


def regather_saved():
    """Saved-tensor hooks under which what autograd saves of a gathered
    parameter (the parameter or a view of it) is kept as its block and
    gathered again when the backward reads it: a forward holds no
    parameter it has gathered beyond its use."""
    return torch.autograd.graph.saved_tensors_hooks(_pack_saved,
                                                    _unpack_saved)


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
