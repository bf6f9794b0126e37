"""The multi-pod dry-run (the JAX package's ``launch/dryrun.py``).

For every (architecture x input shape x mesh) cell, this builds the
port's real step (the train step with the AdamW update, a prefill, or a
decode step) at the production mesh's placements and traces one rank's
run of it on fake tensors, so that nothing is allocated and no kernel
runs.  The mesh is a fake process group of 256 or 512 ranks
(:func:`fake_world`), this process its rank 0.  The trace counts:

- FLOPs, with ``FlopCounterMode`` (matrix products: tensor-core work; the
  flash kernel's custom op by its own formula);
- HBM bytes, each op's inputs and outputs (:class:`ByteCounter`): what
  eager mode moves;
- collectives, from ``comm.recording`` (``hlo_analysis.collective_stats``);
- memory: the arguments' bytes (parameters, optimizer state and batch),
  and the peak by category (``MemTracker``).

Placements, as the JAX dry-run's: the parameters split over the model
axis (the logical rules of ``launch/mesh.rules_for``), the AdamW master
and moments also over ``fsdp`` (ZeRO), and the parameters too where the
model axis alone leaves more than :data:`FSDP_PARAM_BYTES` a rank (FSDP).
Every rank passes the whole batch (the port's contract; its rows are
split inside), and a decode step its block of the cache, as the JAX
dry-run's ``cache_sh`` places it: its rows where the batch axis splits
them, its ``kv_seq`` block under the long-context rules
(``model.cache_init`` under the mesh).  The port runs every
period, so the counts are exact; :func:`_scaled_variants` still runs on
the single-pod cells, and the record holds its two-point figures beside
the exact ones.

A cell traces on the device it models (``--device``, ``cuda`` by
default, which needs the card's torch); the CPU tests trace fake CPU
tensors.  The kind of trace is written into the record.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k \\
      --device cpu --multi-pod
  python -m repro_torch.launch.dryrun --all --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models import model as M
from repro_torch.optim import optimizers, schedules
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.train.train_step import make_train_step

# activation-memory control: grad-accumulation microbatches per train cell
TRAIN_MICROBATCHES = {
    "jamba-1.5-large-398b": 8,
    "qwen2.5-32b": 2,
    "llama4-scout-17b-a16e": 2,
}
# FSDP threshold: split the parameters over the fsdp axes too when the
# plain TP layout leaves more than this many bytes a rank (jamba-398B)
FSDP_PARAM_BYTES = 8 << 30
# the blocks of flash_attention's contract, which a sequence must fill
FLASH_BLOCK = 128


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A ``"fake"`` process group of ``size`` ranks, this process rank
    ``rank``: its collectives return at once and move nothing.  Destroyed
    on exit, so that nothing stays initialised for later code."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry-run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch lacks") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _block_bytes(values, shardings) -> int:
    """The bytes of this rank's blocks of the whole leaves ``values``."""
    return sum(math.prod(sh.block_shape(v.shape, s.spec, s.mesh))
               * v.dtype.itemsize
               for v, s in zip(tree.leaves(values),
                               sh.flat_shardings(shardings)))


def _fake_like(spec: torch.Tensor, device) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def _prefill_len(cfg, shape):
    if cfg.encoder_decoder:
        return min(M.WHISPER_DECODER_LEN, shape.seq_len)
    return shape.seq_len


def _microbatches(arch: str, shape_name: str,
                  overrides: Optional[Dict[str, Any]]) -> int:
    return (overrides or {}).get(
        "microbatches",
        TRAIN_MICROBATCHES.get(arch, 1) if shape_name == "train_4k" else 1)


def _split_kv_seq(cfg, rules, mesh) -> bool:
    """Whether the rules split a decode cache's ``kv_seq`` over ranks."""
    with sh.use_mesh(mesh, rules):
        if sh.kv_seq_axis() is None:
            return False
    found = []
    sh.map_axes(lambda ax: found.append("kv_seq" in ax), M.cache_axes(cfg))
    return any(found)


def build_cell(arch: str, shape_name: str, mesh, tp_fusion: str = "max",
               overrides: Optional[Dict[str, Any]] = None,
               device="cuda"):
    """Returns ``(step, args, cfg, rules, info)`` of a production cell:
    :func:`build_step` of the arch's config (16 workers, the flash kernel
    where the cell's sequences fill its blocks) at the shape, on ``mesh``
    under :func:`launch.mesh.rules_for`'s rules."""
    shape = SHAPES[shape_name]
    overrides = dict(overrides or {})
    microbatches = _microbatches(arch, shape_name, overrides)
    overrides.pop("microbatches", None)
    cfg = get_config(arch, n_workers=16, tp_fusion=tp_fusion, **overrides)
    if "use_flash" not in overrides:
        # the flash kernel's path, as the port trains and serves on the
        # card, where the cell's sequences fill its blocks (whisper's
        # 448-token decoder does not: the plain path)
        cfg = cfg.with_(use_flash=_prefill_len(cfg, shape) % FLASH_BLOCK
                        == 0)
    rules = rules_for(shape_name, shape.global_batch, mesh)
    step, args, info = build_step(cfg, shape, mesh, rules, microbatches,
                                  device)
    return step, args, cfg, rules, info


def place(m, whole, mesh, rules, optimizer=None) -> Dict[str, Any]:
    """The dry-run's placements of the whole parameters ``whole`` (real
    or fake tensors) on ``mesh`` (``sharding.placement``, with FSDP where
    the model axis alone leaves more than :data:`FSDP_PARAM_BYTES` a
    rank): ``values``, this rank's blocks, ``leaf_shardings``, theirs in
    leaf order, and ``fsdp``.  With ``optimizer`` (AdamW) also ``state``,
    its state of ``whole`` with master, m and v split over the fsdp axis
    as well (ZeRO), and ``state_shardings``."""
    axes = m.axes()
    # FSDP for very large models: TP alone leaves too many bytes per rank
    fsdp = _block_bytes(whole, sh.tree_shardings_for_values(
        axes, whole, mesh, rules)) > FSDP_PARAM_BYTES
    pl = sh.placement(axes, whole, mesh, rules, fsdp=fsdp)
    out = {"values": sh.shard_values(whole, pl.axes, mesh, rules),
           "leaf_shardings": sh.flat_shardings(pl.shardings), "fsdp": fsdp}
    if optimizer is not None:
        state = optimizer.init(whole)
        for k in ("master", "m", "v"):
            state[k] = sh.shard_values(state[k], pl.state_axes, mesh, rules)
        out["state"] = state
        out["state_shardings"] = sh.flat_shardings(pl.state_shardings)
    return out


def build_step(cfg, shape, mesh, rules, microbatches: int = 1,
               device="cuda", inputs: Optional[Dict[str, Any]] = None):
    """Returns ``(step, args, info)``: ``step()`` runs this rank's step of
    ``cfg`` at ``shape`` (a ``ShapeConfig``) on ``args`` (the parameters'
    blocks, the optimizer state's, the batch), all fake tensors on
    ``device``, placed by :func:`place`.  ``inputs`` (anything with
    shapes and types) stands for ``input_specs(shape)`` of a train or
    prefill step.  Call it, and the step, under a ``FakeTensorMode`` and a
    world of the mesh's size.  ``info`` holds the config, whether FSDP
    splits the parameters and how many microbatches a train step
    takes."""
    m = M.build(cfg)
    whole = tree.map(lambda t: t.to(device),
                     m.init(torch.Generator().manual_seed(0)))
    train = shape.kind == "train"
    opt = optimizers.adamw(schedules.constant(1e-4)) if train else None
    placed = place(m, whole, mesh, rules, opt)
    del whole
    values, leaf_sh = placed["values"], placed["leaf_shardings"]
    specs, _ = m.input_specs(shape)
    if inputs is not None:
        specs = inputs
    info = {"cfg": cfg, "fsdp": placed["fsdp"],
            "microbatches": microbatches,
            "split_kv_seq": _split_kv_seq(cfg, rules, mesh)}

    if train:
        state, state_sh = placed["state"], placed["state_shardings"]
        batch = {k: _fake_like(v, device) for k, v in specs.items()}
        train_step = make_train_step(m.loss, opt, microbatches=microbatches)

        def step():
            with sh.use_mesh(mesh, rules), \
                    sh.use_leaf_shardings(leaf_sh, state=state_sh):
                return train_step(values, state, batch)
        return step, (values, state, batch), info

    if shape.kind == "prefill":
        batch = {k: _fake_like(v, device) for k, v in specs.items()}
        max_seq = _prefill_len(cfg, shape)

        def step():
            with sh.use_mesh(mesh, rules), sh.use_leaf_shardings(leaf_sh):
                return m.prefill(values, batch, max_seq=max_seq)
        return step, (values, batch), info

    if shape.kind != "decode":
        raise ValueError(shape.kind)
    token = _fake_like(specs["token"], device)
    positions = _fake_like(specs["positions"], device)
    # the cache as the engine makes it under the mesh: the rank's rows,
    # its kv_seq block, its share of the workers
    with sh.use_mesh(mesh, rules):
        cache = m.cache_init(
            shape.global_batch, shape.seq_len, device=device,
            cross_len=shape.seq_len if cfg.encoder_decoder else 0)
    info["cache_bytes"] = sum(t.numel() * t.element_size()
                              for t in tree.leaves(cache))

    def step():
        with sh.use_mesh(mesh, rules), sh.use_leaf_shardings(leaf_sh):
            return m.decode_step(values, token, positions, cache)
    return step, (values, token, positions, cache), info


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

# ops that move no tensor's bytes: allocations, metadata reads
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_contiguous", "is_same_size",
         "_local_scalar_dense")
# in-place ops that write a few rows of their first argument: they move
# their other tensors' bytes and write as many as their largest one
_SPARSE_WRITES = ("index_put_", "_index_put_impl_", "scatter_",
                  "scatter_add_", "scatter_reduce_", "index_add_",
                  "index_copy_", "index_fill_", "masked_scatter_")


def _unique_tensors(tree_) -> Dict[int, torch.Tensor]:
    return {id(t): t for t in tree_flatten(tree_)[0]
            if isinstance(t, torch.Tensor)}


class ByteCounter(TorchDispatchMode):
    """The bytes each op reads and writes: its tensor inputs and outputs,
    each once (an in-place op's tensor once, a tensor passed twice once);
    an in-place scatter into a few rows of a tensor, its other operands
    and the rows it writes.  Views, allocations, metadata reads and
    collectives count nothing (the collectives are counted apart)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if (func.is_view or name in _FREE or func.namespace in
                ("prim", "c10d", "_c10d_functional")):
            return out
        if name in _SPARSE_WRITES:
            rest = _unique_tensors((args[1:], kwargs))
            rest.pop(id(args[0]), None)
            sizes = [t.numel() * t.element_size() for t in rest.values()]
            self.bytes += sum(sizes) + max(sizes, default=0)
            return out
        self.bytes += sum(t.numel() * t.element_size() for t in
                          _unique_tensors((args, kwargs, out)).values())
        return out


def _by_device(leaves) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for t in leaves:
        out[t.device.type] = out.get(t.device.type, 0) \
            + t.numel() * t.element_size()
    return out


def _count(step, args) -> Dict[str, Any]:
    """One traced run of ``step``: FLOPs, HBM bytes, collective records,
    argument bytes and the memory peak."""
    from torch.distributed._tools.mem_tracker import MemTracker
    leaves = [t for t in tree.leaves(args) if isinstance(t, torch.Tensor)]
    tracker = MemTracker()
    tracker.track_external(*leaves)
    t0 = time.perf_counter()
    with comm.recording() as rec, tracker, ByteCounter() as hbm, \
            FlopCounterMode(display=False) as flops:
        step()
    peak = {torch.device(dev).type: {getattr(k, "value", str(k)): int(v)
                                     for k, v in cats.items()}
            for dev, cats in tracker.get_tracker_snapshot("peak").items()}
    return {
        "trace_s": time.perf_counter() - t0,
        "flops": float(flops.get_total_flops()),
        "hbm_bytes": float(hbm.bytes),
        "records": list(rec),
        "coll": hlo_analysis.collective_stats(rec),
        "argument_bytes": sum(t.numel() * t.element_size()
                              for t in leaves),
        "argument_bytes_by_device": _by_device(leaves),
        "argument_tensors": len(leaves),
        "peak": peak,
    }


def trace(build, *args, **kwargs) -> Dict[str, Any]:
    """``build(*args, **kwargs)`` (:func:`build_cell` or
    :func:`build_step`) under a ``FakeTensorMode``, and :func:`_count` of
    its step: the readings, with the cell's ``info``.  Call it inside a
    world of the mesh's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        built = build(*args, **kwargs)
        got = _count(built[0], built[1])
    got["info"] = built[-1]
    return got


def _scaled_variants(cfg, microbatches: int
                     ) -> Optional[Dict[str, Any]]:
    """The JAX package's scan-cost extrapolation variants: the cell at 1
    period (B) and at 2 (C), unrolled, at one microbatch, and the
    two-point rule ``B + (n_periods - 1) * (C - B)`` per metric.  The port
    counts every period and every microbatch of the real cell, so the
    rule is a cross-check here: it is exact for FLOPs, and for link
    bytes at one microbatch (the port sums the gradients over the data
    group once a microbatch)."""
    period = cfg.period
    n = cfg.n_periods
    if n <= 1 and not cfg.encoder_decoder and microbatches == 1:
        return None
    enc1 = len(cfg.encoder_layer_plan()) if cfg.encoder_decoder else 0
    over_b = {"n_layers": period, "scan_layers": False, "microbatches": 1}
    over_c = {"n_layers": 2 * period, "scan_layers": False,
              "microbatches": 1}
    if cfg.encoder_decoder:
        n_enc = cfg.n_encoder_layers // enc1
        assert n_enc == n, "enc/dec trip counts must match for extrapolation"
        over_b["n_encoder_layers"] = enc1
        over_c["n_encoder_layers"] = 2 * enc1
    return {"b": over_b, "c": over_c, "n_periods": n,
            "microbatches": microbatches}


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D per generated/prefilled token."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch          # one token per sequence
    return 2.0 * n_active * tokens


def _memory(got) -> Dict[str, Any]:
    peak = {dev: cats for dev, cats in got["peak"].items()
            if cats.get("Total", 0)}
    total = max((cats.get("Total", 0) for cats in peak.values()), default=0)
    return {"argument_size_in_bytes": got["argument_bytes"],
            "argument_bytes_by_device": got["argument_bytes_by_device"],
            "argument_tensors": got["argument_tensors"],
            "peak_bytes": total,
            "temp_size_in_bytes": total - got["argument_bytes"],
            "peak_by_category": peak}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             tp_fusion: str = "max",
             overrides: Optional[Dict[str, Any]] = None,
             extrapolate: bool = True, device="cuda") -> Dict[str, Any]:
    """One cell's record, with the JAX record's field names."""
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(get_config(arch), shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "tp_fusion": tp_fusion,
        "trace": f"fake-{torch.device(device).type}",
    }
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        return record
    n_chips = 512 if multi_pod else 256
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod)
            full = trace(build_cell, arch, shape_name, mesh, tp_fusion,
                         overrides, device)
            cfg = full["info"]["cfg"]
            extrap_info = None
            cell_mb = _microbatches(arch, shape_name, overrides)
            variants = (_scaled_variants(cfg, cell_mb) if extrapolate
                        else None)
            if variants is not None:
                ov = dict(overrides or {})
                ov.pop("microbatches", None)
                b, c = (trace(build_cell, arch, shape_name, mesh,
                              tp_fusion, {**ov, **variants[k]}, device)
                        for k in ("b", "c"))
                n = variants["n_periods"]

                def metric(rec, key):
                    return (rec["coll"].link_bytes if key == "link"
                            else rec[key])

                def extrap(key):
                    vb, vc = metric(b, key), metric(c, key)
                    return vb + (n - 1) * max(vc - vb, 0.0)

                extrap_info = {
                    "n_periods": n,
                    "microbatches": variants["microbatches"],
                    "period_flops": metric(c, "flops") - metric(b, "flops"),
                    "period_link_bytes": (metric(c, "link")
                                          - metric(b, "link")),
                    "collective_counts_2p": c["coll"].counts,
                    "flops_2p": extrap("flops"),
                    "hbm_bytes_2p": extrap("hbm_bytes"),
                    "link_bytes_2p": extrap("link"),
                }
        flops = full["flops"]
        link_bytes = full["coll"].link_bytes
        terms = hlo_analysis.roofline_terms(flops, full["hbm_bytes"],
                                            link_bytes)
        model_flops = _model_flops(cfg, shape)
        record.update({
            "status": "ok",
            "lower_s": round(full["trace_s"], 1),
            "compile_s": None,
            "n_chips": n_chips,
            "use_flash": cfg.use_flash,
            "fsdp": full["info"]["fsdp"],
            "microbatches": full["info"]["microbatches"],
            "split_kv_seq": full["info"]["split_kv_seq"],
            "memory": dict(_memory(full), cache_bytes=full["info"].get(
                "cache_bytes")),
            "cost_raw_scanned": {"flops": flops,
                                 "bytes accessed": full["hbm_bytes"]},
            "flops_per_dev": flops,
            "hbm_bytes_per_dev": full["hbm_bytes"],
            "collectives": {
                "counts": full["coll"].counts,
                "payload_bytes": full["coll"].payload_bytes,
                "link_bytes_per_dev": link_bytes,
                "by_op": comm.summarize(full["records"]),
            },
            "extrapolation": extrap_info,
            "roofline": terms,
            "model_flops_global": model_flops,
            "useful_flops_ratio": (
                model_flops / (flops * n_chips) if flops else None),
            "params": cfg.param_count(),
            "params_active": cfg.param_count(active_only=True),
        })
    except Exception as e:          # a cell's failure is its record
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=20)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--fusion", default="max",
                    help="tp_fusion mode (paper technique = max)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="skip the 1p/2p extrapolation cross-check")
    ap.add_argument("--device", default="cuda",
                    help="the device whose fake tensors the trace runs on")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}__{args.fusion}"
            # multi-pod cells prove the placements; the roofline is
            # single-pod's
            extrap = not (args.no_extrapolate or mp)
            rec = run_cell(arch, shape, mp, tp_fusion=args.fusion,
                           extrapolate=extrap, device=args.device)
            path = os.path.join(args.out, tag + ".json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f" trace={rec['lower_s']}s "
                         f"bottleneck={r['bottleneck']} "
                         f"tc={r['t_compute_s']:.3e} tm={r['t_memory_s']:.3e} "
                         f"tl={r['t_collective_s']:.3e} "
                         f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB")
            elif status == "error":
                extra = " " + rec["error"][:200]
            print(f"[{status:7s}] {tag}{extra}", flush=True)


if __name__ == "__main__":
    main()
