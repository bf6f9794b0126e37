"""The channel engines and the dense LM's meshes over NCCL ranks on several
GPUs, one rank a card:

    torchrun --standalone --nproc-per-node 4 chip_ranks.py

Each rank sets its own card, rank 0 builds the kernels and the others load
them.  For ``run_curves`` at ``chip_smoke.py`` phase 5's config, phase 16's
sweep grid and ``run_curves_dp`` at phase 17's settings, the one-rank run
(``n_devices=1``: rank 0 computes, the others receive the result) is the
reference, and the placements over 2 ranks and over the whole world must
equal it in every field, bitwise, on every rank.  Each rank prints its
card, each placement's wall seconds and its ``ocs_contention.noisy``
launches.

Then qwen1.5-0.5b at full width and depth (bf16, seed-0 weights,
``tp_fusion="max"``, flash) on the (1 x 4), (2 x 2) and (4 x 1) meshes of
the four ranks: 3 of ``chip_smoke.py`` phase 18's train steps, the losses
and step 1's gathered gradient norm held to every rank's own one-card
run of them within phase 34's tolerances; phase 34's serving traffic (4 of
phase 8's requests under OCS p 0.05), whose agreement with the one-card
run in tokens, channel slots and uplink bits is printed (a product over
fewer heads or fewer of a tick's rows does not always round as the whole
one); and the float32 logits of a prefill of 8 of phase 8's prompts and
2 greedy decode steps, whose largest difference from the one-card run's
over their largest magnitude must be within phase 34's
``TP_LOGITS_RTOL``, which phase 34's control fault (one worker's partial
lost at the last MLP site) must exceed.  Each rank prints its walls and
its collective bytes a step and a tick.

Then ``chip_smoke.py`` phase 35's trainers over the four cards, each held
to every rank's own one-card run under phase 35's limits (step 1's loss
by ``_tpm_loss_held``, its gathered gradient norm within
``TP_GRAD_NORM_RTOL``, later losses within ``TP_LOSS_RTOL``):
qwen3-moe-30b-a3b cut to 4 of 48 layers on (1 x 4), 32 of 128 experts a
card, and on (2 x 2), where the router's load-balancing loss sums its
expert means and counts over the data axis and must equal the whole
batch's; xlstm-125m's first period and whisper-base on (1 x 4) and (2 x
2).

Then the split placements of state and the pipeline (``--parts
long_context pipeline`` runs these alone): jamba-1.5-large's
``chip_smoke.py`` phase-27 period (4 of 16 experts, bf16) on (4 x 1)
under ``launch.mesh.rules_for("long_500k")``, with a 64-token prompt and
8 greedy ticks under OCS p 0.05, into a 524,288-position KV cache (each
card holds its 131,072-position block, 0.5 GiB of KV; the prompt and the
ticks lie in card 0's block) and into a 128-position boundary cache
(32 positions a card: the keys lie in three cards' blocks), each held
to every rank's own one-card run of the whole cache.  The float32
weights of the period do not fit a card, so the bf16 logits are held:
their largest difference over their largest magnitude within
:data:`LONG_LOGITS_RTOL`, which the boundary run's control fault (card
1 keeps its own block's softmax denominators, ``chip_smoke.py`` phase
39's) must exceed.  Tokens and channel slots are printed: the split
softmax sums float32 partial products over the cards, so it is not
bitwise the whole cache's bf16 product, and the logits' limit is the
check.  Then ``parallel/pipeline.gpipe`` over the four NCCL ranks, one
stage a card, forward and gradient against ``sequential_reference`` on
each card.

The exit code is 1 if a check fails.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.optim.compressed_allreduce import (  # noqa: E402
    CompressedAllReduce)
from repro_torch.parallel import comm  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

LM_MESHES = ((1, 4), (2, 2), (4, 1))


def _lm_train(dev, mesh=None):
    """(losses, gathered gradient norms, wall, collective bytes a step,
    host seconds of each step) of 3 of phase 18's steps, on this rank's
    blocks of ``mesh`` or on the whole card."""
    run = cs._tp_train_run(dev)
    shd = None
    if mesh is not None:
        axes = run.m.axes()
        shd = sharding.tree_shardings_for_values(axes, run.values, mesh)
        run.values = sharding.shard_values(run.values, axes, mesh)
    ctx = sharding.use_mesh(mesh) if mesh is not None else None
    with comm.recording() as rec:
        if ctx is None:
            res, _, wall = cs._counted(lambda: cs.trainer.train(
                run.m.loss, run.values, run.opt, run.data, run.tcfg))
        else:
            with ctx:
                res, _, wall = cs._counted(lambda: cs.trainer.train(
                    run.m.loss, run.values, run.opt, run.data, run.tcfg,
                    shardings=shd))
    return ([r["loss"] for r in res.history],
            [r["grad_norm"] for r in res.history], wall,
            {k: v["bytes"] / cs.TP_STEPS
             for k, v in comm.summarize(rec).items()},
            [round(r["step_time_s"], 4) for r in res.history])


def _lm_serve(dev, mesh=None):
    """(results by request, wall, ticks, collective bytes a tick) of phase
    34's serving traffic."""
    m, values = cs._tp_serve_model(dev)
    if mesh is None:
        got, _, wall, ticks, _ = cs._tp_serve(m, values, dev)
        return got, wall, ticks, {}
    values = sharding.shard_values(values, m.axes(), mesh)
    with sharding.use_mesh(mesh), comm.recording() as rec:
        got, _, wall, ticks, _ = cs._tp_serve(m, values, dev)
    return got, wall, ticks, {k: v["bytes"] / ticks
                              for k, v in comm.summarize(rec).items()}


def _lm_logits(dev, mesh=None, lost=False) -> torch.Tensor:
    """float32 logits of a prefill of 8 of phase 8's prompts and of 2
    greedy decode steps after it, (3 x 8, V) on the CPU; with ``lost``
    those of phase 34's control fault (``chip_smoke._lost_partial``)."""
    m, values = cs._tp_serve_model(dev, torch.float32)
    if lost:
        values = cs._lost_partial(values)
    reqs = cs.poisson_requests(cs.SERVE_REQUESTS, cs.SERVE_RATE,
                               m.cfg.vocab_size, prompt_len=cs.SERVE_PROMPT,
                               max_new_tokens=cs.SERVE_NEW, seed=0)
    prompts = torch.as_tensor(np.stack(
        [np.asarray(r.prompt, np.int32) for r in reqs[:cs.SERVE_SLOTS]]),
        device=dev)
    if mesh is not None:
        values = sharding.shard_values(values, m.axes(), mesh)
    with (sharding.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        logits, cache = m.prefill(values, {"tokens": prompts},
                                  max_seq=cs.SERVE_PROMPT + 2)
        seq = [logits]
        pos = torch.full((cs.SERVE_SLOTS,), cs.SERVE_PROMPT,
                         dtype=torch.int32, device=dev)
        for t in range(2):
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            logits, cache = m.decode_step(values, tok, pos + t, cache)
            seq.append(logits)
    return torch.cat(seq).float().cpu()


def lm_meshes(rank: int, world: int) -> int:
    """The LM meshes against this rank's one-card runs; the number of
    failed checks.  Every reading is printed before it is held to its
    limit."""
    dev = torch.device("cuda")
    one_losses, one_gn, one_wall, _, one_steps = _lm_train(dev)
    one_serve, one_swall, one_ticks, _ = _lm_serve(dev)
    one_logits = _lm_logits(dev)
    ctl = cs._logits_rel_err(_lm_logits(dev, lost=True), one_logits)
    print(f"rank {rank}/{world} one card: train {one_wall:.3f} s (steps "
          f"{one_steps}) losses {one_losses}, gradient norms {one_gn}; "
          f"serve {one_swall:.3f} s, {one_ticks} ticks; max|logit| "
          f"{float(one_logits.abs().max()):.4g}; logits control (worker "
          f"0's last MLP partial lost) {ctl:.4g} of max|logit| (must "
          f"exceed {cs.TP_LOGITS_RTOL})", flush=True)
    failed = int(not ctl > cs.TP_LOGITS_RTOL)
    for shape in LM_MESHES:
        mesh = launch_mesh.make_mesh(*shape)
        torch.cuda.synchronize()
        dist.barrier()
        losses, gn, wall, nbytes, steps = _lm_train(dev, mesh)
        first = abs(losses[0] - one_losses[0])
        loss_gaps = cs._rel_gaps(losses, one_losses)
        gn_gaps = cs._rel_gaps(gn, one_gn)
        ok = (first <= cs.TP_LOSS_ATOL_FIRST
              and max(loss_gaps) <= cs.TP_LOSS_RTOL
              and gn_gaps[0] <= cs.TP_GRAD_NORM_RTOL)
        got, swall, ticks, sbytes = _lm_serve(dev, mesh)
        same = got == one_serve
        tokens = sum(a == b for rid in one_serve for a, b in zip(
            got[rid][0], one_serve[rid][0]))
        total = sum(len(c[0]) for c in one_serve.values())
        slots = [(got[rid][1], one_serve[rid][1]) for rid in one_serve]
        logits = _lm_logits(dev, mesh)
        diff = float((logits - one_logits).abs().max())
        err = cs._logits_rel_err(logits, one_logits)
        close = err <= cs.TP_LOGITS_RTOL
        failed += (not ok) + (not close)
        print(f"rank {rank}/{world} mesh {shape}: train {wall:.3f} s "
              f"(steps {steps}), losses {losses} (first step off by "
              f"{first}, relative gaps {loss_gaps}), gradient norms {gn} "
              f"(relative gaps {gn_gaps}): "
              f"{'within' if ok else 'OUTSIDE'} phase 34's tolerances; "
              f"collective bytes a step {nbytes}; serve {swall:.3f} s, "
              f"{ticks} ticks, "
              + ("tokens, slots and bits equal the one-card run"
                 if same else f"{tokens} of {total} tokens equal the "
                 f"one-card run's, channel slots (mesh, one card) {slots}")
              + f", collective bytes a tick {sbytes}; float32 logits max "
              f"diff {diff:.4g}, {err:.4g} of max|logit| "
              f"({'within' if close else 'OUTSIDE'} {cs.TP_LOGITS_RTOL})",
              flush=True)
    return failed


# phase 35's trainers over the four cards: (arch, meshes)
MODEL_MESHES = ((cs.QWEN3, ((1, 4), (2, 2))), (cs.XLSTM, ((1, 4), (2, 2))),
                (cs.WHISPER, ((1, 4), (2, 2))))
MOE_LAYERS = 4


def model_meshes(rank: int, world: int, dev) -> int:
    """Phase 35's trainers on the meshes of :data:`MODEL_MESHES` against
    this rank's one-card runs; the number of failed checks.  Every
    reading is printed before it is held to its limit."""
    failed = 0
    for arch, shapes in MODEL_MESHES:
        one = cs._tpm_train(arch, dev, None, moe_layers=MOE_LAYERS)
        print(f"rank {rank}/{world} one card {arch}: train "
              f"{one['wall']:.3f} s (steps {one['step_s']}), losses "
              f"{one['losses']}, gradient norms {one['grad_norms']}, aux "
              f"{one['aux']}", flush=True)
        for shape in shapes:
            mesh = launch_mesh.make_mesh(*shape)
            cs._sync(dev)
            dist.barrier()
            got = cs._tpm_train(arch, dev, mesh, moe_layers=MOE_LAYERS)
            first = abs(got["losses"][0] - one["losses"][0])
            loss_gaps = cs._rel_gaps(got["losses"][1:], one["losses"][1:])
            gn_gaps = cs._rel_gaps(got["grad_norms"], one["grad_norms"])
            aux = [abs(a - b) for a, b in zip(got["aux"], one["aux"])
                   if a is not None]
            ok = (cs._tpm_loss_held(got["losses"][0], one["losses"][0])
                  and max(loss_gaps, default=0.0) <= cs.TP_LOSS_RTOL
                  and gn_gaps[0] <= cs.TP_GRAD_NORM_RTOL
                  and (not aux or aux[0] <= cs.TP_LOSS_ATOL_FIRST))
            failed += not ok
            steps = len(got["losses"])
            print(f"rank {rank}/{world} {arch} mesh {shape}: train "
                  f"{got['wall']:.3f} s (steps {got['step_s']}), losses "
                  f"{got['losses']} (step 1 off by {first}, later relative "
                  f"gaps {loss_gaps}), gradient norms {got['grad_norms']} "
                  f"(relative gaps {gn_gaps}), aux {got['aux']} (off by "
                  f"{aux}): {'within' if ok else 'OUTSIDE'} phase 35's "
                  f"limits; collective bytes a step "
                  f"{cs._per(got['bytes'], steps)}", flush=True)
    return failed


# the long-context cut: jamba's period, a cache of long_500k's length
LONG_CACHE, LONG_TICKS = 524288, 8
# 32 positions a card of four: a 64-token prompt and its ticks lie in the
# blocks of cards 0-2
LONG_BOUNDARY_CACHE = 128
# the split decode's bf16 logits against the one-card run's: the largest
# |difference| over the largest |logit|.  On four H100s the sound long run
# read 0.01786 (about 3 bf16 steps at its largest logit, 5.25), the sound
# boundary run 0, and the boundary run's control fault 0.2418; the limit
# sits between, ~3x above the one and ~5x below the other.
LONG_LOGITS_RTOL = 0.05
# the pipeline: 4 stages of tanh(x @ w + b), 8 microbatches of 64 x 1024
PIPE_MICRO, PIPE_ROWS, PIPE_WIDTH = 8, 64, 1024
# the pipeline's forward against the sequential one on the same card, and
# each stage's weight gradient: the same kernels on the same shapes, so a
# few float32 roundings at most (tests/test_torch_shard.py's limits)
PIPE_ATOL, PIPE_GRAD_ATOL = 1e-5, 1e-4


def _long_ticks(m, values, prompt, dev, max_seq) -> dict:
    """A prefill of ``prompt`` into a ``max_seq``-position cache and
    ``LONG_TICKS`` greedy ``decode_step_channel`` ticks under OCS p 0.05:
    tokens, channel slots, the logits (float, on the CPU), the cache's
    bytes and the wall seconds."""
    cs._sync(dev)
    t0 = time.perf_counter()
    tokens = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)[None]
    logits, cache = m.prefill(values, {"tokens": tokens}, max_seq=max_seq)
    nbytes = sum(t.numel() * t.element_size()
                 for t in cs.tree.leaves(cache))
    proto = cs._ocs(cs.SERVE_P_MISS)
    pos = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    toks, slots, seq = [], [], [logits]
    for t in range(LONG_TICKS):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits, cache, chan = m.decode_step_channel(
            values, tok, pos + t, cache, proto, cs.jr.PRNGKey(t, dev))
        toks.append(tok)
        slots.append(chan["contention_slots"])
        seq.append(logits)
    cs._sync(dev)
    wall = time.perf_counter() - t0
    return dict(tokens=torch.cat(toks, 1).cpu(),
                slots=[int(x) for x in slots],
                logits=torch.stack(seq).float().cpu(), cache_bytes=nbytes,
                wall=wall, max_seq=max_seq)


def _long_run(m, values, prompt, dev, mesh, rules, cache) -> dict:
    """``_long_ticks`` into a ``cache``-position cache on one card and over
    the mesh (its collectives a tick under ``"bytes"``)."""
    one = _long_ticks(m, values, prompt, dev, cache)
    cs._sync(dev)
    dist.barrier()
    with sharding.use_mesh(mesh, rules), comm.recording() as rec:
        got = _long_ticks(m, sharding.shard_values(values, m.axes(), mesh,
                                                   rules), prompt, dev, cache)
    got["bytes"] = cs._per(comm.summarize(rec), LONG_TICKS)
    return {"one": one, "mesh": got}


def long_context(rank: int, world: int, dev, m=None, prompt=None) -> int:
    """Jamba's period on a (``world`` x 1) mesh under the long-context
    rules against this rank's one-card run of the whole cache, at the
    long and the boundary cache, and the boundary run's control fault
    (``m`` and ``prompt`` stand in for the full-width model and phase
    27's first prompt); the number of failed checks."""
    if m is None:
        m = cs._tpm_model(cs.JAMBA)
        prompt = cs._tpm_requests(cs.JAMBA, m.cfg.vocab_size)[0].prompt
    block = LONG_BOUNDARY_CACHE // world
    assert block < len(prompt) <= LONG_BOUNDARY_CACHE - LONG_TICKS, \
        "the boundary run's keys must lie in more than one card's block"
    values = m.init(torch.Generator(device=dev).manual_seed(0))
    mesh = launch_mesh.make_mesh(world, 1)
    rules = launch_mesh.rules_for("long_500k", 1, mesh)
    runs = {name: _long_run(m, values, prompt, dev, mesh, rules, cache)
            for name, cache in (("long", LONG_CACHE),
                                ("boundary", LONG_BOUNDARY_CACHE))}
    sound = cs.attention._seq_sum
    cs.attention._seq_sum = cs._split_denominators
    try:
        with sharding.use_mesh(mesh, rules):
            control = _long_ticks(m, sharding.shard_values(
                values, m.axes(), mesh, rules), prompt, dev,
                LONG_BOUNDARY_CACHE)
    finally:
        cs.attention._seq_sum = sound
    errs = {name: cs._logits_rel_err(r["mesh"]["logits"], r["one"]["logits"])
            for name, r in runs.items()}
    ctl = cs._logits_rel_err(control["logits"],
                             runs["boundary"]["one"]["logits"])
    for name, r in runs.items():
        one, got = r["one"], r["mesh"]
        print(f"rank {rank}/{world} long context {m.cfg.name} {name} (4 x "
              f"1, kv_seq over the data axis, a {one['max_seq']}-position "
              f"cache, a {len(prompt)}-token prompt): one card "
              f"{one['wall']:.3f} s, cache {one['cache_bytes']} bytes; mesh "
              f"{got['wall']:.3f} s, cache {got['cache_bytes']} bytes a card "
              f"({got['cache_bytes'] / one['cache_bytes']:.4f}), collectives "
              f"{got['bytes']} a tick (prefill included); tokens "
              f"{got['tokens'].tolist()} against {one['tokens'].tolist()}, "
              f"channel slots {got['slots']} against {one['slots']}; bf16 "
              f"logits {errs[name]:.4g} of max|logit| "
              f"{float(one['logits'].abs().max()):.4g} (limit "
              f"{LONG_LOGITS_RTOL})", flush=True)
    print(f"rank {rank}/{world} long context control (card 1 keeps its own "
          f"block's softmax denominators, boundary cache): bf16 logits "
          f"{ctl:.4g} of max|logit|, tokens {control['tokens'].tolist()}",
          flush=True)
    failed = sum(not e <= LONG_LOGITS_RTOL for e in errs.values())
    return failed + int(not ctl > LONG_LOGITS_RTOL)


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_stages(rank: int, world: int, dev) -> int:
    """``gpipe`` over the world's ranks, one stage a rank, against
    ``sequential_reference`` on this rank's device: the forward, and the
    gradient of ``sum(y ** 2)`` w.r.t. the stacked weights (each rank
    holds its own stage's slice of it, zero elsewhere); the number of
    failed checks."""
    gen = torch.Generator().manual_seed(23)
    w = (torch.randn((world, PIPE_WIDTH, PIPE_WIDTH), generator=gen)
         * PIPE_WIDTH ** -0.5).to(dev)
    b = (torch.randn((world, PIPE_WIDTH), generator=gen) * 0.1).to(dev)
    x = torch.randn((PIPE_MICRO, PIPE_ROWS, PIPE_WIDTH), generator=gen).to(dev)
    ref_w = w.clone().requires_grad_(True)
    want = pipeline.sequential_reference(_stage, {"w": ref_w, "b": b}, x)
    (want ** 2).sum().backward()
    pipe_w = w.clone().requires_grad_(True)
    cs._sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    got = pipeline.gpipe(_stage)({"w": pipe_w, "b": b}, x)
    (got ** 2).sum().backward()
    cs._sync(dev)
    wall = time.perf_counter() - t0
    err = float((got - want).detach().abs().max())
    grad_err = float((pipe_w.grad[rank] - ref_w.grad[rank]).abs().max())
    others = float(torch.cat([pipe_w.grad[:rank],
                              pipe_w.grad[rank + 1:]]).abs().max())
    same = cs._bitwise_equal(got.detach(), want.detach())
    print(f"rank {rank}/{world} gpipe {world} stages x {PIPE_MICRO} "
          f"microbatches of {PIPE_ROWS} x {PIPE_WIDTH}: {wall:.3f} s "
          f"forward and backward; forward {err:.4g} off the sequential "
          f"reference (bitwise {same}), its stage's "
          f"weight gradient {grad_err:.4g} off, the other stages' {others}",
          flush=True)
    return int(not (err <= PIPE_ATOL and grad_err <= PIPE_GRAD_ATOL
                    and others == 0.0))


PARTS = ("engines", "lm_meshes", "model_meshes", "long_context", "pipeline")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    parts = PARTS
    if args:
        if args[0] != "--parts" or not set(args[1:]) <= set(PARTS):
            raise SystemExit(f"usage: chip_ranks.py [--parts {' '.join(PARTS)}]")
        parts = tuple(args[1:])
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        kernels.library()
    dist.barrier()
    kernels.library()
    dev = torch.device("cuda")
    differing = 0
    if "engines" in parts:
        differing += engines(rank, world)
    for name, fn in (("lm_meshes", lambda: lm_meshes(rank, world)),
                     ("model_meshes", lambda: model_meshes(rank, world, dev)),
                     ("long_context", lambda: long_context(rank, world, dev)),
                     ("pipeline", lambda: pipeline_stages(rank, world, dev))):
        if name in parts:
            dist.barrier()
            differing += fn()
    dist.barrier()
    dist.destroy_process_group()
    return 1 if differing else 0


def engines(rank: int, world: int) -> int:
    """The channel engines' placements against the one-rank run; the
    number of differing fields."""
    car = CompressedAllReduce.topk(cs.DP_K_FRAC)
    runs = {
        "curves": lambda n: cs.tc.run_curves(
            cs.cifar_config(), device="cuda", n_devices=n),
        "sweep": lambda n: cs.sweep.run_sweep(
            cs.sweep_grid(), k_elems=cs.SWEEP_K, rounds=cs.SWEEP_ROUNDS,
            device="cuda", n_devices=n),
        "dp": lambda n: cs.tc.run_curves_dp(
            cs._dp_config(), car, device="cuda", n_devices=n)}
    differing = 0
    for name, fn in runs.items():
        one = fn(1)
        for n in sorted({2, world}):
            torch.cuda.synchronize()
            dist.barrier()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            got = fn(n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            diff = cs._differences(got, one, name)
            differing += len(diff)
            noisy = kernels.launch_counts()["ocs_contention.noisy"]
            print(f"rank {rank}/{world} cuda:{torch.cuda.current_device()} "
                  f"{name} n_devices={n}: {wall:.3f} s, noisy {noisy}, "
                  + ("bitwise the one-rank run" if not diff
                     else f"DIFFERS in {diff[:6]}"), flush=True)
    return differing


if __name__ == "__main__":
    sys.exit(main())
