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
2).  The exit code is 1 if a check fails.  It imports nothing of JAX.
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


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        kernels.library()
    dist.barrier()
    kernels.library()
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
    dist.barrier()
    differing += lm_meshes(rank, world)
    dist.barrier()
    differing += model_meshes(rank, world, torch.device("cuda"))
    dist.barrier()
    dist.destroy_process_group()
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())
