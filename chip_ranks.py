"""The channel engines over NCCL ranks on several GPUs, one rank a card:

    torchrun --standalone --nproc-per-node 4 chip_ranks.py

Each rank sets its own card, rank 0 builds the kernels and the others load
them.  For ``run_curves`` at ``chip_smoke.py`` phase 5's config, phase 16's
sweep grid and ``run_curves_dp`` at phase 17's settings, the one-rank run
(``n_devices=1``: rank 0 computes, the others receive the result) is the
reference, and the placements over 2 ranks and over the whole world must
equal it in every field, bitwise, on every rank.  Each rank prints its
card, each placement's wall seconds and its ``ocs_contention.noisy``
launches; the exit code is 1 if any field differs.  It imports nothing of
JAX.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.optim.compressed_allreduce import (  # noqa: E402
    CompressedAllReduce)


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
    dist.destroy_process_group()
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())
