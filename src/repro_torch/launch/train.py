"""Training launcher: (arch config x data x optimizer x trainer) from the
command line, the JAX package's ``launch/train.py``.

The flags are the JAX launcher's (``--steps``/``--batch``/``--seq``/
``--lr``/``--fusion``/``--microbatches``/``--compress``/``--ckpt-dir``/
``--seed``), plus ``--device`` (default ``cuda``), ``--use-flash`` (on
by default: attention runs the flash-attention kernel's forward) and
``--layers`` (a cut of the depth to whole periods of the layer plan, 0
keeping the config's).  The
parameters are random, drawn from a ``torch.Generator`` seeded with
``--seed``.  With ``--ckpt-dir`` the run checkpoints four times and at the
end, and resumes from the newest checkpoint there when relaunched.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 6 --batch 8 --seq 256 --ckpt-dir ckpt   # full width, card
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --device cpu --steps 20 --seq 16        # reduced, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch qwen3-moe-30b-a3b --layers 4 --steps 3 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --smoke --device cpu --steps 6 --seq 16
"""

from __future__ import annotations

import argparse
import types

import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data import pipeline
from repro_torch.models import model as M
from repro_torch.optim import optimizers, schedules
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of the full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-flash", action=argparse.BooleanOptionalAction,
                    default=True, help="attention through the flash kernel")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--fusion", default="max")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def config(args: argparse.Namespace):
    """The model config the flags describe."""
    get = get_reduced if args.smoke else get_config
    cfg = get(args.arch, tp_fusion=args.fusion, use_flash=args.use_flash)
    if args.layers:
        if args.layers % cfg.period:
            raise ValueError(
                f"--layers {args.layers}: {args.arch} has a layer plan with "
                f"a period of {cfg.period}; cut to a multiple of it")
        cfg = cfg.with_(n_layers=args.layers)
    return cfg


def data_config(args: argparse.Namespace, cfg) -> pipeline.PipelineConfig:
    """The batches the flags describe."""
    return pipeline.for_model(cfg, batch=args.batch, seq_len=args.seq,
                              seed=args.seed)


def setup(args: argparse.Namespace) -> types.SimpleNamespace:
    """The run the flags describe: model, initial values, optimizer, data
    and trainer config (``launch`` runs it)."""
    cfg = config(args)
    m = M.build(cfg)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the launcher trains on cuda by default and no "
                           "GPU is visible; pass --device cpu")
    values = m.init(torch.Generator(device=dev).manual_seed(args.seed))
    pcfg = data_config(args, cfg)
    opt = optimizers.adamw(
        schedules.for_arch(args.arch, args.lr, args.steps),
        weight_decay=0.01)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=max(args.steps // 4, 1), log_every=10,
                         microbatches=args.microbatches,
                         compress_k=args.compress)
    return types.SimpleNamespace(
        cfg=cfg, m=m, device=dev, values=values, opt=opt, tcfg=tcfg,
        data=lambda s: pipeline.batch_for_step(pcfg, s, device=dev))


def launch(run: types.SimpleNamespace) -> trainer.TrainResult:
    return trainer.train(run.m.loss, run.values, run.opt, run.data,
                         run.tcfg)


def main(argv=None) -> trainer.TrainResult:
    run = setup(parse_args(argv))
    n_params = sum(t.numel() for t in tree.leaves(run.values))
    print(f"{run.cfg.name}: {n_params / 1e6:.1f}M params, "
          f"fusion={run.cfg.tp_fusion}, device={run.device}", flush=True)
    res = launch(run)
    for row in res.history:
        print(f"step {row['step']:6d}  nll {row.get('nll', float('nan')):8.4f}"
              f"  lr {row.get('lr', 0):.2e}  {row['step_time_s']:.2f}s")
    if res.straggler_flags:
        print("straggler-flagged steps:", res.straggler_flags)
    return res


if __name__ == "__main__":
    main()
