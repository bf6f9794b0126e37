"""End-to-end LM training driver through the full production stack:
config -> model -> data pipeline -> AdamW(+schedule) -> trainer with
checkpoint/auto-resume and FedOCS max-pool TP fusion.

Presets:
  demo    ~4M params, 200 steps
  100m    ~100M params, 300 steps — the deliverable-scale run

  python -m repro_torch.examples.lm_train --preset demo
  python -m repro_torch.examples.lm_train --preset 100m --steps 300
"""

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_reduced
from repro_torch.data import pipeline
from repro_torch.models import model as M
from repro_torch.optim import optimizers, schedules
from repro_torch.sim.train_curves import resolve_device
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig

PRESETS = {
    "demo": dict(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                 d_ff=512, vocab_size=2048, batch=16, seq=64),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab_size=32768, batch=32, seq=512),
}


def main(argv=None) -> trainer.TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="demo", choices=tuple(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fusion", default="max",
                    help="tp_fusion: sum|max|max_q8|concat")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "fedocs_lm_ckpt"))
    ap.add_argument("--compress", type=float, default=None,
                    help="top-k gradient compression fraction (e.g. 0.0625)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = PRESETS[args.preset]
    cfg = get_reduced(
        "glm4-9b", n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], tp_fusion=args.fusion, n_workers=2)
    m = M.build(cfg)
    print(f"arch=glm4-family preset={args.preset} "
          f"params={cfg.param_count() / 1e6:.1f}M fusion={cfg.tp_fusion}")

    values = m.init(torch.Generator(device=dev).manual_seed(0))
    pcfg = pipeline.for_model(cfg, batch=p["batch"], seq_len=p["seq"])
    opt = optimizers.adamw(
        schedules.for_arch("glm4-9b", 3e-3, args.steps), weight_decay=0.01)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=100, log_every=20,
                         compress_k=args.compress)
    res = trainer.train(
        m.loss, values, opt,
        lambda s: pipeline.batch_for_step(pcfg, s, device=dev), tcfg)
    for row in res.history:
        print(f"step {row['step']:5d}  nll {row.get('nll', 0):7.4f}  "
              f"lr {row.get('lr', 0):.2e}  {row['step_time_s']:.2f}s/step")
    print(f"final nll: {res.history[-1]['nll']:.4f} "
          f"(start {res.history[0]['nll']:.4f})")
    return res


if __name__ == "__main__":
    main()
