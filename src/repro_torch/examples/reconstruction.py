"""Paper §IV-A: multi-sensor denoising reconstruction (Fig. 2 analogue).

N sensors observe the same image under independent Gaussian noise
(sigma=2); encoders (512-256-128 -> K=64) + decoder (128-256-512) as in
the paper.  Compares 1 worker vs N workers at identical per-sensor
channel use.

  python -m repro_torch.examples.reconstruction --workers 4 --steps 400
"""

import argparse

import numpy as np
import torch

from repro_torch.core import vertical
from repro_torch.core.vertical import VerticalConfig
from repro_torch.data.vertical_data import multiview_denoising
from repro_torch.optim import optimizers, schedules
from repro_torch.sim.train_curves import resolve_device
from repro_torch.train.train_step import make_train_step


def train(n_workers: int, steps: int, hw: int = 28, seed: int = 0,
          device="cuda") -> float:
    dev = resolve_device(device)
    views, clean = multiview_denoising(2048, n_workers=n_workers, hw=hw,
                                       sigma=2.0, seed=0)
    v_views, v_clean = multiview_denoising(256, n_workers=n_workers, hw=hw,
                                           sigma=2.0, seed=7)
    cfg = VerticalConfig(
        n_workers=n_workers, input_dim=hw * hw,
        encoder_dims=(512, 256, 128), embed_dim=64,
        head_dims=(128, 256, 512), output_dim=hw * hw,
        task="reconstruction", aggregation="max")
    params = vertical.init(cfg, seed, dev)
    opt = optimizers.adamw(schedules.linear_warmup_cosine(2e-3, 20, steps))
    state = opt.init(params)
    views_t = torch.from_numpy(views).to(dev)
    clean_t = torch.from_numpy(clean).to(dev)
    step = make_train_step(
        lambda p, b: vertical.loss_fn(cfg, p, b[0], b[1]), opt)

    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, views.shape[1], 64)).to(dev)
        params, state, met = step(params, state,
                                  (views_t[:, idx], clean_t[idx]))
        if i % 100 == 0:
            print(f"[N={n_workers}] step {i:4d}  train mse "
                  f"{float(met['loss_mean']):.4f}")
    with torch.no_grad():
        _, m = vertical.loss_fn(cfg, params,
                                torch.from_numpy(v_views).to(dev),
                                torch.from_numpy(v_clean).to(dev))
    print(f"[N={n_workers}] validation NLL {float(m['nll']):.4f}")
    return float(m["nll"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    nll_1 = train(1, args.steps, device=args.device)
    nll_n = train(args.workers, args.steps, device=args.device)
    print(f"\nfusion gain: NLL {nll_1:.4f} (1 worker) -> {nll_n:.4f} "
          f"({args.workers} workers)  [paper: 0.19 -> 0.13]")
    return nll_1, nll_n


if __name__ == "__main__":
    main()
