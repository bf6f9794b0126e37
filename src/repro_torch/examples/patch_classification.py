"""Paper §IV-B: classification from patch grids (Table I analogue).

Workers observe disjoint cells of a global image; the fusion center
classifies from aggregated embeddings.  ``--method`` selects one of the
paper's five rows.  The Table I run is the JAX package's
``benchmarks/bench_table1.run``, kept here (the port imports nothing of
that package).

  python -m repro_torch.examples.patch_classification --method fedocs
  python -m repro_torch.examples.patch_classification --method all
"""

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import aggregators, vertical
from repro_torch.core.vertical import VerticalConfig
from repro_torch.data.vertical_data import (PatchTaskConfig,
                                            patch_classification)
from repro_torch.optim import optimizers, schedules
from repro_torch.sim.train_curves import resolve_device
from repro_torch.train.train_step import make_train_step


def _train_one(cfg: VerticalConfig, views, labels, v_views, v_labels,
               steps: int = 600, batch: int = 64, lr: float = 3e-3,
               seed: int = 0):
    dev = views.device
    params = vertical.init(cfg, seed, dev)
    opt = optimizers.adamw(schedules.linear_warmup_cosine(lr, 20, steps),
                           weight_decay=0.01)
    state = opt.init(params)
    n = views.shape[1]
    step = make_train_step(
        lambda p, b: vertical.loss_fn(cfg, p, b[0], b[1]), opt)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, batch)).to(dev)
        params, state, _ = step(params, state, (views[:, idx], labels[idx]))
    with torch.no_grad():
        _, metrics = vertical.loss_fn(cfg, params, v_views, v_labels)
    return params, float(metrics["acc"])


def _best_worker_acc(cfg, params, v_views, v_labels) -> float:
    with torch.no_grad():
        preds = vertical.per_worker_predictions(cfg, params, v_views)
    accs = [float((preds[i].argmax(-1) == v_labels).float().mean())
            for i in range(preds.shape[0])]
    return max(accs)


def run(steps: int = 600, n_train: int = 8192, n_val: int = 512,
        seeds=(0,), device="cuda") -> List[str]:
    dev = resolve_device(device)
    task = PatchTaskConfig(n_classes=4, grid=2, hw=32, sigma=0.5)
    views, labels = patch_classification(task, n_train, seed=0)
    v_views, v_labels = patch_classification(task, n_val, seed=1)
    views_t, labels_t, vv_t, vl_t = (torch.from_numpy(a).to(dev) for a in
                                     (views, labels, v_views, v_labels))

    base = VerticalConfig(
        n_workers=views.shape[0], input_dim=views.shape[-1],
        encoder_dims=(128, 64), embed_dim=32, head_dims=(128, 64),
        output_dim=task.n_classes, task="classification")

    rows = []
    accs: Dict[str, List[float]] = {}
    for method in aggregators.TABLE1_METHODS:
        cfg = aggregators.table1_config(method, base)
        for seed in seeds:
            t0 = time.time()
            params, acc = _train_one(cfg, views_t, labels_t, vv_t, vl_t,
                                     steps=steps, seed=seed)
            if method == "best_worker_pred":
                acc = _best_worker_acc(cfg, params, vv_t, vl_t)
            accs.setdefault(method, []).append(acc)
            dt = (time.time() - t0) * 1e6 / steps
            rows.append(f"table1/{method}/seed{seed},{dt:.0f},acc={acc:.4f}")
    # aggregate row per method
    for method, a in accs.items():
        load = vertical.comm_load(aggregators.table1_config(method, base))
        rows.append(
            f"table1/{method}/mean,0,"
            f"acc={np.mean(a):.4f}±{np.std(a):.4f};"
            f"uplink_msgs={load.uplink_payload_msgs}")
    return rows


def main(argv=None) -> List[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="fedocs",
                    choices=aggregators.TABLE1_METHODS + ("all",))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(steps=args.steps, device=args.device)
    printed = []
    for r in rows:
        name = r.split(",", 1)[0]
        if args.method == "all" or f"/{args.method}/" in name:
            print(r)
            printed.append(r)
    return printed


if __name__ == "__main__":
    main()
