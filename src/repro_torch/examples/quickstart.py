"""Quickstart: FedOCS vertical distributed learning in ~30 lines.

Four workers observe noisy views of the same signal; embeddings are fused
by max-pooling (paper Eq. 4) and only argmax winners would transmit over
the shared channel (O(K) uplink).

  python -m repro_torch.examples.quickstart [--steps 200] [--device cuda]
"""

import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import vertical
from repro_torch.core.vertical import VerticalConfig
from repro_torch.data.vertical_data import multiview_denoising
from repro_torch.optim import optimizers, schedules
from repro_torch.protocol import Protocol
from repro_torch.sim.train_curves import resolve_device
from repro_torch.train.train_step import make_train_step


def main(argv=None, init_params=None) -> dict:
    """``init_params`` (a ``vertical.init``-shaped tree, e.g. converted
    from the JAX example's) replaces the port's own initial draw.  Returns
    every step's loss and the final parameters."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    views, clean = multiview_denoising(512, n_workers=4, hw=16, sigma=2.0)
    # the fusion protocol is a first-class value: max-pool over the shared
    # channel (paper Eq. 4); swap in Protocol.ocs(bits, p_miss) to train
    # with the noisy contention channel in the loop
    cfg = VerticalConfig(n_workers=4, input_dim=256, encoder_dims=(128,),
                         embed_dim=32, head_dims=(128,), output_dim=256,
                         task="reconstruction", aggregation=Protocol.max())
    params = (vertical.init(cfg, 0, dev) if init_params is None
              else tree.map(lambda t: t.to(dev).clone(), init_params))
    opt = optimizers.adamw(schedules.constant(2e-3))
    state = opt.init(params)
    views_t = torch.from_numpy(views).to(dev)
    clean_t = torch.from_numpy(clean).to(dev)
    step = make_train_step(
        lambda p, b: vertical.loss_fn(cfg, p, b[0], b[1]), opt)

    rng = np.random.default_rng(0)
    losses = []
    for i in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, 512, 64)).to(dev)
        params, state, met = step(params, state,
                                  (views_t[:, idx], clean_t[idx]))
        losses.append(met["loss_mean"])
        if i % 50 == 0:
            print(f"step {i:4d}  mse {float(met['loss_mean']):.4f}")

    load = cfg.resolve_protocol().comm_load(cfg.n_workers, cfg.embed_dim)
    concat_load = Protocol.concat().comm_load(cfg.n_workers, cfg.embed_dim)
    print(f"\nuplink: {load.uplink_payload_msgs} msgs/sample "
          f"(concat would need {concat_load.uplink_payload_msgs})")
    print("done.")
    return {"losses": [float(x) for x in losses], "params": params}


if __name__ == "__main__":
    main()
