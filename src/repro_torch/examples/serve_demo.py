"""Batched serving demo: train a tiny LM briefly, then serve a stream of
requests through the slot-based continuous-batching engine (prefill ->
decode ticks -> retire/refill) — first channel-free, then with the
simulated OCS wireless channel inside every decode tick (same engine; the
channel run reports the airtime and uplink bill each completion carries).

  python -m repro_torch.examples.serve_demo --requests 8 --slots 4
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import pipeline
from repro_torch.models import model as M
from repro_torch.optim import optimizers, schedules
from repro_torch.protocol import Protocol
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.sim.train_curves import resolve_device
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--p-miss", type=float, default=0.1,
                    help="sensing-miss probability for the channel run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced("qwen1.5-0.5b", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=4, d_ff=256, vocab_size=512, n_workers=2)
    m = M.build(cfg)
    values = m.init(torch.Generator(device=dev).manual_seed(0))

    # brief training so generations follow the synthetic-language structure
    pcfg = pipeline.for_model(cfg, batch=16, seq_len=64)
    opt = optimizers.adamw(schedules.constant(3e-3))
    res = trainer.train(
        m.loss, values, opt,
        lambda s: pipeline.batch_for_step(pcfg, s, device=dev),
        TrainerConfig(steps=args.train_steps, ckpt_dir=None, log_every=20))
    print(f"trained {args.train_steps} steps, "
          f"nll {res.history[0]['nll']:.3f} -> {res.history[-1]['nll']:.3f}")

    config = ServeConfig(batch_slots=args.slots, max_seq=128, eos_id=-1)
    engine = ServeEngine(m, res.values, config, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, 512, 8).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    outs = engine.run(reqs)
    for rid in sorted(outs):
        c = outs[rid]
        print(f"request {rid}: prompt_len={c.prompt_len} "
              f"generated={c.tokens}")
    print(f"served {len(outs)} requests on {args.slots} slots.")

    # same engine, channel in the loop: every mlp-FFN fusion aggregates
    # over the simulated OCS channel, and completions bill the airtime
    proto = Protocol.ocs(bits=8, p_miss=torch.full(
        (cfg.n_workers,), args.p_miss, dtype=torch.float32, device=dev))
    chan_outs = engine.run(reqs, protocol=proto)
    for rid in sorted(chan_outs):
        c = chan_outs[rid]
        print(f"request {rid} under p_miss={args.p_miss}: "
              f"latency={c.latency_us(config.clock):.0f}us "
              f"({c.latency_ticks} ticks + {c.channel_slots} slots), "
              f"uplink={c.uplink_bits} bits")
    return {"free": outs, "channel": chan_outs}


if __name__ == "__main__":
    main()
