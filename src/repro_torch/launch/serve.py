"""Serving launcher: a checkpoint (or random weights from a seed) -> the
slot-batched decode loop, optionally with the simulated wireless channel
in every decode tick.

The flags are the JAX launcher's (``--ckpt-dir``, ``--batch-slots``/
``--max-seq``/``--eos-id``/``--sample``/``--seed``, the ``--p-miss``/
``--bits``/... protocol fields, the ``--tick-us``/``--slot-us`` clock and
the Poisson load generator), plus ``--device`` (default ``cuda``) and
``--use-flash`` (on by default: the prefill runs the flash-attention
kernel).  ``--ckpt-dir`` restores the values of the newest checkpoint
there (``launch/train``'s, or the JAX package's), bfloat16 leaves
included.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --p-miss 0.05 --ckpt-dir ckpt --sample  # full width on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --smoke --device cpu --p-miss 0.05    # the reduced config on the CPU
"""

from __future__ import annotations

import argparse
import time
import types

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models import model as M
from repro_torch.protocol import Protocol
from repro_torch.serve.engine import ChannelClock, ServeConfig, ServeEngine
from repro_torch.serve.load import near_far_protocol, poisson_requests


def _build_protocol(args, n_workers: int):
    if args.p_miss is None and not args.near_far:
        return None
    if args.near_far:
        return near_far_protocol(
            n_workers, bits=args.bits, p_near=args.p_miss or 0.0,
            p_far=args.p_far, max_rounds=args.max_rounds,
            backend=args.backend)
    p = np.full((n_workers,), args.p_miss, np.float32)
    return Protocol.ocs(bits=args.bits, p_miss=p,
                        max_rounds=args.max_rounds, backend=args.backend)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of the full width")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-flash", action=argparse.BooleanOptionalAction,
                    default=True, help="prefill through the flash kernel")
    # ServeConfig fields, 1:1
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--sample", action="store_true",
                    help="categorical sampling instead of greedy argmax")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tick-us", type=float, default=50.0)
    ap.add_argument("--slot-us", type=float, default=1.0)
    # protocol fields (omit --p-miss/--near-far for channel-free serving)
    ap.add_argument("--p-miss", type=float, default=None,
                    help="carrier-sensing miss probability (all workers)")
    ap.add_argument("--near-far", action="store_true",
                    help="two-tier near/far p_miss mix (--p-miss=near tier)")
    ap.add_argument("--p-far", type=float, default=0.1)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--max-rounds", type=int, default=3)
    ap.add_argument("--backend", default="scan", choices=("scan", "pallas"))
    # load generator
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrival rate (requests per decode tick)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    return ap.parse_args(argv)


def setup(args: argparse.Namespace) -> types.SimpleNamespace:
    """The engine and the request stream the flags describe (``main``
    serves them); ``step`` is the restored checkpoint's, or None."""
    get = get_reduced if args.smoke else get_config
    cfg = get(args.arch, use_flash=args.use_flash)
    m = M.build(cfg)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    values = m.init(gen)
    step = None
    if args.ckpt_dir:
        restored, step, _ = checkpointer.restore(
            args.ckpt_dir, template={"values": values, "opt": None})
        values = restored["values"]
        print(f"restored checkpoint step {step}", flush=True)
    clock = ChannelClock(tick_us=args.tick_us, slot_us=args.slot_us)
    config = ServeConfig(
        batch_slots=args.batch_slots, max_seq=args.max_seq,
        eos_id=args.eos_id, greedy=not args.sample,
        protocol=_build_protocol(args, cfg.n_workers), clock=clock,
        seed=args.seed)
    engine = ServeEngine(m, values, config, device=dev)
    reqs = poisson_requests(args.requests, args.rate, cfg.vocab_size,
                            prompt_len=args.prompt_len,
                            max_new_tokens=args.max_new, seed=args.seed)
    return types.SimpleNamespace(engine=engine, requests=reqs, clock=clock,
                                 device=dev, step=step)


def main(argv=None):
    run = setup(parse_args(argv))
    engine, clock, dev = run.engine, run.clock, run.device
    t0 = time.perf_counter()
    outs = engine.run(run.requests)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid in sorted(outs):
        c = outs[rid]
        print(f"req {rid}: latency={c.latency_us(clock):.0f}us "
              f"({c.latency_ticks} ticks, {c.channel_slots} slots, "
              f"{c.uplink_bits} uplink bits) tokens={c.tokens}")
    n_tok = sum(len(c.tokens) for c in outs.values())
    print(f"{len(outs)} requests, {n_tok} tokens in {wall:.3f} s on {dev}")
    return outs


if __name__ == "__main__":
    main()
