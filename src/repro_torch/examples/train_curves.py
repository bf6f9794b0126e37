"""Train accuracy-vs-channel-quality curves with the OCS channel in the
loop.

The paper's end-to-end claim, produced by one command: the vertical
learner's embeddings are fused through the *simulated* noisy-OCS channel
(quantized D-bit contention, miss detection, lowest-index capture), and
the whole ``p_miss`` axis trains as lanes of one stack per ``bits`` value.
An ideal ``max_q{bits}`` reference trains alongside; the ``p_miss=0`` lane
reproduces it bit for bit.

A ``CollisionAdaptiveBits`` schedule then re-trains the same lanes with
the backoff depth re-chosen per round from the protocol's own collision
telemetry (the ``BitsSchedule`` policy hook).

  python -m repro_torch.examples.train_curves [out.json] [--steps 600]
"""

import argparse
import json

import numpy as np

from repro_torch import kernels
from repro_torch.protocol import CollisionAdaptiveBits
from repro_torch.sim import results, train_curves as tc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ccfg = tc.CurveConfig(bits=(8, 16), p_miss=(0.0, 0.02, 0.05, 0.1, 0.2),
                          steps=args.steps, batch=64, n_train=8192,
                          n_val=512, hw=32, encoder_dims=(128, 64),
                          embed_dim=32, head_dims=(128, 64))
    kernels.reset_launch_counts()
    curves = tc.run_curves(ccfg, device=args.device)
    records = results.summarize_curves(curves)

    print("# accuracy vs p_miss (channel-in-the-loop training)")
    for row in results.curve_rows(records):
        print(row)
    launched = kernels.launch_counts()
    print(f"# {len(ccfg.bits)} bit depths x {len(ccfg.p_miss)} p_miss lanes, "
          f"lane-stack engine: {launched['ocs_contention.noisy']} contention "
          f"launches, 1 host read per bits value")

    # channel-aware backoff-depth scheduling: pick D per round from the
    # observed collision fraction
    sched = tc.run_scheduled_curves(ccfg, CollisionAdaptiveBits(ccfg.bits),
                                    device=args.device)
    depths = sched.bits_per_step
    switches = int((depths[1:] != depths[:-1]).sum())
    print(f"# CollisionAdaptiveBits{tuple(ccfg.bits)}: "
          f"start b{depths[0]}, final b{depths[-1]}, "
          f"{switches} switches, acc {np.round(sched.acc, 4).tolist()} "
          f"(one depth read a step)")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.out}")
    return {"records": records, "switches": switches, "acc": sched.acc}


if __name__ == "__main__":
    main()
