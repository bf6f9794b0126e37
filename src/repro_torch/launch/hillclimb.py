"""The hillclimb: re-traces the three chosen cells with each
optimization variant and records their roofline terms (the JAX package's
``launch/hillclimb.py``).

Cells:
  * qwen3-moe-30b-a3b / train_4k   — worst compute fraction, most
    collective-bound (EP combine all-gather)
  * qwen2.5-32b / train_4k         — largest absolute collective term
    (uneven 40-head sharding all-gathers)
  * glm4-9b / train_4k             — most representative of the paper's
    technique (full FedOCS fusion coverage)

Usage: python -m repro_torch.launch.hillclimb [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.launch.dryrun import run_cell

EXPERIMENTS = {
    "glm4-9b": [
        # paper-faithful baseline already recorded as __max
        ("sum", dict(tp_fusion="sum"), {}),                  # Megatron ref
        ("concat", dict(tp_fusion="concat"), {}),            # paper's bound
        ("q8", dict(tp_fusion="max_q8"), {}),
        ("q8_bf16s", dict(tp_fusion="max_q8"),
         dict(scores_dtype="bf16")),
    ],
    "qwen2.5-32b": [
        ("pad48", dict(tp_fusion="max"), dict(pad_heads_to=48)),
        ("pad48_q8_bf16s", dict(tp_fusion="max_q8"),
         dict(pad_heads_to=48, scores_dtype="bf16")),
    ],
    "qwen3-moe-30b-a3b": [
        ("gather", dict(tp_fusion="max"), dict(moe_impl="gather")),
        ("gather_q8_bf16s", dict(tp_fusion="max_q8"),
         dict(moe_impl="gather", scores_dtype="bf16")),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the device whose fake tensors the trace runs on")
    args = ap.parse_args(argv)
    out_dir = "artifacts/hillclimb_torch"
    os.makedirs(out_dir, exist_ok=True)
    for arch, variants in EXPERIMENTS.items():
        for name, fusion_kw, overrides in variants:
            tag = f"{arch}__train_4k__sp__{name}"
            t0 = time.time()
            rec = run_cell(arch, "train_4k", multi_pod=False,
                           tp_fusion=fusion_kw["tp_fusion"],
                           overrides=overrides, device=args.device)
            rec["variant"] = name
            with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"[ok {time.time()-t0:5.0f}s] {tag} "
                      f"bn={r['bottleneck']} tc={r['t_compute_s']:.3e} "
                      f"tm={r['t_memory_s']:.3e} tl={r['t_collective_s']:.3e}",
                      flush=True)
            else:
                print(f"[ERR] {tag}: {rec.get('error','')[:200]}", flush=True)


if __name__ == "__main__":
    main()
