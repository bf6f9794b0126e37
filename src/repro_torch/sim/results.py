"""Sweep- and curve-result emission: per-cell records, benchmark rows,
JSON (the JAX package's ``sim/results.py``: the same records, key for key
and value for value, and the same rows).

:func:`summarize` merges a sweep's measured counters (payload / blocking
transmissions, contention slots, noisy-sensing accuracy) with the analytic
channel accounting of ``repro_torch.core.channel`` (via
``Protocol.comm_load``), so every record carries both sides of the
O(K)-vs-O(N*K) argument.  :func:`summarize_curves` does the same for a
``CurveResult``'s accuracies, :func:`summarize_fault_curves` for a
``FaultCurveResult`` with its degradation telemetry, and
:func:`summarize_dp_curves` for a ``DPCurveResult`` with the measured DP
all-reduce payload beside the uplink.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from repro_torch.protocol import Protocol

Record = Dict[str, object]


def _fmt_p_miss(p) -> str:
    """Row label for a scalar or per-worker miss probability."""
    arr = np.asarray(p, np.float64).ravel()
    if arr.size == 1 or np.all(arr == arr[0]):
        return f"{arr[0]:g}"
    return f"{arr.min():g}..{arr.max():g}"


def summarize(sweep) -> List[Record]:
    """One merged record per scenario of a ``repro_torch.sim.sweep
    .SweepResult`` (measured counters + analytic loads)."""
    records: List[Record] = []
    for i, s in enumerate(sweep.scenarios):
        # analytic accounting off the scenario's Protocol (float payloads,
        # the paper's §IV convention — see Scenario.protocol)
        fed = s.protocol().comm_load(s.n_workers, sweep.k_elems)
        cat = Protocol.concat(n_channels=s.n_channels).comm_load(
            s.n_workers, sweep.k_elems)
        rec: Record = {
            "scenario": s.name,
            "n_workers": s.n_workers,
            "bits": s.bits,
            "p_miss": s.p_miss,
            "n_channels": s.n_channels,
            "rounds": sweep.rounds,
            "k_elems": sweep.k_elems,
            "uplink_msgs_fedocs": fed.uplink_payload_msgs,
            "uplink_msgs_concat": cat.uplink_payload_msgs,
            "uplink_ratio": cat.uplink_payload_msgs / fed.uplink_payload_msgs,
            "uplink_overhead_bits": fed.uplink_overhead_bits,
            "analytic_latency_slots": fed.latency_slots,
        }
        if sweep.clean is not None:
            c = sweep.clean
            rec.update({
                # deterministic per round: report round 0 counters
                "payload_tx": int(c.payload_tx[i, 0]),
                "concat_payload_tx": int(c.concat_payload_tx[i, 0]),
                "contention_slots": int(c.contention_slots[i, 0]),
                "latency_slots": int(sweep.clean_latency_slots[i, 0]),
                # varies with the drawn features: average over rounds
                "blocking_tx_mean": float(c.blocking_tx[i].mean()),
                "ties_mean": float(c.ties[i].mean()),
            })
        if sweep.noisy is not None:
            nz = sweep.noisy
            rec.update({
                "frac_correct_mean": float(nz.correct[i].mean()),
                "collisions_mean": float(nz.collisions[i].mean()),
                "noisy_rounds_mean": float(nz.rounds[i].mean()),
                "noisy_contention_slots_mean": float(
                    nz.contention_slots[i].mean()),
                "noisy_latency_slots_mean": float(
                    sweep.noisy_latency_slots[i].mean()),
            })
        records.append(rec)
    return records


def to_rows(records: List[Record], prefix: str = "sweep") -> List[str]:
    """Benchmark-harness CSV rows: ``name,us_per_call,k=v;k=v;...``."""
    rows = []
    for rec in records:
        derived = [f"N={rec['n_workers']}", f"bits={rec['bits']}"]
        if np.any(np.asarray(rec["p_miss"])):
            derived.append(f"p_miss={_fmt_p_miss(rec['p_miss'])}")
        if rec["n_channels"] != 1:
            derived.append(f"ch={rec['n_channels']}")
        if "payload_tx" in rec:
            derived += [
                f"payload_tx={rec['payload_tx']}",
                f"blocking_tx={rec['blocking_tx_mean']:.1f}",
                f"slots={rec['contention_slots']}",
                f"latency={rec['latency_slots']}",
                f"concat_tx={rec['concat_payload_tx']}",
            ]
        derived.append(f"ratio={rec['uplink_ratio']:.0f}")
        if "frac_correct_mean" in rec:
            derived += [
                f"frac_correct={rec['frac_correct_mean']:.3f}",
                f"collisions={rec['collisions_mean']:.1f}",
            ]
        rows.append(f"{prefix}/{rec['scenario']},0," + ";".join(derived))
    return rows


def to_json(records: List[Record]) -> str:
    return json.dumps(records, indent=2, sort_keys=True)


def write_json(records: List[Record], path: str) -> None:
    with open(path, "w") as f:
        f.write(to_json(records) + "\n")


def summarize_curves(curves) -> List[Record]:
    """One record per (bits, p_miss) cell of a train-curve grid: filter on
    ``bits`` for accuracy-vs-p_miss, on ``p_miss`` for accuracy-vs-bits.
    Uplink accounting uses the D-bit code payload the OCS winner sends."""
    ccfg = curves.config
    records: List[Record] = []
    for bi, bits in enumerate(ccfg.bits):
        fed = ccfg.protocol(bits).comm_load(ccfg.n_workers, ccfg.embed_dim)
        cat = Protocol.concat().comm_load(ccfg.n_workers, ccfg.embed_dim)
        for li in range(curves.p_miss.shape[0]):
            p = ccfg.p_miss[li]
            records.append({
                "curve": f"b{bits}_p{_fmt_p_miss(p)}",
                "bits": bits,
                "p_miss": float(p) if np.ndim(p) == 0
                else [float(x) for x in p],
                "n_workers": ccfg.n_workers,
                "k_elems": ccfg.embed_dim,
                "steps": ccfg.steps,
                "acc": float(curves.acc[bi, li]),
                "nll": float(curves.nll[bi, li]),
                "acc_ideal": float(curves.acc_ideal[bi]),
                "nll_ideal": float(curves.nll_ideal[bi]),
                "acc_gap": float(curves.acc_ideal[bi] - curves.acc[bi, li]),
                "uplink_bits_fedocs": fed.uplink_bits,
                "uplink_bits_concat": cat.uplink_bits,
                "uplink_ratio": cat.uplink_bits / fed.uplink_bits,
            })
    return records


def curve_rows(records: List[Record], prefix: str = "curves") -> List[str]:
    """Benchmark-harness CSV rows for train-curve records."""
    rows = []
    for rec in records:
        derived = [
            f"bits={rec['bits']}", f"p_miss={_fmt_p_miss(rec['p_miss'])}",
            f"acc={rec['acc']:.4f}", f"acc_ideal={rec['acc_ideal']:.4f}",
            f"acc_gap={rec['acc_gap']:+.4f}", f"nll={rec['nll']:.4f}",
            f"uplink_bits={rec['uplink_bits_fedocs']}",
            f"ratio={rec['uplink_ratio']:.0f}",
        ]
        rows.append(f"{prefix}/{rec['curve']},0," + ";".join(derived))
    return rows


def summarize_fault_curves(fc) -> List[Record]:
    """One record per (bits, fault-lane) cell of a fault-injection grid
    (``repro_torch.sim.train_curves.FaultCurveResult``): accuracy beside
    the whole-run dropped-frame / outage / retry-slot totals and the
    staleness.  ``burst_len``/``gap_len`` are the mean sojourns implied by
    the lane's transition probabilities (``1/p_bg`` / ``1/p_gb``; ``inf``
    for a lane that never enters the bad state)."""
    ccfg = fc.config
    records: List[Record] = []
    for bi, bits in enumerate(ccfg.bits):
        fed = ccfg.protocol(bits).comm_load(ccfg.n_workers, ccfg.embed_dim)
        for li, fm in enumerate(fc.fault_lanes):
            p_bg, p_gb = float(fm.p_bg), float(fm.p_gb)
            burst_len = (1.0 / p_bg) if p_bg > 0 else float("inf")
            gap_len = (1.0 / p_gb) if p_gb > 0 else float("inf")
            records.append({
                "curve": f"b{bits}_burst{burst_len:g}_"
                         f"{fm.policy.kind}_l{li}",
                "bits": bits,
                "lane": li,
                "policy": fm.policy.kind,
                "retry_budget": fm.policy.retry_budget,
                "burst_len": burst_len,
                "gap_len": gap_len,
                "p_miss_bad": float(fm.p_miss_bad),
                "p_miss_good": float(fm.p_miss_good),
                "p_drop": float(fm.p_drop),
                "p_recover": float(fm.p_recover),
                "n_workers": ccfg.n_workers,
                "k_elems": ccfg.embed_dim,
                "steps": ccfg.steps,
                "acc": float(fc.acc[bi, li]),
                "nll": float(fc.nll[bi, li]),
                "dropped_frames": int(fc.dropped_frames[bi, li]),
                "outage_frames": int(fc.outage_frames[bi, li]),
                "retry_slots": int(fc.retry_slots[bi, li]),
                "stale_age_final": int(fc.stale_age[bi, -1, li]),
                "stale_age_max": int(fc.stale_age[bi, :, li].max()),
                "uplink_bits_fedocs": fed.uplink_bits,
            })
    return records


def fault_curve_rows(records: List[Record], prefix: str = "fault_curves"
                     ) -> List[str]:
    """Benchmark-harness CSV rows for fault-injection curve records."""
    rows = []
    for rec in records:
        derived = [
            f"bits={rec['bits']}", f"policy={rec['policy']}",
            f"burst={rec['burst_len']:g}",
            f"p_bad={rec['p_miss_bad']:g}",
            f"acc={rec['acc']:.4f}", f"nll={rec['nll']:.4f}",
            f"dropped={rec['dropped_frames']}",
            f"outages={rec['outage_frames']}",
            f"retry_slots={rec['retry_slots']}",
            f"stale_max={rec['stale_age_max']}",
        ]
        rows.append(f"{prefix}/{rec['curve']},0," + ";".join(derived))
    return rows


def summarize_dp_curves(dp) -> List[Record]:
    """One record per (bits, p_miss) cell of a compressed-comms run
    (``repro_torch.sim.train_curves.DPCurveResult``): accuracy beside both
    halves of the communication bill — the analytic uplink of the
    operating point (``Protocol.comm_load`` per aggregated sample, ``batch``
    samples a step, ``steps`` steps) and the DP all-reduce payload bits
    measured from the exact-k kept counts, totalled over ranks and steps —
    and their sum ``total_comm_bits``."""
    ccfg = dp.config
    records: List[Record] = []
    for bi, bits in enumerate(ccfg.bits):
        fed = ccfg.protocol(bits).comm_load(ccfg.n_workers, ccfg.embed_dim)
        uplink_step = fed.uplink_bits * ccfg.batch
        for li in range(dp.p_miss.shape[0]):
            p = ccfg.p_miss[li]
            dp_total = int(dp.dp_payload_bits_total[bi, li])
            uplink_total = uplink_step * ccfg.steps
            records.append({
                "curve": f"b{bits}_p{_fmt_p_miss(p)}",
                "bits": bits,
                "p_miss": float(p) if np.ndim(p) == 0
                else [float(x) for x in p],
                "n_workers": ccfg.n_workers,
                "dp_shards": ccfg.dp_shards,
                "k_elems": ccfg.embed_dim,
                "steps": ccfg.steps,
                "k_frac": dp.compress.k_frac,
                "acc": float(dp.acc[bi, li]),
                "nll": float(dp.nll[bi, li]),
                "uplink_bits_step": uplink_step,
                "uplink_bits_total": uplink_total,
                "dp_payload_bits_step": dp.dp_payload_bits_step,
                "dp_payload_bits_total": dp_total,
                "dp_dense_bits_step": dp.dp_dense_bits_step,
                "dp_payload_frac": (dp.dp_payload_bits_step
                                    / dp.dp_dense_bits_step),
                "total_comm_bits": uplink_total + dp_total,
            })
    return records


def dp_curve_rows(records: List[Record], prefix: str = "dp_curves"
                  ) -> List[str]:
    """Benchmark-harness CSV rows for the compressed-comms records."""
    rows = []
    for rec in records:
        derived = [
            f"bits={rec['bits']}", f"p_miss={_fmt_p_miss(rec['p_miss'])}",
            f"dp={rec['dp_shards']}", f"k_frac={rec['k_frac']:g}",
            f"acc={rec['acc']:.4f}", f"nll={rec['nll']:.4f}",
            f"uplink_bits={rec['uplink_bits_total']}",
            f"dp_bits={rec['dp_payload_bits_total']}",
            f"dp_frac={rec['dp_payload_frac']:.3f}",
            f"total_bits={rec['total_comm_bits']}",
        ]
        rows.append(f"{prefix}/{rec['curve']},0," + ";".join(derived))
    return rows
