"""Curve-result emission: per-cell records and benchmark rows.

:func:`summarize_curves` merges a ``CurveResult``'s accuracies with the
analytic channel accounting of ``repro_torch.core.channel`` (via
``Protocol.comm_load``), so every accuracy row carries the uplink cost of
the operating point that produced it; :func:`summarize_fault_curves` does
the same for a ``FaultCurveResult`` with its degradation telemetry.
"""

from __future__ import annotations

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
