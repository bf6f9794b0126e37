"""Curve-result emission: per-cell records and benchmark rows.

:func:`summarize_curves` merges a ``CurveResult``'s accuracies with the
analytic channel accounting of ``repro_torch.core.channel`` (via
``Protocol.comm_load``), so every accuracy row carries the uplink cost of
the operating point that produced it.
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
