"""Collective traffic and roofline terms of a dry-run cell (the JAX
package's ``launch/hlo_analysis.py``, under its name so that a reader
finds the counterpart).

The port has no HLO: it runs eagerly, and its dry-run traces one rank's
step on fake tensors (``launch/dryrun.py``).  So where the JAX package
parses the partitioned module's collectives out of HLO text, the port
reads the records that ``repro_torch.parallel.comm.recording`` keeps of
every collective the step calls (op, dtype, the bytes this rank puts in,
the group's size), and converts them to per-device link bytes with the
same ring factors, on ``P`` the per-device result bytes and ``g`` the
group's size:

    all-reduce(P)        2 * P * (g-1)/g      (reduce-scatter + all-gather)
    all-gather(->P)      P * (g-1)/g          (P = g x what a rank puts in)
    all-to-all(P)        P * (g-1)/g

:func:`roofline_terms` divides by the published peaks of one NVIDIA H100
SXM at its full 700 W (NVIDIA's data sheet): 989e12 dense bf16 FLOP/s,
3.35e12 B/s of HBM, 450e9 B/s of NVLink each way.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Sequence

# the port's collective ops (``comm.recording``'s ``op``, before the dot)
# -> the JAX package's HLO op names
_CANON = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "all_to_all": "all-to-all"}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    payload_bytes: Dict[str, int]      # sum of per-device result bytes
    link_bytes: float                  # ring-estimated per-device link bytes

    def total_payload(self) -> int:
        return sum(self.payload_bytes.values())


def collective_stats(records: Sequence[dict]) -> CollectiveStats:
    """Counts, result bytes and ring-estimated link bytes by collective,
    from ``comm.recording``'s records of one rank's step."""
    counts: Dict[str, int] = defaultdict(int)
    payload: Dict[str, int] = defaultdict(int)
    link = 0.0
    for rec in records:
        op = rec["op"].split(".")[0]
        canon = _CANON.get(op)
        if canon is None:
            raise ValueError(f"unknown collective {rec['op']!r}")
        g = rec["group"]
        result = rec["bytes"] * (g if canon == "all-gather" else 1)
        counts[canon] += 1
        payload[canon] += result
        if canon == "all-reduce":
            link += 2 * result * (g - 1) / g
        else:                           # all-gather, all-to-all
            link += result * (g - 1) / g
    return CollectiveStats(counts=dict(counts), payload_bytes=dict(payload),
                           link_bytes=link)


# hardware constants: one NVIDIA H100 SXM at 700 W, NVIDIA's data sheet
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # bytes/s
# NVLink, each way, to the other cards of a host.  A mesh axis that
# crosses hosts (the data and pod axes of a 256- or 512-card mesh) runs
# over the network, slower than this, so the collective term is a lower
# bound.
NVLINK_BW = 450e9


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                   link_bytes_per_dev: float) -> Dict[str, float]:
    t_compute = flops_per_dev / PEAK_FLOPS_BF16
    t_memory = hbm_bytes_per_dev / HBM_BW
    t_collective = link_bytes_per_dev / NVLINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)),
        key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": dominant,
    }
