"""Registry of the five Table I aggregation methods (paper §IV-B).

Maps the paper's method names onto :mod:`repro_torch.core.vertical`
configurations — each embedding-level method carries its fusion law as a
``repro_torch.protocol.Protocol`` — so a sweep can take them uniformly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.vertical import VerticalConfig
from repro_torch.protocol import Protocol

TABLE1_METHODS = (
    "concat_workers_embed",
    "best_worker_pred",
    "avg_workers_preds",
    "avg_workers_embed",
    "fedocs",
)


def table1_config(method: str, base: VerticalConfig) -> VerticalConfig:
    """Specialize a base vertical config to one of the paper's five methods."""
    if method == "concat_workers_embed":
        return dataclasses.replace(base, aggregation=Protocol.concat(),
                                   prediction_level=False)
    if method == "avg_workers_embed":
        return dataclasses.replace(base, aggregation=Protocol.mean(),
                                   prediction_level=False)
    if method == "fedocs":
        return dataclasses.replace(
            base, aggregation=Protocol.max(tie_break=base.tie_break),
            prediction_level=False)
    if method in ("avg_workers_preds", "best_worker_pred"):
        # both train per-worker heads; they differ only at evaluation time
        return dataclasses.replace(base, prediction_level=True)
    raise ValueError(f"unknown Table-I method {method!r}")


def display_name(method: str) -> str:
    return {
        "concat_workers_embed": "Concat Workers Embed",
        "best_worker_pred": "Best Worker Pred",
        "avg_workers_preds": "Avg. Workers Preds",
        "avg_workers_embed": "Avg. Workers Embed",
        "fedocs": "FedOCS (max-pool)",
    }[method]


def all_configs(base: VerticalConfig) -> Dict[str, VerticalConfig]:
    return {m: table1_config(m, base) for m in TABLE1_METHODS}
