"""repro_torch.tune — cost-model-driven autotuning of the port's launch
and dispatch knobs (counterpart of ``repro.tune``).

Two stages (see ``tuner``): an analytical ``KernelCostModel`` ranks
candidate configurations per (backend, metric, dtype, pow-2 shape
bucket[, launch variant]); a short measured search optionally refines
the top candidates, with winners persisted in a versioned JSON
``TuningTable`` (shipped defaults under ``tables/``: ``interpret.json``,
a copy of the reference's CPU table, and ``h100.json``, recorded on the
card) behind a per-process LRU (``cache``).

On the card the oracle decides the hand-written CUDA kernels' launch —
kernel, R, warps, queries a block, tile (``kernels.sdtw.ops
.tuned_launch``); on the CPU it ranks the in-core schedules and the
chunk size as the reference does. ``Router.warmup`` pre-tunes declared
buckets (``pretune_request``). Explicit caller kwargs always win, and
tuning is bitwise-safe: every knob it sets is one the engine's
invariance tests prove cannot change int32 results. ``tune='off'``
keeps the hand-set policies everywhere.

``DispatchDecision`` is the record ``engine.sdtw(..., explain=True)``
returns next to the result.
"""
from __future__ import annotations

import dataclasses

from .cache import cache_info, cache_keys, clear_tuning_cache
from .cost import (KernelCostModel, TunedConfig, bucket_key, get_cost_model,
                   tuned_n_micro)
from .table import TuningTable, default_table, reset_tables
from .tuner import (Resolution, canonical_backend, measured_search,
                    pretune_request, rank_incore, record_table, resolve,
                    resolve_n_micro, tuned_chunk)

__all__ = [
    "DispatchDecision", "KernelCostModel", "Resolution", "TunedConfig",
    "TuningTable", "bucket_key", "cache_info", "cache_keys",
    "canonical_backend", "clear_tuning_cache", "default_table",
    "get_cost_model", "measured_search", "pretune_request", "rank_incore",
    "record_table", "reset_tables", "resolve", "resolve_n_micro",
    "tuned_chunk", "tuned_n_micro",
]


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """Why the engine ran what it ran — the ``explain=True`` payload.

    ``source`` taxonomy, as in the reference: ``'explicit'`` (caller
    forced the impl), ``'structural'`` (a hard dispatch rule — top-K /
    chunk / CUDA device / memory bound — fired before any scoring),
    ``'legacy'`` (``tune='off'`` heuristics), ``'model'`` (cost-model
    ranking), ``'table:model'`` / ``'table:measured'`` /
    ``'table:default'`` (tuning-table hit, suffixed with the entry's own
    provenance), ``'measured'`` (fresh measured search this call).
    ``config`` holds the resolved knobs the chosen path received — on the
    card the kernel launch (``kernel``, ``rows``, ``warps``, ``block_q``,
    ``block_m``) and, under ``'source'``, where its tuned knobs came from;
    ``candidates`` is the model's ranking when one ran (in-core impls on
    the CPU, kernel launches on the card).
    """
    impl: str
    source: str
    reason: str
    config: dict = dataclasses.field(default_factory=dict)
    score_us: float | None = None
    candidates: tuple = ()

    def token(self) -> str:
        """Compact ``source:impl`` form."""
        return f"{self.source}:{self.impl}"
