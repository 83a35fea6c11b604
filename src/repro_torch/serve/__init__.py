"""``repro_torch.serve`` — the admission-controlled serving tier over the
port's sDTW engine (counterpart of ``repro.serve``), on the card by
default.

One router amortizes what every caller used to own alone: built kernels
and tuning decisions, the envelope cache, and the DP dispatch itself
(concurrent requests coalesce into the engine's ragged power-of-two
buckets — one dispatch per bucket per microbatch window). Queue elements
are the frozen ``SdtwRequest`` objects of ``repro_torch.core.request``,
so serve-tier tenants and direct ``engine.sdtw``/``search_topk`` callers
hit byte-identical argument semantics and results.

``python -m repro_torch.serve`` runs the closed-loop offered-load CLI.
"""
from .batcher import execute_group, group_window
from .pool import DevicePool
from .queue import AdmissionQueue, QueueFull
from .router import Router, RouterConfig
from .sessions import StreamSessionPool
from .telemetry import RequestTrace, StatsSnapshot, Telemetry

__all__ = [
    "AdmissionQueue",
    "DevicePool",
    "QueueFull",
    "RequestTrace",
    "Router",
    "RouterConfig",
    "StatsSnapshot",
    "StreamSessionPool",
    "Telemetry",
    "execute_group",
    "group_window",
]
