"""Per-request traces and router-level stats for the serve tier.

A copy of ``repro.serve.telemetry`` (pure Python).

Every admitted request carries a ``RequestTrace`` through its life:
enqueue → dispatch (when the batcher pulled it into a merged engine
call) → complete (result or error delivered to the client future). The
``Telemetry`` aggregator folds finished traces into a running store the
router exposes as an immutable ``StatsSnapshot`` — the numbers NATSA-
style serving cares about: queue depth seen at admission, microbatch
occupancy (how many client requests each engine dispatch amortized),
and the latency split between waiting and computing.

Memory is bounded: the latency/queue-wait/batch-size sample stores are
ring buffers of the most recent ``window`` observations (default 8192),
so a long-running router neither leaks nor re-sorts an ever-growing
list at ``snapshot()``. Snapshot semantics under the bound:

  * counters (``completed``, ``errors``, ``rejected``, ``shed``,
    ``deduped``, …) and the ``mean_*`` fields are exact over the
    router's whole lifetime (running sums, never sampled);
  * the ``p50_*``/``p99_*`` percentiles are computed over the last
    ``window`` samples only (``latency_samples`` reports how many are
    currently held) — a sliding-window view, which is what a latency
    SLO wants anyway.

All timestamps are ``time.monotonic()`` floats (seconds); snapshots
report microseconds, matching the benchmark harness row units.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

#: Default sample-window length for the percentile ring buffers.
DEFAULT_SAMPLE_WINDOW = 8192


def _now() -> float:
    return time.monotonic()


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    if not values:
        return float("nan")
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return float(vs[idx])


@dataclasses.dataclass
class RequestTrace:
    """Lifecycle timestamps + context for one admitted request."""
    op: str
    nq: int                          # queries carried by this request
    t_enqueue: float = dataclasses.field(default_factory=_now)
    t_dispatch: Optional[float] = None
    t_complete: Optional[float] = None
    queue_depth: int = 0             # depth observed at admission
    batch_requests: int = 0          # requests sharing the merged call
    batch_queries: int = 0           # total queries in the merged call
    error: bool = False

    def mark_dispatch(self, *, batch_requests: int, batch_queries: int):
        self.t_dispatch = _now()
        self.batch_requests = batch_requests
        self.batch_queries = batch_queries

    def mark_complete(self, *, error: bool = False):
        self.t_complete = _now()
        self.error = error

    @property
    def queue_us(self) -> float:
        if self.t_dispatch is None:
            return float("nan")
        return (self.t_dispatch - self.t_enqueue) * 1e6

    @property
    def latency_us(self) -> float:
        if self.t_complete is None:
            return float("nan")
        return (self.t_complete - self.t_enqueue) * 1e6


@dataclasses.dataclass(frozen=True)
class StatsSnapshot:
    """Immutable view of the router's counters at one instant."""
    completed: int
    errors: int
    rejected: int                   # refused at the door (QueueFull)
    shed: int                       # admitted, then evicted for a
                                    # higher-priority arrival (reject)
    deduped: int                    # answered from another request's
                                    # identical in-window engine call
    cancelled: int                  # client cancelled before delivery
    unserved_on_close: int          # failed by close(drain=False)
    dispatches: int                 # merged engine calls issued
    coalesced_requests: int         # requests that shared a dispatch
    queries_served: int
    p50_latency_us: float
    p99_latency_us: float
    mean_latency_us: float          # exact (running sum, not windowed)
    p50_queue_us: float
    max_queue_depth: int
    mean_batch_requests: float      # requests per dispatch (occupancy)
    mean_batch_queries: float       # queries per dispatch
    windows: int                    # coalescing windows dispatched
    window_early_closes: int        # windows closed by a full bucket
    mean_window_ms: float           # mean realized window duration
    latency_samples: int            # samples currently in the p50/p99
                                    # ring (≤ sample_window)
    sample_window: int              # ring-buffer bound (config)
    uptime_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Telemetry:
    """Thread-safe aggregator of finished ``RequestTrace`` records.

    ``window`` bounds the percentile sample stores (see the module
    docstring for the exact snapshot semantics under the bound).
    """

    def __init__(self, *, window: int = DEFAULT_SAMPLE_WINDOW):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = threading.Lock()
        self._t0 = _now()
        self._window = int(window)
        self._latencies = collections.deque(maxlen=self._window)
        self._queue_waits = collections.deque(maxlen=self._window)
        self._completed = 0
        self._errors = 0
        self._rejected = 0
        self._shed = 0
        self._deduped = 0
        self._cancelled = 0
        self._unserved = 0
        self._dispatches = 0
        self._coalesced = 0
        self._queries = 0
        self._max_depth = 0
        self._latency_sum = 0.0
        self._batch_requests_sum = 0
        self._batch_queries_sum = 0
        self._windows = 0
        self._window_early = 0
        self._window_sum_s = 0.0

    def observe_depth(self, depth: int):
        with self._lock:
            self._max_depth = max(self._max_depth, depth)

    def record_reject(self):
        with self._lock:
            self._rejected += 1

    def record_shed(self):
        with self._lock:
            self._shed += 1

    def record_cancelled(self, trace: Optional[RequestTrace] = None):
        with self._lock:
            self._cancelled += 1

    def record_unserved(self, n: int = 1):
        with self._lock:
            self._unserved += n

    def record_dispatch(self, *, n_requests: int, n_queries: int,
                        n_deduped: int = 0):
        with self._lock:
            self._dispatches += 1
            self._batch_requests_sum += n_requests
            self._batch_queries_sum += n_queries
            self._deduped += n_deduped
            if n_requests > 1:
                self._coalesced += n_requests

    def record_complete(self, trace: RequestTrace):
        with self._lock:
            self._completed += 1
            self._queries += trace.nq
            if trace.error:
                self._errors += 1
            lat = trace.latency_us
            self._latency_sum += lat
            self._latencies.append(lat)
            if trace.t_dispatch is not None:
                self._queue_waits.append(trace.queue_us)

    def record_window(self, *, duration_s: float, closed_early: bool):
        with self._lock:
            self._windows += 1
            self._window_sum_s += duration_s
            if closed_early:
                self._window_early += 1

    def snapshot(self) -> StatsSnapshot:
        with self._lock:
            return StatsSnapshot(
                completed=self._completed,
                errors=self._errors,
                rejected=self._rejected,
                shed=self._shed,
                deduped=self._deduped,
                cancelled=self._cancelled,
                unserved_on_close=self._unserved,
                dispatches=self._dispatches,
                coalesced_requests=self._coalesced,
                queries_served=self._queries,
                p50_latency_us=percentile(self._latencies, 50),
                p99_latency_us=percentile(self._latencies, 99),
                mean_latency_us=(self._latency_sum / self._completed
                                 if self._completed else float("nan")),
                p50_queue_us=percentile(self._queue_waits, 50),
                max_queue_depth=self._max_depth,
                mean_batch_requests=(self._batch_requests_sum
                                     / self._dispatches
                                     if self._dispatches else float("nan")),
                mean_batch_queries=(self._batch_queries_sum
                                    / self._dispatches
                                    if self._dispatches else float("nan")),
                windows=self._windows,
                window_early_closes=self._window_early,
                mean_window_ms=(self._window_sum_s / self._windows * 1e3
                                if self._windows else float("nan")),
                latency_samples=len(self._latencies),
                sample_window=self._window,
                uptime_s=_now() - self._t0)
