"""The admission-controlled request router — the serve tier's front door.

Counterpart of ``repro.serve.router``, over the port's engine: requests
run on their ``device`` (the card by default), pinned per worker by the
``DevicePool``.

Life of a request::

    client ──► submit() ──► AdmissionQueue (priority + quota) ──►
    adaptive microbatch window ──► group by coalesce_key ──► dedup ──►
    DevicePool worker ──► ONE ragged engine call per group
    (pow-2 buckets inside) ──► slice per client ──► Future.result()

``submit()`` validates through the shared ``SdtwRequest`` validator
(invalid arguments are refused at the door, synchronously — never
queued), applies backpressure per the admission policy (``QueueFull``;
under ``'reject'`` a higher-priority arrival may instead shed the
lowest-priority pending request, whose future then fails with
``QueueFull``), and returns a ``concurrent.futures.Future``. A
background dispatcher drains adaptive coalescing windows and hands each
group to the device pool; ``auto_dispatch=False`` gives deterministic
manual control (tests and the closed-loop benchmark call ``drain()``
themselves).

The adaptive window (replacing PR 7's fixed ``window_ms`` sleep):

  * **closes early** the moment the pending query count reaches
    ``window_full_queries`` (a power-of-two engine bucket has filled —
    waiting longer only spills into the next bucket while every parked
    client pays the wait), snapping the window back to ``window_ms``;
  * **stretches** (doubling, up to ``window_max_ms``) when a window
    expires nearly empty — under light load a longer window buys
    coalescing without hurting an idle queue.

Lifecycle contract: once admitted, a request is ALWAYS answered —
result, execution error, shed-``QueueFull``, or (``close(drain=False)``)
a ``RuntimeError("router closed before dispatch")``; futures never hang.

Shared across every tenant: one ``EnvelopeCache`` (injected into search
requests that did not bring their own), the process's built kernels and
tuning decisions (coalesced groups reuse one tuned bucket shape per
window), one ``StreamSessionPool``, one ``Telemetry``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core.request import SdtwRequest, StreamRequest
from repro_torch.search.cache import EnvelopeCache

from . import batcher
from .pool import DevicePool
from .queue import AdmissionQueue, QueueFull
from .sessions import StreamSessionPool
from .telemetry import RequestTrace, StatsSnapshot, Telemetry

__all__ = ["Router", "RouterConfig", "QueueFull"]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Serving knobs (defaults favour low latency over occupancy)."""
    max_queue: int = 256          # admission bound (backpressure depth)
    window_ms: float = 2.0        # base microbatch coalescing window
    admission: str = "block"      # 'block' | 'reject' on a full queue
    block_timeout_s: Optional[float] = None   # None = wait forever
    auto_dispatch: bool = True    # background dispatcher thread
    # --- scheduling --------------------------------------------------
    tenant_quota: Optional[int] = None  # max pending per tenant
    aging_s: Optional[float] = 0.5      # priority aging interval
                                        # (None = strict priority)
    max_window_requests: Optional[int] = None  # per-drain cap (highest
                                               # effective priority first)
    # --- adaptive window ---------------------------------------------
    window_full_queries: int = 64  # close early at this many pending
                                   # queries (a pow-2 bucket target)
    window_max_ms: Optional[float] = None  # stretch bound under light
                                           # load (None = 8 x window_ms)
    # --- dispatch ----------------------------------------------------
    devices: Any = None           # None | 'all' | int | device sequence
    dedup: bool = True            # in-window identical-request dedup
    telemetry_window: int = 8192  # percentile ring-buffer bound


def _request_nq(req: SdtwRequest) -> int:
    q = req.queries
    if isinstance(q, (list, tuple)):
        return len(q)
    shape = getattr(q, "shape", None)
    shape = np.shape(q) if shape is None else tuple(shape)
    return 1 if len(shape) == 1 else shape[0]


class Router:
    """Admission queue + microbatcher + device pool + shared caches
    over the engine."""

    def __init__(self, config: Optional[RouterConfig] = None, *,
                 cache: Optional[EnvelopeCache] = None, **overrides):
        if config is None:
            config = RouterConfig(**overrides)
        elif overrides:
            raise ValueError("pass a RouterConfig or keyword overrides, "
                             "not both")
        self.config = config
        self.cache = EnvelopeCache() if cache is None else cache
        self.telemetry = Telemetry(window=config.telemetry_window)
        self.sessions = StreamSessionPool()
        self._queue = AdmissionQueue(config.max_queue,
                                     admission=config.admission,
                                     timeout=config.block_timeout_s,
                                     tenant_quota=config.tenant_quota,
                                     aging_s=config.aging_s)
        self._pool = DevicePool(config.devices)
        self._dispatch_lock = threading.Lock()
        self._closed = False
        self._thread = None
        if config.auto_dispatch:
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name="repro-torch-serve-dispatch",
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, request=None, **kwargs) -> concurrent.futures.Future:
        """Admit one request; returns its Future.

        Accepts a prebuilt ``SdtwRequest`` or the kwargs surface
        (``op='sdtw'`` default; unknown keys rejected loudly). Invalid
        arguments raise here — at the door — with exactly the front-door
        error messages; a full queue raises ``QueueFull`` (or, under the
        reject policy, sheds a pending lower-priority request — its
        future fails with ``QueueFull`` instead)."""
        if self._closed:
            raise RuntimeError("router is closed")
        if request is None:
            request = SdtwRequest.from_kwargs(**kwargs)
        elif kwargs:
            raise ValueError("pass an SdtwRequest or kwargs, not both")
        request.validate()
        if getattr(request, "explain", False):
            raise ValueError(
                "explain=True is not servable: a coalesced batch has no "
                "single per-request dispatch decision; call engine.sdtw "
                "directly for the DispatchDecision")
        if request.op == "search_topk" and request.cache is None:
            request = dataclasses.replace(request, cache=self.cache)
        trace = RequestTrace(op=request.op, nq=_request_nq(request))
        fut = concurrent.futures.Future()
        pending = batcher.Pending(request=request, future=fut, trace=trace)
        try:
            depth, shed = self._queue.put(pending,
                                          priority=request.priority,
                                          tenant=request.tenant,
                                          weight=trace.nq)
        except QueueFull:
            self.telemetry.record_reject()
            raise
        if shed is not None:
            self._fail_pending(
                shed,
                QueueFull("request shed from the admission queue by a "
                          "higher-priority arrival; retry later or raise "
                          "max_queue"))
            self.telemetry.record_shed()
        trace.queue_depth = depth
        self.telemetry.observe_depth(depth)
        return fut

    @staticmethod
    def _fail_pending(pending, exc):
        """Fail one admitted-but-undispatched request, tolerating a
        client that already cancelled its future."""
        if pending.future.set_running_or_notify_cancel():
            pending.trace.mark_complete(error=True)
            pending.future.set_exception(exc)

    def warmup(self, request=None, **kwargs) -> int:
        """Run one representative request on EVERY pool device (blocking,
        sequential) and prime the shape-affinity map.

        A serving process calls this before accepting traffic so no
        client request pays a kernel build or a tuning decision, or
        queues behind the warm set's backlog-gated growth. Shape the
        request like the coalesced buckets your windows will form — e.g.
        a list of ``window_full_queries`` serving-length queries against
        the production reference. Returns the number of devices warmed.

        It pre-*tunes* first: every pow-2 bucket the request's queries
        dispatch as is resolved through the ``repro_torch.tune`` oracle
        (under ``tune='measure'`` the measured search runs here, at
        warmup — never on the request path)."""
        if self._closed:
            raise RuntimeError("router is closed")
        if request is None:
            request = SdtwRequest.from_kwargs(**kwargs)
        elif kwargs:
            raise ValueError("pass an SdtwRequest or kwargs, not both")
        request.validate()
        if request.op == "search_topk" and request.cache is None:
            request = dataclasses.replace(request, cache=self.cache)
        from repro_torch.tune import pretune_request
        pretune_request(request)
        return self._pool.warmup(request)

    # Blocking conveniences — the offline call signatures, served.
    def sdtw(self, queries, reference, qlens=None, **kw):
        return self.submit(queries=queries, reference=reference,
                           qlens=qlens, op="sdtw", **kw).result()

    def search_topk(self, queries, reference, k: int = 1, **kw):
        return self.submit(queries=queries, reference=reference,
                           top_k=k, op="search_topk", **kw).result()

    # ------------------------------------------------------------------
    # streaming tenants
    # ------------------------------------------------------------------

    def open_stream(self, feed_key, tenant, request:
                    Optional[StreamRequest] = None, **stream_kwargs):
        """Attach a streaming tenant to a reference feed (see
        ``StreamSessionPool``); search-style pruned sessions share the
        router's envelope cache unless they bring their own."""
        if request is None:
            if stream_kwargs.get("prune") and "cache" not in stream_kwargs:
                stream_kwargs["cache"] = self.cache
            request = StreamRequest.from_kwargs(**stream_kwargs)
        elif stream_kwargs:
            raise ValueError("pass a StreamRequest or stream kwargs, "
                             "not both")
        return self.sessions.attach(feed_key, tenant, request)

    def feed(self, feed_key, data) -> int:
        return self.sessions.feed(feed_key, data)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def drain(self, *, wait: bool = True) -> int:
        """Dispatch every pending request now (one microbatch window,
        capped at ``max_window_requests`` in effective-priority order);
        returns the number of requests dispatched. Groups go to the
        device pool; with ``wait`` (the default) the call blocks until
        the pool has answered every submitted group — the deterministic
        manual-mode workhorse. ``wait=False`` (the dispatch loop) lets
        the next window accrue while devices are still computing."""
        with self._dispatch_lock:
            window = self._queue.drain(self.config.max_window_requests)
            n = len(window)
            if window:
                groups = batcher.group_window(window,
                                              dedup=self.config.dedup)
                for grp in groups:
                    n_members = sum(1 for _ in batcher.group_members(grp))
                    self.telemetry.record_dispatch(
                        n_requests=n_members,
                        n_queries=sum(len(p.entries) for p in grp),
                        n_deduped=n_members - len(grp))
                    self._pool.submit(grp, self.telemetry)
        if wait:
            self._pool.join()
        return n

    def _dispatch_loop(self):
        cfg = self.config
        base = cfg.window_ms / 1000.0
        wmax = (cfg.window_max_ms / 1000.0 if cfg.window_max_ms is not None
                else 8.0 * base)
        window = base
        while not self._closed:
            if not self._queue.wait_nonempty(timeout=0.1):
                continue
            t_open = time.monotonic()
            full = self._queue.wait_weight(cfg.window_full_queries,
                                           t_open + window)
            duration = time.monotonic() - t_open
            n = self.drain(wait=False)
            self.telemetry.record_window(duration_s=duration,
                                         closed_early=full)
            if full:
                window = base            # heavy load: tight windows —
                                         # buckets fill on their own
            elif n <= 1:
                window = min(wmax, 2.0 * window)   # light load: stretch
                                                   # to buy coalescing
            else:
                window = base

    # ------------------------------------------------------------------
    # lifecycle / observability
    # ------------------------------------------------------------------

    def stats(self) -> StatsSnapshot:
        return self.telemetry.snapshot()

    def close(self, *, drain: bool = True):
        """Stop admitting, then settle every admitted request: with
        ``drain`` (the default) everything still queued is dispatched
        and answered; with ``drain=False`` still-queued futures fail
        with ``RuntimeError('router closed before dispatch')`` (counted
        as ``unserved_on_close``). Either way, groups already handed to
        the device pool run to completion — no future is ever left
        hanging."""
        if self._closed:
            return
        self._closed = True
        self._queue.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if drain:
            self.drain()
        else:
            orphans = self._queue.drain()
            for p in orphans:
                self._fail_pending(
                    p, RuntimeError("router closed before dispatch"))
            if orphans:
                self.telemetry.record_unserved(len(orphans))
        self._pool.join()
        self._pool.close()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc):
        self.close()
