"""Bounded admission queue — the router's backpressure boundary.

A copy of ``repro.serve.queue`` (pure Python).

A request is *admitted* (enqueued with its client future) or *refused*
at the door; once admitted it will always be answered (result,
exception, or — under the ``'reject'`` policy with priorities — a
``QueueFull`` delivered through its future when a higher-priority
arrival sheds it). Clients therefore handle ``QueueFull`` in exactly
two places: synchronously at submission, or as the failure of an
already-returned future. Two admission policies:

  * ``'reject'`` — a full queue sheds the **lowest-priority pending**
    request when the arrival outranks it (the shed item is returned to
    the caller, who fails its future), else raises ``QueueFull``
    immediately (load-shedding; the closed-loop benchmark measures
    goodput as completed/offered under this policy).
  * ``'block'``  — a full queue blocks the submitting thread until space
    frees or ``timeout`` elapses (then ``QueueFull``), propagating
    backpressure into the client. Blocking admission never sheds.

Scheduling: ``put`` records a ``priority`` (higher drains sooner) and a
``tenant`` (per-tenant pending quota via ``tenant_quota``; quota
overruns always reject — blocking on your *own* backlog would deadlock
a closed-loop client). ``drain`` pops in **effective-priority** order::

    effective(entry) = priority + age_seconds // aging_s

so with ``aging_s`` set (default 0.5 s) every parked request gains one
priority class per interval and low-priority tenants are
starvation-free: anything old enough eventually outranks fresh
high-priority traffic. Ties drain FIFO. ``aging_s=None`` disables
aging (strict priority). Shedding picks the *lowest* effective
priority, newest first, so aged requests are also shed last.

``weight`` (the request's query count) feeds ``wait_weight`` — the
adaptive coalescing window's "a power-of-two bucket has filled, close
now" signal.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional


class QueueFull(RuntimeError):
    """The admission queue refused a request (bounded depth reached)."""


class _Entry:
    __slots__ = ("item", "priority", "tenant", "weight", "seq", "t")

    def __init__(self, item, priority, tenant, weight, seq):
        self.item = item
        self.priority = priority
        self.tenant = tenant
        self.weight = weight
        self.seq = seq
        self.t = time.monotonic()


class AdmissionQueue:
    """Bounded priority queue of pending requests with block/reject
    admission, per-tenant quotas, and drain-time priority aging."""

    def __init__(self, maxsize: int = 256, *, admission: str = "block",
                 timeout: Optional[float] = None,
                 tenant_quota: Optional[int] = None,
                 aging_s: Optional[float] = 0.5):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', got "
                             f"{admission!r}")
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(f"tenant_quota must be >= 1, got "
                             f"{tenant_quota}")
        if aging_s is not None and aging_s <= 0:
            raise ValueError(f"aging_s must be > 0 (or None to disable "
                             f"aging), got {aging_s}")
        self.maxsize = maxsize
        self.admission = admission
        self.timeout = timeout
        self.tenant_quota = tenant_quota
        self.aging_s = aging_s
        self._entries: list[_Entry] = []
        self._weight = 0
        self._per_tenant: dict[Any, int] = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def pending_weight(self) -> int:
        with self._lock:
            return self._weight

    def _effective(self, entry: _Entry, now: float) -> float:
        if self.aging_s is None:
            return entry.priority
        return entry.priority + int((now - entry.t) / self.aging_s)

    def _remove(self, entry: _Entry):
        self._entries.remove(entry)
        self._weight -= entry.weight
        n = self._per_tenant.get(entry.tenant, 0) - 1
        if n <= 0:
            self._per_tenant.pop(entry.tenant, None)
        else:
            self._per_tenant[entry.tenant] = n

    def put(self, item, *, priority: int = 0, tenant: Any = None,
            weight: int = 1):
        """Admit ``item``; returns ``(depth, shed_item)`` — the queue
        depth observed *after* admission (telemetry) and, under the
        reject policy, a previously admitted lower-priority item that
        was evicted to make room (``None`` otherwise; the caller owns
        failing its future). Raises ``QueueFull`` per the policy."""
        with self._not_full:
            if self._closed:
                raise RuntimeError("router is closed")
            if self.tenant_quota is not None \
                    and self._per_tenant.get(tenant, 0) >= self.tenant_quota:
                raise QueueFull(
                    f"tenant {tenant!r} quota reached ({self.tenant_quota} "
                    "pending); await completions or raise tenant_quota")
            shed = None
            if self.admission == "reject":
                if len(self._entries) >= self.maxsize:
                    now = time.monotonic()
                    victim = min(self._entries,
                                 key=lambda e: (self._effective(e, now),
                                                -e.seq))
                    if self._effective(victim, now) >= priority:
                        raise QueueFull(
                            f"admission queue full ({self.maxsize} "
                            "pending); retry later or raise max_queue")
                    self._remove(victim)
                    shed = victim.item
            else:
                ok = self._not_full.wait_for(
                    lambda: self._closed
                    or len(self._entries) < self.maxsize,
                    timeout=self.timeout)
                if not ok:
                    raise QueueFull(
                        f"admission queue full ({self.maxsize} pending) "
                        f"after blocking {self.timeout}s")
                if self._closed:
                    raise RuntimeError("router is closed")
            entry = _Entry(item, priority, tenant, weight, self._seq)
            self._seq += 1
            self._entries.append(entry)
            self._weight += entry.weight
            self._per_tenant[tenant] = self._per_tenant.get(tenant, 0) + 1
            depth = len(self._entries)
            self._not_empty.notify_all()
            return depth, shed

    def drain(self, max_items: Optional[int] = None) -> list:
        """Pop up to ``max_items`` pending items in effective-priority
        order (aged priority desc, then FIFO)."""
        with self._not_full:
            now = time.monotonic()
            order = sorted(self._entries,
                           key=lambda e: (-self._effective(e, now), e.seq))
            if max_items is not None:
                order = order[:max_items]
            for e in order:
                self._remove(e)
            if order:
                self._not_full.notify_all()
            return [e.item for e in order]

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        """Block until at least one item is pending (or the queue closes).
        Returns True if items are pending."""
        with self._not_empty:
            self._not_empty.wait_for(
                lambda: self._closed or len(self._entries) > 0,
                timeout=timeout)
            return len(self._entries) > 0

    def wait_weight(self, threshold: int, deadline: float) -> bool:
        """Block until the total pending weight (queries) reaches
        ``threshold``, the queue closes, or ``time.monotonic()`` passes
        ``deadline``. Returns True iff the threshold was reached — the
        adaptive window's early-close signal."""
        with self._not_empty:
            while self._weight < threshold and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            return self._weight >= threshold

    def close(self):
        """Wake every waiter; subsequent ``put`` raises."""
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
