"""A pool of streaming sessions multiplexed over shared reference feeds.

Counterpart of ``repro.serve.sessions`` over
``repro_torch.stream.StreamSession``: each session lives on its
request's device (the card by default) and is fed there.

Online monitoring under serving: many tenants watch the *same* arriving
reference stream (one sensor feed, N monitoring queries). The pool keys
sessions by feed, so one ``feed()`` call advances every tenant attached
to that feed — each tenant keeps its own ``StreamSession`` (its own
queries, top-K heaps, alerts), but the arriving chunk is shared and the
per-chunk work amortizes across the pool exactly like the offline
batcher amortizes queries.

Tenant churn semantics (pinned by tests):

  * attach mid-feed → the new session starts at the *current* stream
    position; it only scores data fed after attachment (a monitoring
    query cannot retroactively see history it was not subscribed for —
    replay from a ``snapshot()`` if catch-up is needed).
  * detach → finalizes that tenant's session and returns its results;
    the feed keeps flowing for the others.
  * ``snapshot()``/``restore()`` round-trip the whole feed (every
    tenant) through flat npz-ready dicts — sessions continue
    bit-for-bit, the same fault-tolerance contract as a single
    ``StreamSession``.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core.request import StreamRequest


class StreamSessionPool:
    """``feed_key → {tenant → StreamSession}`` with shared feeding."""

    def __init__(self):
        self._lock = threading.Lock()
        self._feeds: dict = {}

    # ------------------------------------------------------------------
    # tenant lifecycle
    # ------------------------------------------------------------------

    def attach(self, feed_key, tenant, request: Optional[StreamRequest]
               = None, **stream_kwargs):
        """Open a session for ``tenant`` on ``feed_key`` and return it.

        Pass a prebuilt ``StreamRequest`` or the ``engine.stream``
        keyword surface (validated by the shared validator — unknown
        kwargs are rejected loudly)."""
        if request is None:
            request = StreamRequest.from_kwargs(**stream_kwargs)
        elif stream_kwargs:
            raise ValueError("pass a StreamRequest or stream kwargs, "
                             "not both")
        session = request.open()
        with self._lock:
            tenants = self._feeds.setdefault(feed_key, {})
            if tenant in tenants:
                raise ValueError(f"tenant {tenant!r} is already attached "
                                 f"to feed {feed_key!r}; detach it first")
            tenants[tenant] = session
        return session

    def detach(self, feed_key, tenant, *, finalize: bool = True):
        """Remove ``tenant`` from the feed; returns its finalized
        ``StreamResult`` (or the raw session with ``finalize=False``)."""
        with self._lock:
            session = self._feeds[feed_key].pop(tenant)
            if not self._feeds[feed_key]:
                del self._feeds[feed_key]
        if not finalize:
            return session
        return session.results()

    def session(self, feed_key, tenant):
        with self._lock:
            return self._feeds[feed_key][tenant]

    def tenants(self, feed_key) -> list:
        with self._lock:
            return sorted(self._feeds.get(feed_key, {}))

    def feeds(self) -> list:
        with self._lock:
            return sorted(self._feeds, key=repr)

    # ------------------------------------------------------------------
    # the shared feed
    # ------------------------------------------------------------------

    def feed(self, feed_key, data) -> int:
        """Advance every tenant on ``feed_key`` by one arriving slice;
        returns the number of sessions fed."""
        with self._lock:
            sessions = list(self._feeds.get(feed_key, {}).values())
        for s in sessions:
            s.feed(data)
        return len(sessions)

    def finalize(self, feed_key) -> dict:
        """Collect every tenant's results (``StreamSession.results()``
        applies the buffered tail non-destructively) and drop the feed;
        returns ``{tenant: StreamResult}``."""
        with self._lock:
            tenants = self._feeds.pop(feed_key, {})
        return {t: s.results() for t, s in tenants.items()}

    # ------------------------------------------------------------------
    # snapshot / restore (whole-feed fault tolerance)
    # ------------------------------------------------------------------

    def snapshot(self, feed_key) -> dict:
        """``{tenant: flat-npz-dict}`` for every tenant on the feed."""
        with self._lock:
            tenants = dict(self._feeds.get(feed_key, {}))
        return {t: s.snapshot() for t, s in tenants.items()}

    def restore(self, feed_key, snaps: dict, *, session_cls=None,
                **restore_kwargs) -> list:
        """Rebuild a feed from ``snapshot()`` output; returns the
        restored tenant names. ``session_cls`` overrides the session
        type (default ``StreamSession``)."""
        if session_cls is None:
            from repro_torch.stream import StreamSession
            session_cls = StreamSession
        restored = {t: session_cls.restore(snap, **restore_kwargs)
                    for t, snap in snaps.items()}
        with self._lock:
            tenants = self._feeds.setdefault(feed_key, {})
            dup = sorted(set(tenants) & set(restored))
            if dup:
                raise ValueError(f"tenant(s) {dup} already attached to "
                                 f"feed {feed_key!r}")
            tenants.update(restored)
        return sorted(restored)
