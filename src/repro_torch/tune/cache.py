"""Per-process LRU in front of the tuning table / cost model (a copy of
``repro.tune.cache``).

Every engine dispatch with ``tune != 'off'`` consults the oracle; the
oracle's own work (table lookup, candidate ranking) is cheap but not
free, and the serve tier calls it per coalesced group.  This bounded LRU
memoizes resolved decisions per (bucket key, mode, span) so the steady
state is one dict hit per dispatch.  ``Router.warmup`` pre-tunes the
declared buckets through the same entry point, so a warmed serving
process never ranks (let alone measures) on the request path.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

_MAX_ENTRIES = 512
_lock = threading.Lock()
_lru: "OrderedDict[tuple, object]" = OrderedDict()
_hits = 0
_misses = 0


def cached(key: tuple, compute):
    """Return the memoized value for ``key``, computing (and caching) it
    on a miss.  Thread-safe; ``compute`` runs outside the lock (a
    concurrent duplicate compute is harmless — last write wins)."""
    global _hits, _misses
    with _lock:
        if key in _lru:
            _lru.move_to_end(key)
            _hits += 1
            return _lru[key]
        _misses += 1
    val = compute()
    with _lock:
        _lru[key] = val
        _lru.move_to_end(key)
        while len(_lru) > _MAX_ENTRIES:
            _lru.popitem(last=False)
    return val


def clear_tuning_cache() -> None:
    """Drop every memoized decision (tests / after table re-records)."""
    global _hits, _misses
    with _lock:
        _lru.clear()
        _hits = 0
        _misses = 0


def cache_info() -> dict:
    with _lock:
        return {"entries": len(_lru), "hits": _hits, "misses": _misses,
                "max_entries": _MAX_ENTRIES}


def cache_keys() -> list:
    with _lock:
        return list(_lru.keys())
