"""Per-reference envelope cache for the serving loop.

Counterpart of ``repro.search.cache``. A deployment serves many query
batches against few, long-lived references, so the pruning cascade's only
per-reference precomputation — the per-chunk [min, max] envelope — is
cached across requests.

Keys: callers SHOULD pass a stable ``key=`` (e.g. a dataset name).
Without one, a content fingerprint is derived from the array's shape,
dtype and a sample of its values (about 1 KB copied to the host; on a
CUDA tensor that is one small device→host copy per uncached call). Like
any sample-based fingerprint it is collidable by adversarial inputs; the
explicit key is the production path.

Entries are whatever produced them: tensors on the reference's device
from ``chunk_envelope``, numpy arrays from a stream's ``extend``/``put``.
``lb_cascade`` takes either.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.device import to_numpy

from .lower_bounds import chunk_envelope


class EnvelopeCache:
    """Maps (reference key, chunk size) → per-chunk envelope arrays."""

    def __init__(self):
        self._store = {}
        self.hits = 0
        self.misses = 0

    def envelope(self, reference, chunk: int, key=None):
        """Cached ``chunk_envelope(reference, chunk)``.

        A cached entry only counts as a hit when its tile count matches
        this reference's — a streamed entry that stopped mid-reference
        must not gate pruning over chunks it never saw; it is recomputed
        and replaced instead.
        """
        full_key = (self._fingerprint(reference) if key is None else key,
                    int(chunk))
        t = -(-int(reference.shape[0]) // int(chunk))
        hit = self._store.get(full_key)
        if hit is not None and len(hit[0]) == t:
            self.hits += 1
            return hit
        self.misses += 1
        env = chunk_envelope(reference, chunk)
        self._store[full_key] = env
        return env

    def extend(self, key, chunk: int, mins, maxs, at=None):
        """Append per-chunk envelope rows under ``(key, chunk)`` as a
        stream's tiles arrive (numpy, in chunk order).

        ``at`` is the writer's global tile index for ``mins[0]``: when the
        entry already holds ``at`` tiles the rows append; when it holds
        more, another session already streamed this prefix and the rows
        are dropped; when it holds fewer there is a gap, and the entry is
        dropped entirely (``envelope()`` recomputes on demand). A streamed
        envelope requires an explicit key.
        """
        if key is None:
            raise ValueError("extend() requires an explicit key — a stream "
                             "has no materialized array to fingerprint")
        full_key = (key, int(chunk))
        mins = to_numpy(mins)
        maxs = to_numpy(maxs)
        cur = self._store.get(full_key)
        cur_len = 0 if cur is None else len(cur[0])
        if at is not None:
            if cur_len > int(at):
                return                     # prefix already present
            if cur_len < int(at):
                self._store.pop(full_key, None)   # gap — drop, recompute
                return
        if cur is not None:
            mins = np.concatenate([to_numpy(cur[0]), mins])
            maxs = np.concatenate([to_numpy(cur[1]), maxs])
        self._store[full_key] = (mins, maxs)

    def peek(self, key, chunk: int):
        """The cached entry under ``(key, chunk)``, or None — does not
        compute and does not count as a hit/miss."""
        return self._store.get((key, int(chunk)))

    def put(self, key, chunk: int, mins, maxs):
        """Install an envelope wholesale under ``(key, chunk)``, replacing
        any partial entry — the restore path of a streamed session."""
        if key is None:
            raise ValueError("put() requires an explicit key")
        self._store[(key, int(chunk))] = (to_numpy(mins), to_numpy(maxs))

    def clear(self):
        self._store.clear()

    def __len__(self):
        return len(self._store)

    @staticmethod
    def _fingerprint(reference):
        reference = torch.as_tensor(reference)
        m = int(reference.shape[0])
        # Strided sample covering the whole array, dense head/tail and
        # global sum/min/max reductions, computed where the reference
        # lives; only ~1 KB crosses to the host.
        stride = max(1, m // 256)
        parts = (reference[::stride][:257], reference[:min(64, m)],
                 reference[max(0, m - 64):],
                 torch.stack([reference.sum(dtype=torch.float32),
                              reference.min().to(torch.float32),
                              reference.max().to(torch.float32)]))
        h = hashlib.sha1()
        h.update(str((m, str(reference.dtype), stride)).encode())
        for part in parts:
            h.update(to_numpy(part).tobytes())
        return h.hexdigest()


#: Module-level default used by ``search_topk`` when no cache is passed —
#: gives repeat requests against the same reference envelope reuse.
DEFAULT_CACHE = EnvelopeCache()
