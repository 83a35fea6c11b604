"""Top-K pruned subsequence search and the matrix profile on the port's
sDTW engine.

``search_topk`` is the query-answering layer: lower-bound pruning
(LB_Kim / LB_Keogh over a cached per-chunk envelope) in front of the
chunk-carry DP — on the card, the hand-written kernel's last-row capture
— returning the K best, exclusion-zone-distinct matches per query.
``matrix_profile`` is the self-join on top of it (motifs and discords),
its trivial-match zones the kernel's per-query column ban on the card.
"""
from .cache import DEFAULT_CACHE, EnvelopeCache
from .lower_bounds import (chunk_envelope, lb_cascade, windowed_envelope,
                           znorm, znorm_padded)
from .profile import ProfileResult, matrix_profile
from .search import SearchResult, default_chunk, search_topk

__all__ = [
    "search_topk", "SearchResult", "default_chunk",
    "matrix_profile", "ProfileResult",
    "EnvelopeCache", "DEFAULT_CACHE",
    "chunk_envelope", "windowed_envelope", "lb_cascade",
    "znorm", "znorm_padded",
]
