"""Fixed-size top-K match heaps with exclusion-zone suppression.

PyTorch counterpart of ``repro.core.topk``: the heap primitives, and
the matrix profile's host-side motif and discord reductions
(``mutual_nearest_pairs``, ``discord_select``, numpy as in the
reference). A heap is a triple of fixed-shape tensors

    (distances (nq, k), end_positions (nq, k), start_positions (nq, k))

sorted ascending by distance, padded with ``(BIG, -1, -1)``. Selection is
greedy best-first: take the lowest remaining distance (leftmost on ties),
then suppress every candidate too close to it — by end distance
(``|end - picked_end| <= excl_zone``, the default) or by span overlap
(``excl_span=True``: the picked span widened by ``excl_zone`` on both
sides). Saturated candidates (distance ≥ BIG) are never reported.

Unlike the reference, which ``vmap``s a per-query function, these work on
an explicit leading batch dimension: ``scores`` is (nq, C), ``excl_zone``
a scalar or (nq,).
"""
from __future__ import annotations

import numpy as np
import torch

from .distances import big


def topk_init(nq: int, k: int, acc, device=None):
    """Empty batched heap: ((nq, k) BIG distances, (nq, k) -1 end
    positions, (nq, k) -1 start positions)."""
    return (torch.full((nq, k), big(acc), dtype=acc, device=device),
            torch.full((nq, k), -1, dtype=torch.int32, device=device),
            torch.full((nq, k), -1, dtype=torch.int32, device=device))


def topk_select(scores, positions, starts, k: int, excl_zone,
                excl_span: bool = False):
    """K rounds of select-then-suppress over each query's candidate row.

    Args:
      scores:    (nq, C) candidate distances (BIG = absent/banned).
      positions: (nq, C) or (C,) global end positions of the candidates.
      starts:    (nq, C) or (C,) global start positions.
      k:         heap size.
      excl_zone: suppression radius, scalar or (nq,).
      excl_span: suppress on span overlap instead of end distance.

    Returns (nq, k) distances ascending + (nq, k) ends + (nq, k) starts,
    (BIG, -1, -1)-padded.
    """
    BIG = big(scores.dtype)
    nq = scores.shape[0]
    positions = positions.expand(nq, -1)
    starts = starts.expand(nq, -1)
    zone = torch.as_tensor(excl_zone, dtype=torch.int32,
                           device=scores.device).reshape(-1, 1)
    out_d, out_p, out_s = [], [], []
    for _ in range(k):
        idx = torch.argmin(scores, dim=1, keepdim=True)   # leftmost on ties
        d = torch.gather(scores, 1, idx)
        live = d < BIG
        p = torch.where(live, torch.gather(positions, 1, idx), -1)
        s = torch.where(live, torch.gather(starts, 1, idx), -1)
        if excl_span:
            hit = (starts <= p + zone) & (positions >= s - zone)
        else:
            hit = torch.abs(positions - p) <= zone
        scores = torch.where(live & hit, BIG, scores)
        out_d.append(torch.where(live, d, BIG).to(scores.dtype))
        out_p.append(p.to(torch.int32))
        out_s.append(s.to(torch.int32))
    return (torch.cat(out_d, dim=1), torch.cat(out_p, dim=1),
            torch.cat(out_s, dim=1))


def topk_merge(heap_d, heap_p, heap_s, scores, positions, starts, k: int,
               excl_zone, excl_span: bool = False):
    """Fold a fresh (nq, C) candidate row into an (nq, k) heap.

    The heap's entries come first in the concatenation, so on exact ties
    the earlier (lower-position, earlier-chunk) match wins — which keeps
    the streamed top-1 bitwise-equal to the one-shot ``argmin``.
    """
    nq = heap_d.shape[0]
    d = torch.cat([heap_d, scores.to(heap_d.dtype)], dim=1)
    p = torch.cat([heap_p, positions.to(torch.int32).expand(nq, -1)], dim=1)
    s = torch.cat([heap_s, starts.to(torch.int32).expand(nq, -1)], dim=1)
    return topk_select(d, p, s, k, excl_zone, excl_span)


# ----------------------------------------------------------------------
# Matrix-profile reductions over a finished nearest-neighbor table.
#
# The per-window heaps above are device code riding carries; these two
# consume the *host-side* profile that ``repro_torch.search.profile``
# assembles from them — an O(nw) numpy pass, tiny next to the DP. Both are
# the same greedy select-then-suppress convention, with suppression
# measured in sample units over window start positions, so stride > 1
# self-joins never collapse the band to window-index spacing. Invalid
# entries (no admissible neighbor: dist is BIG/inf/nan or the neighbor
# index is -1) are never selected — padding is (-1, -1, inf) for motifs
# and (-1, -inf) for discords.
# ----------------------------------------------------------------------


def mutual_nearest_pairs(nn_dist, nn_window, starts, k: int, excl_zone):
    """Greedy top-K motif pairs: mutually-nearest, exclusion-distinct.

    Args:
      nn_dist:   (nw,) each window's nearest-neighbor distance (float;
                 inf/nan = no admissible neighbor).
      nn_window: (nw,) index of each window's nearest neighbor (-1 = none).
      starts:    (nw,) window start positions in samples.
      k:         pairs to report.
      excl_zone: suppression radius in samples — once a pair is picked, any
                 candidate pair with a member window starting within
                 ``excl_zone`` samples of either picked member is dropped.

    A pair (i, j) is a candidate iff ``nn_window[i] == j`` and
    ``nn_window[j] == i`` (each is the other's nearest neighbor). sDTW
    self-join distances are direction-dependent — window i aligned over
    the series near j need not cost the same as window j aligned near i —
    so the pair is ranked by ``min(nn_dist[i], nn_dist[j])``, the cheaper
    direction. Ties break toward the smaller (i, j).

    Returns ``(a_idx, b_idx, dist)`` int64/int64/float64 arrays of shape
    (k,), ``a_idx < b_idx``, padded with ``(-1, -1, inf)``.
    """
    nn_dist = np.asarray(nn_dist, np.float64)
    nn_window = np.asarray(nn_window, np.int64)
    starts = np.asarray(starts, np.int64)
    nw = nn_dist.shape[0]
    ok = (nn_window >= 0) & np.isfinite(nn_dist)
    i_all = np.arange(nw)
    mutual = ok & (nn_window < nw) & (i_all < nn_window)
    mutual &= np.where(mutual, nn_window[np.clip(nn_window, 0, nw - 1)]
                       == i_all, False)
    a = i_all[mutual]
    b = nn_window[mutual]
    d = np.minimum(nn_dist[a], nn_dist[b])
    order = np.lexsort((b, a, d))        # distance, then smaller (i, j)
    a, b, d = a[order], b[order], d[order]

    out_a = np.full((k,), -1, np.int64)
    out_b = np.full((k,), -1, np.int64)
    out_d = np.full((k,), np.inf, np.float64)
    alive = np.ones(a.shape[0], bool)
    zone = int(excl_zone)
    for slot in range(k):
        idx = np.nonzero(alive)[0]
        if not idx.size:
            break
        pick = idx[0]
        out_a[slot], out_b[slot], out_d[slot] = a[pick], b[pick], d[pick]
        for member in (a[pick], b[pick]):
            near_a = np.abs(starts[a] - starts[member]) <= zone
            near_b = np.abs(starts[b] - starts[member]) <= zone
            alive &= ~(near_a | near_b)
    return out_a, out_b, out_d


def discord_select(nn_dist, starts, k: int, excl_zone):
    """Greedy top-K discords: the windows whose nearest admissible
    neighbor is *farthest* (the matrix-profile anomaly rule), suppressed
    within ``excl_zone`` samples of each pick so the K reported anomalies
    are distinct events. Invalid entries (inf/nan ``nn_dist`` — e.g. a
    fully-banned window, which would otherwise masquerade as the largest
    anomaly) are never reported.

    Returns ``(idx, dist)`` of shape (k,), best (largest) first, padded
    with ``(-1, -inf)``.
    """
    nn_dist = np.asarray(nn_dist, np.float64)
    starts = np.asarray(starts, np.int64)
    score = np.where(np.isfinite(nn_dist), nn_dist, -np.inf)
    out_i = np.full((k,), -1, np.int64)
    out_d = np.full((k,), -np.inf, np.float64)
    zone = int(excl_zone)
    if not score.size:
        return out_i, out_d
    for slot in range(k):
        pick = int(np.argmax(score))     # leftmost on ties
        if not np.isfinite(score[pick]):
            break
        out_i[slot], out_d[slot] = pick, score[pick]
        score[np.abs(starts - starts[pick]) <= zone] = -np.inf
    return out_i, out_d
