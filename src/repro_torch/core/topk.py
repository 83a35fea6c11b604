"""Fixed-size top-K match heaps with exclusion-zone suppression.

PyTorch counterpart of ``repro.core.topk`` (the heap primitives only; the
matrix-profile reductions come with the self-join slice). A heap is a
triple of fixed-shape tensors

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
