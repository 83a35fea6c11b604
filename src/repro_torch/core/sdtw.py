"""In-core sDTW schedules in PyTorch.

Counterpart of ``repro.core.sdtw``. Two execution schemes, both in the
paper's linear-memory mapping (no N×M matrix is materialised):

``sdtw_wavefront``
    The paper-faithful anti-diagonal wavefront (MATSA §III-E): a loop over
    the N+M-1 anti-diagonals, vectorised along the diagonal.

``sdtw_rowscan``
    The row recurrence ``s[j] = d[j] + min(m[j], s[j-1])`` with
    ``m[j] = min(prev[j-1], prev[j])`` is a first-order linear recurrence
    over the (min,+) semiring, solved per row by a work-efficient prefix
    scan (``tropical_scan``) that applies its combines in the order of the
    reference's ``lax.associative_scan``, so results match it bitwise.

Where the reference ``vmap``s a one-query function, these functions take
an explicit batch: queries (B, N), per-query ``qlens``/``excl_lo``/
``excl_hi`` of shape (B,). The single-query entry points
(``sdtw_rowscan``, ``sdtw_wavefront``, ``sdtw_rowscan_chunk``) are the
batched ones at B = 1.

Match spans: every scheme can carry the start-pointer lane — the row-0
reference column where each cell's best path began, as a lexicographic
``(value, start)`` pair (``distances.lex_min``). Start values are
unspecified when the distance saturates at BIG.

Exclusion zones ban a column range ``[excl_lo, excl_hi)`` per query.
"""
from __future__ import annotations

from typing import Optional

import torch

from .distances import (INT_FAR, accum_dtype, big, lex_min,
                        pointwise_distance, result_dtype, sat_add,
                        tropical_combine, tropical_combine_span)
from .topk import topk_init, topk_merge


# ---------------------------------------------------------------------------
# The (min,+) prefix scan along the reference.
# ---------------------------------------------------------------------------

def tropical_scan(a, u, su=None):
    """Inclusive prefix scan of f_j(x) = min(u_j, a_j + x) along the last
    dimension: after it, ``u[j]`` is the row value assuming no left
    boundary and ``a[j]`` the saturated sum of ``a[0..j]``, so the caller
    folds a left boundary x in as ``min(u, a + x)``. With ``su`` (a start
    lane) the u-component carries it lexicographically. Returns
    ``(a, u, su)``.

    The combines are applied in exactly the order of
    ``jax.lax.associative_scan`` (pairwise reduction, recursion on the
    half, fix-up of the even positions), so results are bitwise the
    reference's even where they are order-dependent: float32 sums, and
    the start lane of cells saturated at BIG, where lexicographic ties
    among saturated values depend on the bracketing."""
    if su is None:
        def combine(left, right):
            return list(tropical_combine(tuple(left), tuple(right)))
        return (*_odd_even_scan([a, u], combine), None)

    def combine(left, right):
        return list(tropical_combine_span(tuple(left), tuple(right)))
    return tuple(_odd_even_scan([a, u, su], combine))


def _odd_even_scan(elems, combine):
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = combine([e[..., 0:-1:2] for e in elems],
                      [e[..., 1::2] for e in elems])
    odd = _odd_even_scan(reduced, combine)
    tail = [e[..., 2::2] for e in elems]
    even = combine([o[..., :-1] for o in odd] if n % 2 == 0 else odd, tail)
    even = [torch.cat([e[..., :1], r], dim=-1) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        x = torch.empty(ev.shape[:-1] + (n,), dtype=ev.dtype, device=ev.device)
        x[..., 0::2] = ev
        x[..., 1::2] = od
        out.append(x)
    return out


def shift_right(x, fill):
    """x[..., j-1] at lane j; ``fill`` (a tensor broadcastable to
    x[..., :1], or a scalar) enters lane 0."""
    if not isinstance(fill, torch.Tensor):
        fill = torch.full_like(x[..., :1], fill)
    return torch.cat([fill.expand_as(x[..., :1]), x[..., :-1]], dim=-1)


def _col(x, nq: int, fill: int, device):
    """Per-query int32 (nq, 1) column from None / scalar / (nq,)."""
    if x is None:
        x = fill
    t = torch.as_tensor(x).to(device=device, dtype=torch.int32)
    return t.reshape(-1, 1).expand(nq, 1)


def _one(x):
    """A single query's scalar argument as a (1,) batch (None stays)."""
    return None if x is None else torch.as_tensor(x).reshape(1)


def _masked_distance(qi, ref, metric, excl_lo, excl_hi, BIG, j):
    """(B, C) distance row of query samples ``qi`` (B, 1) against ``ref``
    with banned columns (global index ``j``) set to BIG."""
    d = pointwise_distance(qi, ref[None, :], metric)
    banned = (j >= excl_lo) & (j < excl_hi)
    return torch.where(banned, BIG, d)


# ---------------------------------------------------------------------------
# Row-scan — beyond-paper.
# ---------------------------------------------------------------------------

def rowscan_batch(queries, reference, qlens=None, metric: str = "abs_diff",
                  excl_lo=None, excl_hi=None, return_spans: bool = False):
    """Batched row-scan: (B, N) queries against an (M,) reference.

    Returns ``(best (B,), end (B,), start (B,) | None)``: the minimum over
    row ``qlen - 1``, its leftmost column, and (spans) its start."""
    acc = accum_dtype(result_dtype(queries, reference))
    BIG = big(acc)
    nq, n = queries.shape
    m = reference.shape[0]
    dev = queries.device
    qlen = _col(n if qlens is None else qlens, nq, n, dev)
    lo = _col(excl_lo, nq, -1, dev)
    hi = _col(excl_hi, nq, -1, dev)
    j = torch.arange(m, device=dev)[None, :]

    prev = _masked_distance(queries[:, :1], reference, metric, lo, hi, BIG, j)
    one = (qlen == 1)[:, 0]
    best = torch.where(one, prev.min(dim=1).values,
                       torch.tensor(BIG, dtype=acc, device=dev))
    pos = torch.where(one, prev.argmin(dim=1).to(torch.int32), -1)
    pstart = j.to(torch.int32).expand(nq, m) if return_spans else None
    start = torch.where(one, pos, -1) if return_spans else None

    for i in range(1, n):
        d = _masked_distance(queries[:, i:i + 1], reference, metric, lo, hi,
                             BIG, j)
        prev_sh = shift_right(prev, BIG)
        if return_spans:
            mn, mns = lex_min(prev_sh, shift_right(pstart, INT_FAR), prev,
                              pstart)
        else:
            mn, mns = torch.minimum(prev_sh, prev), None
        u = sat_add(d, mn)
        u[:, 0] = sat_add(prev[:, 0], d[:, 0])      # column-0 accumulation
        if return_spans:
            mns[:, 0] = pstart[:, 0]
        a = d.clone()
        a[:, 0] = BIG
        _, s, sstart = tropical_scan(a, u, mns)
        hit = (qlen == i + 1)[:, 0]
        jj = s.argmin(dim=1)
        best = torch.where(hit, torch.minimum(best, s.min(dim=1).values),
                           best)
        pos = torch.where(hit, jj.to(torch.int32), pos)
        if return_spans:
            start = torch.where(hit, sstart.gather(1, jj[:, None])[:, 0],
                                start)
            pstart = sstart
        prev = s
    return best, pos, start


def sdtw_rowscan(query, reference, qlen=None, metric: str = "abs_diff",
                 excl_lo=None, excl_hi=None, return_position: bool = False,
                 return_spans: bool = False):
    """sDTW distance of one (N,) query via per-row tropical scans.

    Returns the scalar distance, ``(distance, end)`` with
    ``return_position``, or ``(distance, start, end)`` with
    ``return_spans``."""
    best, pos, start = rowscan_batch(
        query[None, :], reference, _one(qlen), metric, _one(excl_lo),
        _one(excl_hi), return_spans)
    if return_spans:
        return best[0], start[0], pos[0]
    return (best[0], pos[0]) if return_position else best[0]


# ---------------------------------------------------------------------------
# Anti-diagonal wavefront — paper-faithful (MATSA §III-E).
# ---------------------------------------------------------------------------

def wavefront_batch(queries, reference, qlens=None, metric: str = "abs_diff",
                    excl_lo=None, excl_hi=None, return_spans: bool = False):
    """Batched anti-diagonal wavefront. Diagonal k holds cells (i, j) with
    i + j = k, indexed by i; the last two diagonals are the state. Row
    ``qlen - 1`` meets diagonal k at column ``k - qlen + 1`` and k
    ascends, so a strict improvement test keeps the leftmost end.

    Returns ``(best (B,), end (B,), start (B,) | None)``."""
    acc = accum_dtype(result_dtype(queries, reference))
    BIG = big(acc)
    nq, n = queries.shape
    m = reference.shape[0]
    dev = queries.device
    qlen = _col(n if qlens is None else qlens, nq, n, dev)
    lo = _col(excl_lo, nq, -1, dev)
    hi = _col(excl_hi, nq, -1, dev)
    q = queries.to(accum_dtype(queries.dtype))
    r_pad = torch.cat([torch.zeros(n - 1, dtype=reference.dtype, device=dev),
                       reference,
                       torch.zeros(n, dtype=reference.dtype, device=dev)])
    i_idx = torch.arange(n, device=dev)[None, :]
    row0 = i_idx == 0

    dm1 = torch.full((nq, n), BIG, dtype=acc, device=dev)
    dm2 = dm1.clone()
    sm1 = torch.full((nq, n), INT_FAR, dtype=torch.int32, device=dev)
    sm2 = sm1.clone()
    best = torch.full((nq,), BIG, dtype=acc, device=dev)
    pos = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    start = pos.clone()
    for k in range(n + m - 1):
        j_idx = k - i_idx
        valid = (j_idx >= 0) & (j_idx < m) & (i_idx < qlen)
        r_rev = r_pad[k:k + n].flip(0)[None, :]
        d = pointwise_distance(q, r_rev.to(acc), metric)
        d = torch.where((j_idx >= lo) & (j_idx < hi), BIG, d)
        at_last = (i_idx == qlen - 1) & valid
        if return_spans:
            mv, ms = lex_min(shift_right(dm2, BIG), shift_right(sm2, INT_FAR),
                             shift_right(dm1, BIG), shift_right(sm1, INT_FAR))
            mv, ms = lex_min(mv, ms, dm1, sm1)
            cur = torch.where(valid, torch.where(row0, d, sat_add(d, mv)), BIG)
            curs = torch.where(valid, torch.where(row0, j_idx.to(torch.int32),
                                                  ms), INT_FAR)
            lstart = torch.where(at_last, curs, INT_FAR).min(dim=1).values
            dm2, sm2, dm1, sm1 = dm1, sm1, cur, curs
        else:
            mins = torch.minimum(torch.minimum(shift_right(dm2, BIG),
                                               shift_right(dm1, BIG)), dm1)
            cur = torch.where(valid, torch.where(row0, d, sat_add(d, mins)),
                              BIG)
            dm2, dm1 = dm1, cur
        lmin = torch.where(at_last, cur, BIG).min(dim=1).values
        improve = lmin < best
        pos = torch.where(improve, (k - qlen[:, 0] + 1).to(torch.int32), pos)
        if return_spans:
            start = torch.where(improve, lstart, start)
        best = torch.minimum(best, lmin)
    return best, pos, (start if return_spans else None)


def sdtw_wavefront(query, reference, qlen=None, metric: str = "abs_diff",
                   excl_lo=None, excl_hi=None, return_position: bool = False,
                   return_spans: bool = False):
    """sDTW distance of one (N,) query via the anti-diagonal wavefront
    (MATSA's schedule); returns as ``sdtw_rowscan``."""
    best, pos, start = wavefront_batch(
        query[None, :], reference, _one(qlen), metric, _one(excl_lo),
        _one(excl_hi), return_spans)
    if return_spans:
        return best[0], start[0], pos[0]
    return (best[0], pos[0]) if return_position else best[0]


# ---------------------------------------------------------------------------
# Chunked reference streaming (boundary-column carry).
#
# The reference is processed in tiles; between tiles only the O(N)
# boundary column S[:, tile_end] is carried — MATSA's inter-subarray pass
# gates (§III-B). In span / top-K mode the carry gains the start lane and
# the heap holds (dist, end, start) triples.
# ---------------------------------------------------------------------------

def sdtw_carry_init(nq: int, n: int, acc, track_start: bool = False,
                    device=None):
    """Fresh chunk carry: ``(bcol (nq, N), best (nq,))``, or
    ``(bcol, bstart, best)`` with ``track_start``. BIG everywhere = no
    reference columns seen yet; the start lane is seeded with INT_FAR."""
    BIG = big(acc)
    bcol = torch.full((nq, n), BIG, dtype=acc, device=device)
    best = torch.full((nq,), BIG, dtype=acc, device=device)
    if track_start:
        return (bcol, torch.full((nq, n), INT_FAR, dtype=torch.int32,
                                 device=device), best)
    return bcol, best


def rowscan_chunk_batch(queries, ref_chunk, bcol, best, qlens=None, j0=0,
                        m_total=None, metric: str = "abs_diff", excl_lo=None,
                        excl_hi=None, return_lastrow: bool = False,
                        bstart=None, clen=None):
    """One reference chunk of the row-scan for a (B, N) batch, entered and
    exited via the carry (``repro.core.sdtw.sdtw_rowscan_chunk``, batched).

    ``bcol`` (B, N) is the boundary column S[:, j0 - 1]; ``best`` (B,) the
    running best. Columns outside ``[0, m_total)`` and inside
    ``[excl_lo, excl_hi)`` are banned. ``clen`` (the chunk's true column
    count) makes the returned boundary S[:, j0 + clen - 1]. ``bstart``
    switches on the start lane.

    Returns ``(new_bcol, new_best[, lastrow])`` or, with ``bstart``,
    ``(new_bcol, new_bstart, new_best[, lastrow, lastrow_starts])``.
    """
    track = bstart is not None
    acc = accum_dtype(result_dtype(queries, ref_chunk))
    BIG = big(acc)
    nq, n = queries.shape
    c = ref_chunk.shape[0]
    dev = queries.device
    pick = c - 1 if clen is None else int(clen) - 1
    qlen = _col(n if qlens is None else qlens, nq, n, dev)
    m_total = j0 + c if m_total is None else m_total
    lo = _col(excl_lo, nq, -1, dev)
    hi = _col(excl_hi, nq, -1, dev)
    bcol = bcol.to(acc)
    best = best.to(acc)
    j = j0 + torch.arange(c, device=dev)[None, :]
    outside = (j >= m_total) | (j < 0)

    def dist(i):
        d = _masked_distance(queries[:, i:i + 1], ref_chunk, metric, lo, hi,
                             BIG, j)
        return torch.where(outside, BIG, d)

    s = dist(0)                                     # row 0: free start
    sstart = j.to(torch.int32).expand(nq, c) if track else None
    one = (qlen == 1)[:, 0]
    best = torch.where(one, torch.minimum(best, s.min(dim=1).values), best)
    lrow = torch.where(one[:, None], s, BIG) if return_lastrow else None
    lstart = sstart if (return_lastrow and track) else None
    exits = [s[:, pick].clone()]          # copies, not views: rows are freed
    sexits = [sstart[:, pick].clone()] if track else None
    if track:
        bstart = bstart.to(torch.int32)
    for i in range(1, n):
        d = dist(i)
        prev_sh = shift_right(s, bcol[:, i - 1:i])
        if track:
            mn, mns = lex_min(prev_sh, shift_right(sstart, bstart[:, i - 1:i]),
                              s, sstart)
            a_p, u_p, su_p = tropical_scan(d, sat_add(d, mn), mns)
            s, sstart = lex_min(u_p, su_p, sat_add(a_p, bcol[:, i:i + 1]),
                                bstart[:, i:i + 1])
        else:
            a_p, u_p, _ = tropical_scan(d, sat_add(d, torch.minimum(prev_sh,
                                                                    s)))
            s = torch.minimum(u_p, sat_add(a_p, bcol[:, i:i + 1]))
        hit = (qlen == i + 1)[:, 0]
        best = torch.where(hit, torch.minimum(best, s.min(dim=1).values),
                           best)
        if return_lastrow:
            lrow = torch.where(hit[:, None], s, lrow)
            if track:
                lstart = torch.where(hit[:, None], sstart, lstart)
        exits.append(s[:, pick].clone())
        if track:
            sexits.append(sstart[:, pick].clone())
    new_bcol = torch.stack(exits, dim=1)
    if track:
        new_bstart = torch.stack(sexits, dim=1)
        if return_lastrow:
            return new_bcol, new_bstart, best, lrow, lstart
        return new_bcol, new_bstart, best
    if return_lastrow:
        return new_bcol, best, lrow
    return new_bcol, best


def sdtw_rowscan_chunk(query, ref_chunk, bcol, best, qlen=None, j0=0,
                       m_total=None, metric: str = "abs_diff", excl_lo=None,
                       excl_hi=None, return_lastrow: bool = False,
                       bstart=None, clen=None):
    """``rowscan_chunk_batch`` for one (N,) query with an (N,) boundary
    column and a scalar best — the reference's single-query signature."""
    out = rowscan_chunk_batch(
        query[None, :], ref_chunk, bcol[None, :],
        torch.as_tensor(best).reshape(1), _one(qlen), j0, m_total, metric,
        _one(excl_lo), _one(excl_hi), return_lastrow,
        None if bstart is None else bstart[None, :], clen)
    return tuple(o[0] for o in out)


def sdtw_chunk_batch(queries, ref_chunk, qlens, carry, j0, m_total,
                     metric: str, excl_lo, excl_hi, clen=None):
    """Advance the batched carry by one chunk. ``carry`` is
    ``(bcol (nq, N), best (nq,))`` or, with the start lane,
    ``(bcol, bstart, best)`` — the lane is tracked iff it is present."""
    if len(carry) == 3:
        bcol, bstart, best = carry
        return rowscan_chunk_batch(queries, ref_chunk, bcol, best, qlens, j0,
                                   m_total, metric, excl_lo, excl_hi,
                                   bstart=bstart, clen=clen)
    bcol, best = carry
    return rowscan_chunk_batch(queries, ref_chunk, bcol, best, qlens, j0,
                               m_total, metric, excl_lo, excl_hi, clen=clen)


def sdtw_chunk_batch_topk(queries, ref_chunk, qlens, carry, j0, m_total,
                          metric: str, excl_lo, excl_hi, k: int, excl_zone,
                          excl_span: bool = False, track_start: bool = False,
                          clen=None, return_lastrow: bool = False):
    """Advance the top-K carry by one chunk: ``(bcol, best, top_d, top_p,
    top_s)`` or, with ``track_start``, ``(bcol, bstart, best, top_d,
    top_p, top_s)``. The chunk's last DP row is folded into the heap
    (``topk_merge``; ``excl_zone`` per query). ``return_lastrow`` appends
    the (nq, C) candidate row (and its start lane when tracked)."""
    c = ref_chunk.shape[0]
    pos = j0 + torch.arange(c, dtype=torch.int32, device=queries.device)
    if track_start:
        bcol, bstart, best, top_d, top_p, top_s = carry
        nbc, nbs, nbe, lrow, lstart = rowscan_chunk_batch(
            queries, ref_chunk, bcol, best, qlens, j0, m_total, metric,
            excl_lo, excl_hi, return_lastrow=True, bstart=bstart, clen=clen)
        heap = topk_merge(top_d, top_p, top_s, lrow, pos, lstart, k,
                          excl_zone, excl_span)
        out = (nbc, nbs, nbe, *heap)
        return out + (lrow, lstart) if return_lastrow else out
    if excl_span:
        raise ValueError("span-overlap suppression needs the start lane")
    bcol, best, top_d, top_p, top_s = carry
    nbc, nbe, lrow = rowscan_chunk_batch(
        queries, ref_chunk, bcol, best, qlens, j0, m_total, metric, excl_lo,
        excl_hi, return_lastrow=True, clen=clen)
    heap = topk_merge(top_d, top_p, top_s, lrow, pos, torch.full_like(pos, -1),
                      k, excl_zone)
    out = (nbc, nbe, *heap)
    return out + (lrow,) if return_lastrow else out


def topk_fold_lastrow(heap, lastrow, lstarts, j0, k: int, excl_zone,
                      excl_span: bool = False):
    """Fold a batched (nq, C) candidate row — the DP's row ``qlen - 1``
    over global columns ``[j0, j0 + C)``, as the kernel's last-row capture
    emits it — into the top-K heap with the same ``topk_merge`` the
    row-scan streaming path runs. ``lstarts`` is ``None`` when spans are
    not tracked (the heap's start lane then stays -1)."""
    hd, hp, hs = heap
    c = lastrow.shape[1]
    pos = j0 + torch.arange(c, dtype=torch.int32, device=lastrow.device)
    if lstarts is None:
        lstarts = torch.full_like(lastrow, -1, dtype=torch.int32)
    return topk_merge(hd.to(lastrow.dtype), hp, hs, lastrow, pos, lstarts,
                      k, excl_zone, excl_span)


def default_excl_zone(qlens):
    """Default suppression radius: half the *true* query length, per query
    (at least 1)."""
    return torch.clamp(torch.as_tensor(qlens, dtype=torch.int32) // 2, min=1)


def sdtw_segment_topk(queries, segment, qlens, carry, j0, m_total,
                      metric: str, chunk: int, excl_lo, excl_hi, k: int,
                      excl_zone, excl_span: bool = False,
                      track_start: bool = False):
    """``sdtw_segment`` with the top-K heap riding the chunk carry."""
    for t in range(segment.shape[0] // chunk):
        carry = sdtw_chunk_batch_topk(
            queries, segment[t * chunk:(t + 1) * chunk], qlens, carry,
            j0 + t * chunk, m_total, metric, excl_lo, excl_hi, k, excl_zone,
            excl_span, track_start)
    return carry


def sdtw_segment(queries, segment, qlens, carry, j0, m_total, metric: str,
                 chunk: int, excl_lo, excl_hi):
    """Stream a reference segment (a multiple of ``chunk`` long) through
    the carry in ``chunk``-sized tiles. Memory is O(nq·N + nq·chunk)."""
    for t in range(segment.shape[0] // chunk):
        carry = sdtw_chunk_batch(queries, segment[t * chunk:(t + 1) * chunk],
                                 qlens, carry, j0 + t * chunk, m_total, metric,
                                 excl_lo, excl_hi)
    return carry


def sdtw_chunked(queries, reference, qlens=None, metric: str = "abs_diff",
                 chunk: int = 4096, excl_lo=None, excl_hi=None,
                 top_k: Optional[int] = None, excl_zone=None,
                 return_positions: bool = False, return_spans: bool = False,
                 excl_mode: str = "end"):
    """Batched sDTW over an arbitrarily long reference in bounded memory.

    The reference is padded to a multiple of ``chunk`` and streamed tile
    by tile; only the (nq, N) boundary column (plus, in top-K mode, the
    heap) is carried. ``top_k=k`` returns ``(dists (nq, k), positions
    (nq, k))`` best first, matches suppressed by ``excl_zone`` (default
    half of each query's true length, or 0 with ``excl_mode='span'``).
    ``return_positions`` alone returns the top-1 pair unstacked;
    ``return_spans`` inserts the start lane: ``(dists, starts, ends)``.
    """
    nq, n = queries.shape
    m = reference.shape[0]
    dev = queries.device
    acc = accum_dtype(result_dtype(queries, reference))
    if qlens is None:
        qlens = torch.full((nq,), n, dtype=torch.int32, device=dev)
    qlens = torch.as_tensor(qlens, dtype=torch.int32, device=dev)
    n_tiles = -(-m // chunk)
    r_pad = torch.nn.functional.pad(reference, (0, n_tiles * chunk - m))
    if top_k is None and not (return_positions or return_spans):
        carry = sdtw_carry_init(nq, n, acc, device=dev)
        _, best = sdtw_segment(queries, r_pad, qlens, carry, 0, m, metric,
                               chunk, excl_lo, excl_hi)
        return best
    k = 1 if top_k is None else top_k
    if excl_zone is None:
        zone = (default_excl_zone(qlens) if excl_mode == "end"
                else torch.zeros(nq, dtype=torch.int32, device=dev))
    else:
        zone = torch.as_tensor(excl_zone, dtype=torch.int32,
                               device=dev).expand(nq)
    track = return_spans or excl_mode == "span"
    carry = (sdtw_carry_init(nq, n, acc, track_start=track, device=dev)
             + topk_init(nq, k, acc, device=dev))
    out = sdtw_segment_topk(queries, r_pad, qlens, carry, 0, m, metric, chunk,
                            excl_lo, excl_hi, k, zone,
                            excl_span=(excl_mode == "span"),
                            track_start=track)
    top_d, top_p, top_s = out[-3:]
    if top_k is None:                       # top-1, unstacked
        if return_spans:
            return top_d[:, 0], top_s[:, 0], top_p[:, 0]
        return top_d[:, 0], top_p[:, 0]
    if return_spans:
        return top_d, top_s, top_p
    return top_d, top_p


# ---------------------------------------------------------------------------
# Batched front-ends.
# ---------------------------------------------------------------------------

_IMPLS = {"rowscan": rowscan_batch, "wavefront": wavefront_batch}


def sdtw_batch(queries, reference, qlens=None, metric: str = "abs_diff",
               impl: str = "rowscan", excl_lo=None, excl_hi=None,
               return_positions: bool = False, return_spans: bool = False):
    """Batched sDTW: (nq, N) queries against a shared (M,) reference.
    Returns (nq,) distances, ``(dists, ends)`` with ``return_positions``,
    or ``(dists, starts, ends)`` with ``return_spans``."""
    best, pos, start = _IMPLS[impl](queries, reference, qlens, metric,
                                    excl_lo, excl_hi, return_spans)
    if return_spans:
        return best, start, pos
    return (best, pos) if return_positions else best


def self_join_windows(reference, window: int, stride: int = 1):
    """Sliding windows of the reference (the self-join mode), with their
    start positions in **sample** units."""
    m = reference.shape[0]
    starts = torch.arange(0, m - window + 1, stride, dtype=torch.int32,
                          device=reference.device)
    idx = starts[:, None] + torch.arange(window, device=reference.device)
    return reference[idx], starts


def self_join_exclusion(starts, window: int, zone: int = None):
    """Trivial-match exclusion band per self-join window, in sample units:
    ``[s - zone, s + window + zone)`` with ``zone`` defaulting to
    ``window // 2``. Returns int32 ``(excl_lo, excl_hi)``."""
    starts = torch.as_tensor(starts, dtype=torch.int32)
    z = window // 2 if zone is None else int(zone)
    return torch.clamp(starts - z, min=0), starts + (window + z)
