"""The plain sDTW reference that decides ``correct``, in plain PyTorch.

It imports nothing of the program. Semantics, as the configurations
state them (int32 values, ``abs_diff``, saturating at ``INT_BIG``):

  * row 0 starts a path at any column: ``S[0, j] = |q0 - r_j|``;
  * column 0 accumulates: ``S[i, 0] = S[i-1, 0] + |q_i - r_0|``;
  * ``S[i, j] = |q_i - r_j| + min(S[i-1, j-1], S[i, j-1], S[i-1, j])``;
  * a banned column (the self-join's trivial-match zone) costs
    ``INT_BIG``, so no path below ``INT_BIG`` crosses it;
  * the answer is the minimum of the last row, its end the leftmost
    column holding it, its start the row-0 column where the best path
    into that cell began, ties on value going to the smaller start.

Each row is one first-order recurrence over the (min, +) semiring,
``x_j = min(u_j, x_{j-1} + d_j)`` with ``u_j = d_j + min(S[i-1, j-1],
S[i-1, j])``. With ``P_j`` the running sum of ``d`` it is
``x_j = P_j + min(L, min_{k <= j}(u_k - P_k))`` (``L`` the column left
of the slice), so a row is a ``cumsum`` and a ``cummin`` over int64.
A scan along the last dim runs in parallel over rows only, and a batch
holds few rows of a long series, so a row is scanned as segments of
``SEGMENT`` columns side by side, and then each segment takes the carry
of the segments before it.
Starts ride the value lexicographically: a cell is held as the key
``value << START_BITS | start``, whose integer order is the order of
(value, start), and adding a cost adds ``cost << START_BITS``.

The true answer of a query is below ``INT_BIG``; the program saturates
every cell at ``INT_BIG`` (``min(T, INT_BIG)`` cell by cell), which
leaves such answers and their spans as they are, so the two compare
exactly. The control, ``lanes=16``, runs the same recurrence in int16
lanes that saturate at ``BIG16`` (the program's rule scaled to 16 bits:
``BIG16 + BIG16`` still fits), row by row.
"""
from __future__ import annotations

import numpy as np
import torch

#: The program's saturation ceiling on int32 lanes (``INT_BIG + INT_BIG``
#: fits in int32); also the cost of a banned column.
INT_BIG = 2**29
#: The control's ceiling on int16 lanes, by the same rule.
BIG16 = 2**13
#: Columns of a segment of a row's scan.
SEGMENT = 4096
#: Bits under the value that hold a cell's start column (< 2**21).
START_BITS = 21
_START_MASK = (1 << START_BITS) - 1


def _scan(x, op):
    """The inclusive ``cumsum`` (``op`` "sum") or ``cummin`` ("min") of a
    (B, C) int64 tensor along its last dim, in segments of ``SEGMENT``
    columns."""
    def scan(t):
        return torch.cumsum(t, dim=1) if op == "sum" else \
            torch.cummin(t, dim=1).values
    b, c = x.shape
    if c <= SEGMENT:
        return scan(x)
    s = -(-c // SEGMENT)
    fill = 0 if op == "sum" else torch.iinfo(torch.int64).max
    x = torch.nn.functional.pad(x, (0, s * SEGMENT - c), value=fill)
    seg = scan(x.view(b * s, SEGMENT)).view(b, s, SEGMENT)
    carry = scan(seg[:, :-1, -1])[:, :, None]     # of segments 0 .. s-2
    if op == "sum":
        seg[:, 1:] += carry
    else:
        seg[:, 1:] = torch.minimum(seg[:, 1:], carry)
    return seg.view(b, s * SEGMENT)[:, :c]


def stratified(rng, items, count):
    """``count`` of ``items`` (a sorted array), one drawn from each of
    ``count`` runs of neighbours that together hold them all, so that a
    fault confined to a block of neighbours longer than a run is
    sampled."""
    count = min(count, len(items))
    edges = len(items) * np.arange(count + 1) // max(count, 1)
    at = edges[:-1] + (rng.random(count) * np.diff(edges)).astype(np.int64)
    return items[at]


def _row(u, d, left):
    """``x_j = min(u_j, x_{j-1} + d_j)`` along the last dim, entering with
    ``x_{-1} = left`` (a (B,) tensor, or None for no left column)."""
    p = _scan(d, "sum")
    m = _scan(u - p, "min")
    if left is not None:
        m = torch.minimum(m, left[:, None])
    return m + p


def _distance_row(qi, ref, banned, shift, ceiling):
    """(B, C) int64 costs ``|q_i - r_j|`` shifted into key space; banned
    columns cost ``ceiling``."""
    d = (qi[:, None] - ref[None, :]).abs_()
    if ceiling is not None:
        d.clamp_(max=ceiling)
    if banned is not None:
        d.masked_fill_(banned, INT_BIG if ceiling is None else ceiling)
    return d << shift if shift else d


class Scan:
    """The DP of a batch of queries (B, N) walked along a series slice by
    slice, carrying the boundary column (``edge``, (N, B) keys of the
    last column walked), so that any length fits and a caller can stop
    or repeat. ``spans`` tracks starts (columns under 2**21); ``lanes=16``
    is the control."""

    def __init__(self, queries, *, spans=False, lanes=32):
        if spans and lanes != 32:
            raise ValueError("the control tracks no starts")
        self.q = queries.to(torch.int64)
        self.ceiling = None if lanes == 32 else BIG16
        self.cap = INT_BIG if self.ceiling is None else self.ceiling
        self.shift = START_BITS if spans else 0
        self.edge = None

    def step(self, ref, j0, ban_lo=None, ban_hi=None):
        """Walk columns ``j0 ..`` holding ``ref``; ``ban_lo``/``ban_hi``
        (B,) ban columns ``[lo, hi)``. Returns the last row's keys
        (B, C) int64."""
        q, shift, ceiling = self.q, self.shift, self.ceiling
        b, n = q.shape
        dev = q.device
        ref = ref.to(torch.int64)
        cols = torch.arange(j0, j0 + ref.shape[0], device=dev)
        if shift and j0 + ref.shape[0] > _START_MASK:
            raise ValueError(f"spans need a series under 2**{START_BITS}")
        banned = None
        if ban_lo is not None:
            banned = ((cols[None, :] >= ban_lo.to(dev)[:, None])
                      & (cols[None, :] < ban_hi.to(dev)[:, None]))
        edge = self.edge
        new_edge = torch.empty((n, b), dtype=torch.int64, device=dev)
        prev = _distance_row(q[:, 0], ref, banned, shift, ceiling)
        if shift:
            prev |= cols[None, :]
        new_edge[0] = prev[:, -1]
        for i in range(1, n):
            d = _distance_row(q[:, i], ref, banned, shift, ceiling)
            diag_in = (edge[i - 1] if edge is not None
                       else torch.full((b,), 2**62, dtype=torch.int64,
                                       device=dev))
            diag = torch.cat([diag_in[:, None], prev[:, :-1]], dim=1)
            u = d + torch.minimum(diag, prev)
            prev = _row(u, d, None if edge is None else edge[i])
            if ceiling is not None:
                prev = prev.clamp_(max=ceiling).to(torch.int16).to(
                    torch.int64)
            new_edge[i] = prev[:, -1]
        self.edge = new_edge
        return prev

    def values(self, keys):
        """The values of keys, capped at the lanes' ceiling."""
        vals = keys >> self.shift if self.shift else keys
        return vals.clamp(max=self.cap)

    def starts(self, keys):
        return keys & _START_MASK


def sdtw_scan(queries, series, *, ban_lo=None, ban_hi=None, spans=False,
              chunk=None, lanes=32):
    """The sDTW of every query of ``queries`` (B, N) against ``series``
    (M,), both integer tensors on one device, walked in slices of
    ``chunk`` columns (default: one). ``ban_lo``/``ban_hi`` (B,) ban
    columns ``[lo, hi)`` per query; ``spans`` tracks starts; ``lanes=16``
    is the control. Returns ``(distance, end, start)`` as (B,) int64
    tensors (``start`` None without ``spans``), the distance capped at
    the lanes' ceiling."""
    scan = Scan(queries, spans=spans, lanes=lanes)
    b = queries.shape[0]
    m = series.shape[0]
    dev = queries.device
    chunk = m if chunk is None else int(chunk)
    best = torch.full((b,), scan.cap, dtype=torch.int64, device=dev)
    end = torch.full((b,), -1, dtype=torch.int64, device=dev)
    start = torch.full((b,), -1, dtype=torch.int64, device=dev) \
        if spans else None
    for j0 in range(0, m, chunk):
        keys = scan.step(series[j0:j0 + chunk], j0, ban_lo, ban_hi)
        v, at = scan.values(keys).min(dim=1)
        better = v < best
        best = torch.where(better, v, best)
        end = torch.where(better, at + j0, end)
        if spans:
            s = scan.starts(keys.gather(1, at[:, None])[:, 0])
            start = torch.where(better, s, start)
    return best, end, start

