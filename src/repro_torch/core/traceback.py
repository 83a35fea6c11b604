"""Alignment-path traceback in bounded memory — the anomaly-localization
subsystem.

The port's own copy of ``repro.core.traceback``: host numpy, no JAX and
no torch, so both packages trace back identically.

The engine's span mode (``engine.sdtw(..., return_spans=True)``) reports
*where* the best alignment of a query lies in the reference: a
``(distance, start, end)`` triple. This module recovers the full monotone
warping path between those endpoints — which reference sample each query
sample aligned to — the output NATSA-style TSA pipelines and the paper's
anomaly workloads (§I, §V) actually consume.

The algorithm is a checkpoint-and-replay (Hirschberg-style divide) over
the ``[start, end]`` reference window only — the DP is *re-run*, never
stored globally:

  1. Forward sweep over the window, column by column, keeping one O(N)
     column alive and checkpointing the boundary column at every
     ``chunk``-th column — exactly the boundary-column carry the streaming
     engine hands between tiles.
  2. Backward sweep, last block first: each (N × chunk) block is rebuilt
     from its entry checkpoint and the path is traced through it to the
     block's left edge, then the block is dropped.

Peak memory is O(N·chunk) for the live block plus O(N·S/chunk) for the
checkpoints (S = window width ≤ span) — never O(N·M) and never O(N·S)
materialised at once.

Semantics match the engine bitwise:

  * The window DP pins the free-start row to the reported ``start`` column
    (row 0 is finite only at ``start``), so the path replayed is a
    minimum-cost alignment from ``(0, start)`` to ``(qlen-1, end)`` whose
    accumulated cost reproduces the reported distance — bitwise for int32
    (saturating adds are exact) and for integer-valued float32; for
    general float32 the engine's lanes accumulate in tree order
    (associative scan / Hillis-Steele) while the replay is sequential, so
    the two agree only to float32 ULPs — compare with a tolerance there.
  * Predecessor ties during traceback break diagonal-first, then left,
    then up — the deterministic convention the test oracle shares.

Saturated results (distance ≥ BIG) carry no meaningful span and are
rejected.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .distances import INT_BIG

#: Default traceback block width (reference columns rebuilt at once).
DEFAULT_TRACE_CHUNK = 64


def _accum(dtype):
    """numpy accumulator matching ``repro_torch.core.distances.accum_dtype``."""
    if np.issubdtype(dtype, np.floating):
        return np.float32
    return np.int64          # int64 carries int32-sat values exactly


def _dist_col(q, rj, metric, acc):
    d = q.astype(acc) - acc(rj)
    if metric == "abs_diff":
        return np.abs(d)
    return d * d


def _sat(x, acc):
    if acc is np.float32:
        return x
    return np.minimum(x, np.int64(INT_BIG))


@dataclasses.dataclass
class AlignResult:
    """One query's best alignment: span endpoints plus the warping path.

    ``path`` is an (L, 2) int64 array of (query_row, reference_column)
    pairs, monotone in both coordinates, from ``(0, start)`` to
    ``(qlen - 1, end)``. ``distance`` is in the engine's accumulator
    dtype; replaying the pointwise distances along ``path`` in order
    reproduces it — bitwise for int32 / integer-valued float32, to
    float32 ULPs otherwise (see the module docstring).
    """
    distance: object
    start: int
    end: int
    path: np.ndarray

    @property
    def span(self):
        return (self.start, self.end)


def _forward_checkpoints(q, window, metric, acc, chunk):
    """Column sweep of the start-pinned window DP.

    Returns the list of boundary columns S[:, c*chunk - 1] entering each
    block c >= 1 (block 0 starts from the pinned column 0). Only one (N,)
    column is live at a time.
    """
    n = q.shape[0]
    BIG = acc(np.inf) if acc is np.float32 else np.int64(INT_BIG)
    col = np.empty((n,), acc)
    d0 = _dist_col(q, window[0], metric, acc)
    col[0] = d0[0]
    for i in range(1, n):                   # pinned start: column 0 accumulates
        col[i] = _sat(col[i - 1] + d0[i], acc)
    checkpoints = []
    for j in range(1, window.shape[0]):
        if j % chunk == 0:
            checkpoints.append(col.copy())
        dj = _dist_col(q, window[j], metric, acc)
        new = np.empty_like(col)
        new[0] = BIG                        # row 0 finite only at column 0
        for i in range(1, n):
            best = min(col[i - 1], col[i], new[i - 1])
            new[i] = _sat(dj[i] + best, acc) if best < BIG else BIG
        col = new
    return checkpoints, col


def _block_matrix(q, window, metric, acc, j_lo, j_hi, entry_col):
    """Materialise window columns [j_lo, j_hi) of the pinned DP from the
    entry boundary column S[:, j_lo - 1] (None for the first block)."""
    n = q.shape[0]
    BIG = acc(np.inf) if acc is np.float32 else np.int64(INT_BIG)
    S = np.full((n, j_hi - j_lo), BIG, acc)
    for c, j in enumerate(range(j_lo, j_hi)):
        dj = _dist_col(q, window[j], metric, acc)
        if j == 0:
            S[0, c] = dj[0]
            for i in range(1, n):
                S[i, c] = _sat(S[i - 1, c] + dj[i], acc)
            continue
        left = entry_col if c == 0 else S[:, c - 1]
        for i in range(1, n):
            best = min(left[i - 1], left[i], S[i - 1, c])
            S[i, c] = _sat(dj[i] + best, acc) if best < BIG else BIG
    return S


def traceback_path(query, reference, start: int, end: int, qlen=None,
                   metric: str = "abs_diff",
                   chunk: int = DEFAULT_TRACE_CHUNK) -> np.ndarray:
    """Recover the full warping path of the span ``[start, end]``.

    Re-runs the DP inside the window only, in ``chunk``-column blocks
    (peak memory O(qlen·chunk + qlen·span/chunk)), and returns the (L, 2)
    monotone path of (query_row, global_reference_column) pairs.
    Endpoint convention matches ``engine.sdtw(return_spans=True)``:
    the path starts at ``(0, start)`` and ends at ``(qlen - 1, end)``.
    """
    q = np.asarray(query)
    r = np.asarray(reference)
    if qlen is not None:
        q = q[:int(qlen)]
    n = q.shape[0]
    start, end = int(start), int(end)
    if not (0 <= start <= end < r.shape[0]):
        raise ValueError(f"invalid span [{start}, {end}] for reference of "
                         f"length {r.shape[0]} (saturated/absent matches "
                         "carry no span)")
    chunk = max(1, int(chunk))
    acc = _accum(np.result_type(q, r))
    window = r[start:end + 1]
    width = window.shape[0]

    checkpoints, _ = _forward_checkpoints(q, window, metric, acc, chunk)

    path = []
    i, j = n - 1, width - 1                 # local window coordinates
    blk = j // chunk
    while True:
        j_lo = blk * chunk
        j_hi = min(width, j_lo + chunk)
        entry = checkpoints[blk - 1] if blk > 0 else None
        S = _block_matrix(q, window, metric, acc, j_lo, j_hi, entry)
        while j >= j_lo:
            path.append((i, j))
            if i == 0:
                assert j == 0, "pinned-start traceback must end at column 0"
                break
            c = j - j_lo
            here = S[i, c]
            dij = _dist_col(q[i:i + 1], window[j], metric, acc)[0]
            left = entry if c == 0 else S[:, c - 1]
            # Diagonal-first, then left, then up — the shared convention.
            if j > 0 and _sat(left[i - 1] + dij, acc) == here:
                i, j = i - 1, j - 1
            elif j > 0 and _sat(left[i] + dij, acc) == here:
                j = j - 1
            elif _sat(S[i - 1, c] + dij, acc) == here:
                i = i - 1
            else:                           # row 0 free start: d == here
                assert j == 0 and i == 0
                break
        # Done only once (0, 0) itself is on the path — a move may *land*
        # on (0, 0) across the block boundary (chunk=1 diagonal), in which
        # case block 0 still has to replay and append it.
        if path[-1] == (0, 0):
            break
        blk -= 1
    path.reverse()
    out = np.asarray(path, np.int64)
    out[:, 1] += start                      # back to global columns
    return out


def path_cost(query, reference, path, metric: str = "abs_diff"):
    """Accumulate the pointwise distances along ``path`` in path order,
    in the engine's accumulator semantics (saturating int32 / float32).
    For the engine's own span this equals the reported distance —
    bitwise for int32 and integer-valued float32 (exact arithmetic);
    general float32 agrees to ULPs only (the engine sums in tree order,
    this replay is sequential), so compare with a tolerance there."""
    q = np.asarray(query)
    r = np.asarray(reference)
    acc = _accum(np.result_type(q, r))
    total = acc(0)
    for i, j in np.asarray(path):
        d = _dist_col(q[int(i):int(i) + 1], r[int(j)], metric, acc)[0]
        total = _sat(total + d, acc)
    if acc is np.int64:
        return np.int32(total)
    return np.float32(total)


def check_path(path, start: int, end: int, qlen: int) -> bool:
    """Structural validity: endpoints, monotone steps from
    {(1,1), (0,1), (1,0)}, contiguity."""
    p = np.asarray(path)
    if p.ndim != 2 or p.shape[1] != 2 or p.shape[0] == 0:
        return False
    if tuple(p[0]) != (0, start) or tuple(p[-1]) != (qlen - 1, end):
        return False
    steps = np.diff(p, axis=0)
    ok = ((steps[:, 0] >= 0) & (steps[:, 0] <= 1)
          & (steps[:, 1] >= 0) & (steps[:, 1] <= 1)
          & ((steps[:, 0] | steps[:, 1]) == 1))
    return bool(np.all(ok))
