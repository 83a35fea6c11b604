"""Naive reference sDTW (Algorithm 1 of the paper) — the correctness oracle.

Materialises the full O(N*M) scoring matrix in numpy with explicit loops.
Slow but unambiguous; every production implementation (wavefront,
associative-scan, Pallas kernel) is validated against this module.

Semantics
---------
``subsequence`` DTW aligns the *whole* query against *any* contiguous part of
the reference:

  * row 0 (first query point) starts a fresh alignment at any reference
    position: S[0, j] = d(Q[0], R[j])                       (free start)
  * column 0 accumulates (the query cannot skip its own points):
    S[i, 0] = S[i-1, 0] + d(Q[i], R[0])
  * interior: S[i, j] = d(Q[i], R[j]) + min(S[i-1,j-1], S[i,j-1], S[i-1,j])
  * answer: min(S[N-1, :])                                  (free end)

Note: the paper's Algorithm 1 listing initialises only S[0,0] and leaves the
rest of row 0 at zero. Taken literally this makes the first query point free
*everywhere except* j=0, which contradicts the standard sDTW definition the
paper cites ([71], Berndt & Clifford) and its own description ("allows the
query to be aligned with part of the reference"). We treat that as a listing
typo and implement the standard free-start initialisation; the literal
variant is available via ``literal_init=True`` for comparison.
"""
from __future__ import annotations

import numpy as np


def _dist(q, r, metric: str):
    d = np.asarray(q, dtype=np.float64) - np.asarray(r, dtype=np.float64)
    if metric == "abs_diff":
        return np.abs(d)
    if metric == "square_diff":
        return d * d
    raise ValueError(f"unknown metric {metric!r}")


def sdtw_matrix(query, reference, metric: str = "abs_diff",
                literal_init: bool = False) -> np.ndarray:
    """Full N×M scoring matrix in float64 (exact for int inputs)."""
    q = np.asarray(query, dtype=np.float64)
    r = np.asarray(reference, dtype=np.float64)
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        raise ValueError("query and reference must be non-empty")
    S = np.zeros((n, m), dtype=np.float64)
    # Row 0.
    if literal_init:
        S[0, 0] = _dist(q[0], r[0], metric)  # paper's literal listing
    else:
        S[0, :] = _dist(q[0], r, metric)     # standard free start
    # Column 0 accumulates.
    for i in range(1, n):
        S[i, 0] = S[i - 1, 0] + _dist(q[i], r[0], metric)
    # Interior.
    for i in range(1, n):
        di = _dist(q[i], r, metric)
        for j in range(1, m):
            S[i, j] = di[j] + min(S[i - 1, j - 1], S[i, j - 1], S[i - 1, j])
    return S


def sdtw_ref(query, reference, metric: str = "abs_diff",
             literal_init: bool = False) -> float:
    """min over the last row — the sDTW distance of Algorithm 1."""
    return float(sdtw_matrix(query, reference, metric, literal_init)[-1, :].min())


def dtw_ref(query, reference, metric: str = "abs_diff") -> float:
    """Classic (non-subsequence) DTW: both boundaries pinned.

    Used by property tests: sDTW(Q, R) == min over windows W of DTW(Q, W)
    is NOT an identity (windows overlap), but sDTW <= DTW(Q, R) always holds.
    """
    q = np.asarray(query, dtype=np.float64)
    r = np.asarray(reference, dtype=np.float64)
    n, m = len(q), len(r)
    S = np.full((n, m), np.inf)
    S[0, 0] = _dist(q[0], r[0], metric)
    for j in range(1, m):
        S[0, j] = S[0, j - 1] + _dist(q[0], r[j], metric)
    for i in range(1, n):
        S[i, 0] = S[i - 1, 0] + _dist(q[i], r[0], metric)
    for i in range(1, n):
        for j in range(1, m):
            S[i, j] = _dist(q[i], r[j], metric) + min(
                S[i - 1, j - 1], S[i, j - 1], S[i - 1, j])
    return float(S[-1, -1])
