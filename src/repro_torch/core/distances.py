"""Pointwise distance metrics and the (min,+) semiring for (s)DTW.

PyTorch counterpart of ``repro.core.distances``. The paper supports two
metrics (Section II-C / Listing 1):
  * ``abs_diff``:    d(q, r) = |q - r|
  * ``square_diff``: d(q, r) = (q - r)^2

Distances are computed in an accumulator dtype wide enough for the DP
sums: float inputs (float16/bfloat16/float32/float64) accumulate in
float32, integer inputs (int8/16/32/64) accumulate in int32 with
saturating adds against ``INT_BIG``. Integer arithmetic wraps in two's
complement exactly as the reference's int32 arithmetic does.
"""
from __future__ import annotations

import torch

# Large sentinel for integer DP lattices: sat_add(INT_BIG, INT_BIG) does
# not overflow int32 (2**29 + 2**29 = 2**30 < 2**31 - 1).
INT_BIG = 2**29

# Start-pointer-lane filler for cells with no (finite) path yet: larger
# than any real reference column, so a BIG-valued lane never wins a
# lexicographic tie against a genuine start.
INT_FAR = 2**31 - 1

METRICS = ("abs_diff", "square_diff")


def lex_min(v1, s1, v2, s2):
    """Lexicographic min over (value, start) lane pairs: lower value wins,
    value ties take the smaller start. The single tie-break rule behind
    the "spans are bitwise-identical across schedules" guarantee."""
    take2 = (v2 < v1) | ((v2 == v1) & (s2 < s1))
    return torch.where(take2, v2, v1), torch.where(take2, s2, s1)


def tropical_combine(left, right):
    """Compose f_r ∘ f_l where f(x) = min(u, a + x) over the (min,+)
    semiring — the associative operator behind every sDTW row scan."""
    a_l, u_l = left
    a_r, u_r = right
    return sat_add(a_l, a_r), torch.minimum(u_r, sat_add(a_r, u_l))


def tropical_combine_span(left, right):
    """``tropical_combine`` with the start lane riding the u-component:
    f(x, sx) = lexmin((u, su), (a + x, sx))."""
    a_l, u_l, s_l = left
    a_r, u_r, s_r = right
    u, s = lex_min(u_r, s_r, sat_add(a_r, u_l), s_l)
    return sat_add(a_l, a_r), u, s


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype for a given input dtype."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def result_dtype(*tensors) -> torch.dtype:
    """Promoted input dtype of several tensors (``jnp.result_type``)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def big(dtype: torch.dtype):
    """+infinity equivalent in the accumulator dtype (a Python scalar)."""
    return float("inf") if dtype.is_floating_point else INT_BIG


def sat_add(a, b):
    """Saturating add: exact for floats (inf-safe), clamped for ints."""
    s = a + b
    if s.dtype.is_floating_point:
        return s
    return torch.clamp(s, max=INT_BIG)


def pointwise_distance(q, r, metric: str):
    """d(q, r) in the accumulator dtype. q/r broadcast."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")
    acc = accum_dtype(result_dtype(q, r))
    diff = q.to(acc) - r.to(acc)
    if metric == "abs_diff":
        return torch.abs(diff)
    return diff * diff
