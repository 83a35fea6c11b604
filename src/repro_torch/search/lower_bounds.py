"""Lower-bound cascade for pruned subsequence search.

Counterpart of ``repro.search.lower_bounds``, as torch ops on the
caller's device. Two bounds per (query, reference chunk), cheapest first
(the TC-DTW / UCR-suite recipe adapted to unconstrained-warping
subsequence DTW):

``lb_kim``   — the last query point's distance to the chunk's [min, max]
              envelope, plus (queries of length ≥ 2) the first point's
              distance to the *windowed* envelope of the match window.
``lb_keogh`` — every query point before the last to the windowed
              envelope, plus the last point to the chunk envelope;
              it dominates ``lb_kim``.

Both assume the match's warping span is at most ``span_cap`` columns
(window = ``halo`` chunks to the left + the chunk itself). Bounds are
float32, shaved by ``LB_SAFETY`` to absorb float-sum rounding before they
are compared with DP distances. For integer-valued inputs every sum is
exact below 2**24, so the bounds, and the prune decisions they drive,
are the reference's bit for bit; for general float32 the sums may be
ordered differently from XLA's and agree to float32 ULPs.

``znorm`` / ``znorm_padded`` z-normalize the reference (globally) and
each query (over its true length) for ``search_topk(normalize=True)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.distances import METRICS, accum_dtype, big

# Multiplicative shave applied to float32 bound sums so accumulated
# rounding can never push an admissible bound above the true DP cost.
LB_SAFETY = 1.0 - 1e-5


def _f32(x, device=None):
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def znorm(x, eps: float = 1e-8):
    """Z-normalize a 1-D (or trailing-axis batched) series in float32
    (population standard deviation, as ``jnp.std``)."""
    x = _f32(x)
    mu = x.mean(dim=-1, keepdim=True)
    sd = x.std(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.clamp(sd, min=eps)


def znorm_padded(queries, qlens, eps: float = 1e-8):
    """Mask-aware z-norm for a (nq, N) padded batch: moments over the true
    length only; the padded tail stays zero."""
    q = _f32(queries)
    n = q.shape[1]
    qlens = torch.as_tensor(qlens).to(q.device)
    valid = torch.arange(n, device=q.device)[None, :] < qlens[:, None]
    cnt = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
    mu = torch.where(valid, q, 0.0).sum(dim=1, keepdim=True) / cnt
    var = torch.where(valid, (q - mu) ** 2, 0.0).sum(dim=1,
                                                     keepdim=True) / cnt
    z = (q - mu) / torch.clamp(torch.sqrt(var), min=eps)
    return torch.where(valid, z, 0.0)


def chunk_envelope(reference, chunk: int):
    """Per-chunk [min, max] of the reference — the envelope the bounds eat.

    Returns (mins (T,), maxs (T,)) in the accumulator dtype on the
    reference's device, T = ceil(M / chunk); tail padding is ignored via
    ±BIG fill. This is what ``repro_torch.search.cache.EnvelopeCache``
    stores.
    """
    reference = torch.as_tensor(reference)
    m = reference.shape[0]
    acc = accum_dtype(reference.dtype)
    BIG = big(acc)
    t = -(-m // chunk)
    r = torch.nn.functional.pad(reference.to(acc),
                                (0, t * chunk - m)).reshape(t, chunk)
    mask = (torch.arange(t * chunk, device=r.device) < m).reshape(t, chunk)
    mins = torch.where(mask, r, BIG).amin(dim=1)
    maxs = torch.where(mask, r, -BIG).amax(dim=1)
    return mins, maxs


def windowed_envelope(mins, maxs, halo: int):
    """Envelope over chunks [t - halo, t] for each t (the match window).
    Out-of-range chunks contribute nothing (±BIG fill), so early chunks get
    the correctly narrower window."""
    BIG = big(mins.dtype)
    t = mins.shape[0]
    wmin, wmax = mins, maxs
    for s in range(1, halo + 1):
        pad = min(s, t)
        sh_min = torch.cat([torch.full((pad,), BIG, dtype=mins.dtype,
                                       device=mins.device), mins])[:t]
        sh_max = torch.cat([torch.full((pad,), -BIG, dtype=maxs.dtype,
                                       device=maxs.device), maxs])[:t]
        wmin = torch.minimum(wmin, sh_min)
        wmax = torch.maximum(wmax, sh_max)
    return wmin, wmax


def _interval_dist(q, lo, hi, metric: str):
    """Pointwise distance from value(s) q to the interval [lo, hi] — the
    smallest possible metric distance to any point inside it."""
    gap = torch.clamp(torch.maximum(lo - q, q - hi), min=0.0)
    if metric == "square_diff":
        return gap * gap
    return gap


def lb_cascade(queries, qlens, mins, maxs, halo: int,
               metric: str = "abs_diff"):
    """LB_Kim and LB_Keogh for every (query, chunk) pair.

    Args:
      queries: (nq, N) padded batch; qlens (nq,) true lengths.
      mins/maxs: (T,) per-chunk envelope from ``chunk_envelope`` (tensors
               or numpy arrays; moved to the queries' device).
      halo:    window radius in chunks (ceil(span_cap / chunk)).
      metric:  'abs_diff' | 'square_diff'.

    Returns (lb_kim (nq, T), lb_keogh (nq, T)) in float32 on the queries'
    device, shaved by ``LB_SAFETY``; ``lb_keogh >= lb_kim`` elementwise.
    Memory: the Keogh term materialises an (nq, N, T) intermediate.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected {METRICS}")
    q = _f32(queries)
    dev = q.device
    n = q.shape[1]
    qlens = torch.as_tensor(qlens).to(device=dev, dtype=torch.int64)
    mins, maxs = _f32(mins, dev), _f32(maxs, dev)
    cmin, cmax = mins[None, :], maxs[None, :]            # chunk envelope
    wmin, wmax = windowed_envelope(mins, maxs, halo)
    wmin, wmax = wmin[None, :], wmax[None, :]            # match window

    q_last = torch.gather(q, 1, (qlens - 1)[:, None])    # (nq, 1)
    last_term = _interval_dist(q_last, cmin, cmax, metric)       # (nq, T)
    first_term = _interval_dist(q[:, :1], wmin, wmax, metric)    # (nq, T)
    lb_kim = torch.where((qlens == 1)[:, None], last_term,
                         first_term + last_term)

    # Every query point before the last aligns inside the window.
    contrib = _interval_dist(q[:, :, None], wmin[:, None, :],
                             wmax[:, None, :], metric)   # (nq, N, T)
    mid_mask = torch.arange(n, device=dev)[None, :] < (qlens - 1)[:, None]
    mid = torch.where(mid_mask[:, :, None], contrib, 0.0).sum(dim=1)
    lb_keogh = mid + last_term

    return lb_kim * LB_SAFETY, lb_keogh * LB_SAFETY
