"""The sDTW matrix profile: self-join motifs and discords at scale.

Counterpart of ``repro.search.profile``. For every sliding window of a
series, the distance to its nearest *non-trivial* match elsewhere in the
same series: low = a repeated pattern (motif), high = a subsequence unlike
anything else (discord / anomaly) — the paper's anomaly-discovery
scenario (§I, §V) over ECG- and seismology-class recordings.

``matrix_profile`` composes the search layer instead of adding a DP:

  * windows follow ``self_join_windows``' convention (starts
    ``arange(0, M - window + 1, stride)`` in sample units), sliced per
    bounded **batch** (``profile_batch``), so nothing is O(M²) and never
    more windows are held at once than a memory budget admits;
  * trivial-match suppression is ``self_join_exclusion`` — banned
    reference columns in **sample** units (stride-invariant) — which on
    the card is the sDTW kernel's per-query column ban
    (``search_topk(engine_impl='auto')`` takes the kernel there; on the
    CPU the row scan, as in the reference);
  * each batch runs through ``search_topk`` with its LB_Kim/LB_Keogh
    cascade over one shared ``EnvelopeCache`` entry (the chunk is pinned
    up front so every batch maps to the same key);
  * motif pairs and top-K discords are host-side greedy reductions over
    the finished profile (``mutual_nearest_pairs`` / ``discord_select``).

Exactness, as in the reference: with ``prune=False`` every per-window
(distance, start, end) is the exact streamed answer, bitwise for int32
and independent of ``batch``; with ``prune=True`` distances are those of
the exact profile on every tested shape (a nearest neighbour whose
alignment spans more than ``span_cap`` columns could be missed), and on
exact distance ties the witness span may differ.

``repro_torch.stream.profile.StreamProfile`` is the incremental variant;
``matsa(mode='self_join')`` routes through here by default.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.distances import accum_dtype, big
from repro_torch.core.sdtw import self_join_exclusion
from repro_torch.core.topk import discord_select, mutual_nearest_pairs
from repro_torch.device import as_tensor, resolve_device, to_numpy

from . import cache as cache_mod
from . import search as search_mod
from .search import default_chunk, search_topk

#: Windows a batch where the batch's size does not decide the kernel's
#: occupancy (the CPU row scan) or decides the answer's work (``prune=True``:
#: batch composition decides which tying chunks are pruned).
DEFAULT_BATCH = 256
#: Device bytes the exact profile's kernel route may spend on one batch's
#: chunk launch: ~4,000 windows of 512 at chunk 8,192, enough for the rows
#: kernel to fill the card, at 1.3 % of an 80-GB card.
BATCH_BUDGET_BYTES = 1 << 30
#: Bytes a window costs a chunk column on the kernel route: the last-row
#: capture and its start lane (8), then ``topk_merge``'s three
#: concatenations and ``topk_select``'s temporaries at k = 1 (~22).
_COLUMN_BYTES = 30
#: Bytes a window costs a query row: its slab (4) and the kernel carry's
#: two lanes in and out (16).
_ROW_BYTES = 20


@dataclasses.dataclass
class ProfileResult:
    """The matrix profile of one series plus its motif/discord reductions
    (numpy arrays, as in the reference).

    Per-window arrays are (nw,), indexed by window number (window i
    starts at sample ``starts[i] = i * stride``):

      * ``nn_dist``: accumulator-dtype distance to the window's nearest
        admissible neighbour — ``BIG`` when the exclusion band leaves no
        admissible column (check ``valid``; such windows are never
        selected as motifs or discords);
      * ``nn_start`` / ``nn_end``: the matched span in global sample
        positions; -1 when invalid;
      * ``nn_window``: the nearest window index ``round(nn_start /
        stride)`` clipped to [0, nw); -1 when invalid.

    ``motif_a``/``motif_b``/``motif_dist`` are (k,) mutually nearest pairs
    padded (-1, -1, inf); ``discord_idx``/``discord_dist`` (k,) padded
    (-1, -inf). The ``chunks_*`` counters sum ``search_topk``'s over all
    batches, so at the default ``batch`` they follow ``profile_batch``'s
    rule for the device: the same call counts fewer chunks on the card,
    where the exact profile takes larger batches, than on the CPU.
    """
    window: int
    stride: int
    k: int
    starts: np.ndarray
    nn_dist: np.ndarray
    nn_start: np.ndarray
    nn_end: np.ndarray
    nn_window: np.ndarray
    motif_a: np.ndarray
    motif_b: np.ndarray
    motif_dist: np.ndarray
    discord_idx: np.ndarray
    discord_dist: np.ndarray
    excl_zone: int = 0
    chunk: int = 0
    chunks_total: int = 0
    chunks_pruned_kim: int = 0
    chunks_pruned_keogh: int = 0
    chunks_processed: int = 0

    @property
    def chunks_pruned(self) -> int:
        return self.chunks_pruned_kim + self.chunks_pruned_keogh

    @property
    def valid(self) -> np.ndarray:
        """(nw,) bool: windows with an admissible nearest neighbour."""
        return self.nn_end >= 0

    @property
    def motifs(self):
        """Non-padding motif pairs as [(a, b, dist)] Python tuples."""
        keep = self.motif_a >= 0
        return [(int(a), int(b), float(d)) for a, b, d in
                zip(self.motif_a[keep], self.motif_b[keep],
                    self.motif_dist[keep])]

    @property
    def discords(self):
        """Non-padding discords as [(idx, dist)] Python tuples."""
        keep = self.discord_idx >= 0
        return [(int(i), float(d)) for i, d in
                zip(self.discord_idx[keep], self.discord_dist[keep])]

    @property
    def spans(self) -> np.ndarray:
        """(nw, 2) stacked (nn_start, nn_end); (-1, -1) rows are invalid."""
        return np.stack([self.nn_start, self.nn_end], axis=-1)


def _assemble_profile(window, stride, k, starts, nn_dist, nn_start, nn_end,
                      excl_zone, chunk, stats) -> ProfileResult:
    """Mask sentinels, derive neighbour window indices, run the motif and
    discord reductions — shared by the batch and streaming variants so
    that the two differ only in how the nearest-neighbour arrays were
    produced."""
    starts = np.asarray(starts, np.int64)
    nn_dist = np.asarray(nn_dist)
    nn_start = np.asarray(nn_start, np.int64)
    nn_end = np.asarray(nn_end, np.int64)
    nw = starts.shape[0]
    ceiling = np.inf if nn_dist.dtype.kind == "f" else big(torch.int32)
    valid = (nn_end >= 0) & (nn_dist < ceiling)
    # Invalid rows get the canonical padding triple, so that no half-set
    # sentinel reaches a consumer.
    nn_start = np.where(valid, nn_start, -1)
    nn_end = np.where(valid, nn_end, -1)
    nn_window = np.where(
        valid, np.clip((nn_start + stride // 2) // stride, 0, nw - 1), -1)
    dist_f = np.where(valid, nn_dist.astype(np.float64), np.inf)
    ma, mb, md = mutual_nearest_pairs(dist_f, nn_window, starts, k,
                                      excl_zone)
    di, dd = discord_select(dist_f, starts, k, excl_zone)
    return ProfileResult(
        window=int(window), stride=int(stride), k=int(k), starts=starts,
        nn_dist=nn_dist, nn_start=nn_start, nn_end=nn_end,
        nn_window=nn_window, motif_a=ma, motif_b=mb, motif_dist=md,
        discord_idx=di, discord_dist=dd, excl_zone=int(excl_zone),
        chunk=int(chunk), chunks_total=stats[0],
        chunks_pruned_kim=stats[1], chunks_pruned_keogh=stats[2],
        chunks_processed=stats[3])


def profile_batch(nw: int, window: int, chunk: int, *,
                  exact_kernel: bool) -> int:
    """Windows a ``search_topk`` call of ``matrix_profile`` at its default
    ``batch``.

    The exact profile on the kernel route (``exact_kernel``: ``prune=False``
    with the route resolving to the kernel) takes as many windows a batch
    as ``BATCH_BUDGET_BYTES`` admits at ``chunk`` columns a launch: all
    ``nw`` in one batch if they fit, else the fewest equal batches that
    do. A batch that large is what fills the card; the answers do not
    depend on it. Everything else takes ``DEFAULT_BATCH``.
    """
    if not exact_kernel:
        return DEFAULT_BATCH
    cap = max(1, BATCH_BUDGET_BYTES
              // (_COLUMN_BYTES * chunk + _ROW_BYTES * window))
    n_batches = -(-nw // cap)
    return -(-nw // n_batches)


def matrix_profile(series, window: int, stride: int = 1, k: int = 1, *,
                   metric: str = "abs_diff", chunk: Optional[int] = None,
                   prune: bool = True, span_cap: Optional[int] = None,
                   excl_zone: Optional[int] = None,
                   batch: Optional[int] = None,
                   cache: Optional[cache_mod.EnvelopeCache] = None,
                   ref_key=None, engine_impl: str = "auto",
                   device=None) -> ProfileResult:
    """Full sDTW matrix profile of ``series`` against itself.

    Args as ``repro.search.profile.matrix_profile``: ``series`` (M,);
    ``window`` (the subsequence length); ``stride`` (window step in
    samples: it thins the query side only); ``k`` (motif pairs and
    discords reported; each window's neighbour is its top-1); ``metric``;
    ``chunk`` (the pruning tile, default ``default_chunk(M, window)``,
    pinned once); ``prune`` (the LB cascade; ``False`` is the exact
    profile); ``span_cap`` (default ``2 * window``); ``excl_zone`` (the
    trivial-match radius in samples, default ``window // 2``: window s
    bans columns ``[s - excl_zone, s + window + excl_zone)``, and the same
    radius separates reported motifs and discords); ``batch`` (windows
    per ``search_topk`` call, the memory knob; ``None`` is
    ``profile_batch``'s rule: on the kernel route the exact profile takes
    as many windows a batch as a memory budget admits, else 256);
    ``cache``/``ref_key``
    (envelope reuse across calls); ``engine_impl`` ('auto' is the kernel
    with its column ban on the card, the row scan on the CPU). ``device``
    is where the DP runs (``None``: the CUDA device). Each batch runs
    under the span ``repro_torch.profile.batch`` (``repro_torch.obs``).

    Returns a ``ProfileResult`` (numpy arrays).
    """
    series = to_numpy(series)
    if series.ndim != 1:
        raise ValueError(f"series must be 1-D, got shape {series.shape}")
    m = series.shape[0]
    if not 1 <= window <= m:
        raise ValueError(f"window must be in [1, {m}], got {window}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    zone = window // 2 if excl_zone is None else int(excl_zone)
    if zone < 0:
        raise ValueError(f"excl_zone must be >= 0, got {excl_zone}")

    dev = resolve_device(device)
    starts = np.arange(0, m - window + 1, stride, dtype=np.int64)
    nw = starts.shape[0]
    c = default_chunk(m, window) if chunk is None else int(chunk)
    cache = cache_mod.DEFAULT_CACHE if cache is None else cache
    ref = as_tensor(series, dev)
    if ref_key is None and prune:
        # Fingerprint once: every batch then shares one (key, chunk)
        # envelope entry without sampling the series again.
        ref_key = cache_mod.EnvelopeCache._fingerprint(ref)

    acc = accum_dtype(ref.dtype)
    nn_dist = np.full((nw,), big(acc), np.float32 if acc.is_floating_point
                      else np.int32)
    nn_start = np.full((nw,), -1, np.int64)
    nn_end = np.full((nw,), -1, np.int64)
    stats = [0, 0, 0, 0]
    col = np.arange(window, dtype=np.int64)
    if batch is None:
        route = (search_mod._auto_engine(dev) if engine_impl == "auto"
                 else engine_impl)
        batch = profile_batch(nw, window, c,
                              exact_kernel=not prune and route == "pallas")
    for b0 in range(0, nw, batch):
        with obs.span("profile.batch"):
            sl = slice(b0, min(b0 + batch, nw))
            s_b = starts[sl]
            windows_b = series[s_b[:, None] + col[None, :]]
            lo_b, hi_b = self_join_exclusion(s_b, window, zone)
            res = search_topk(
                windows_b, ref, 1, metric=metric, chunk=c, prune=prune,
                span_cap=span_cap, excl_lo=lo_b, excl_hi=hi_b, cache=cache,
                ref_key=ref_key, engine_impl=engine_impl, device=dev)
            nn_dist[sl] = to_numpy(res.distances)[:, 0]
            nn_end[sl] = to_numpy(res.positions)[:, 0]
            nn_start[sl] = to_numpy(res.starts)[:, 0]
            stats[0] += res.chunks_total
            stats[1] += res.chunks_pruned_kim
            stats[2] += res.chunks_pruned_keogh
            stats[3] += res.chunks_processed
    return _assemble_profile(window, stride, k, starts, nn_dist, nn_start,
                             nn_end, zone, c, stats)
