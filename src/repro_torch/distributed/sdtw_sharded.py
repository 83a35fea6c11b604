"""Multi-rank sDTW: one systolic pipeline over a (dp, mp) mesh of ranks.

Counterpart of ``repro.distributed.sdtw_sharded``. Each rank along the
systolic (``mp``) axis owns one contiguous reference segment (padded to a
multiple of the streaming chunk). The sDTW recurrence is sequential along
the reference, so a query batch visits the ``mp`` ranks in order; batches
are independent, so the query set is split into microbatches, rank d
processes microbatch t − d at tick t, and the chunk carry (boundary
column, start lane, running best, top-K heap) is handed to the right-hand
neighbour with one ``dist.batch_isend_irecv`` a tick — a rank is just a
very large chunk, as MATSA passes the boundary column between subarrays.

A (dp, mp) mesh crosses the pipeline with query replication: microbatch
slots are split over the dp rows (the reference is replicated within a
row), each row runs its own schedule, and the rows' results are gathered
in row order. Where every JAX device computes garbage in the pipeline's
fill and drain, a rank here computes only its n_micro live ticks; the
answers are the same.

Every call is SPMD (``repro_torch.distributed.sharding``): every rank of
the mesh calls it with the same (replicated) arguments and gets back the
whole, replicated answer.

Each rank's segment step:
  * on a CUDA device, one launch of the hand-written kernel over the
    whole segment through its chunk carry (``kernels.sdtw.ops.sdtw_cuda``
    with ``ref_offset``/``ref_len``, under the tuned launch; exclusion
    ranges as its per-query ban). A top-K heap takes the kernel's
    last-row capture, folded ``chunk`` columns at a time at their global
    offsets (``stream.session._pallas_step``), so the heap merges the
    candidates in the same partition as the reference's chunk loop; a
    top-1 (``k = 1``) is the kernel's own running best, end and start.
    Nothing on a CUDA rank runs the plain version, and a failed launch
    raises;
  * on the CPU, the plain ``core.sdtw.sdtw_segment`` /
    ``sdtw_segment_topk`` — bitwise the reference's step.

The carry between ranks and between feeds is the reference's layout,
``(bcol, [bstart,] best)`` plus the heap ``(top_d, top_p, top_s)``, so a
streamed carry snapshots for the JAX package. One difference on the
kernel route: a segment that ends past the stream (``m_total``) exits
its boundary column at the last real column, where the reference's exits
poisoned at the padded end; both are terminal (nothing reads them but a
later padded feed), and distances, spans and heaps are bitwise equal.

Every entry point instantiates ``build_pipeline`` with an entry policy
(``fresh`` carries per microbatch, or the caller's ``carry``) and a
harvest policy (the final ``result``, or the full ``carry``). Pipelines
live in a bounded cache keyed on the mesh fingerprint (axis names, shape,
ranks) — ``clear_pipeline_cache`` / ``_cache_size``.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.distances import accum_dtype, result_dtype
from repro_torch.core.sdtw import (default_excl_zone, sdtw_carry_init,
                                   sdtw_segment, sdtw_segment_topk)
from repro_torch.core.topk import topk_init
from repro_torch.device import as_tensor, resolve_device
from .collectives import hand_off, psum_harvest
from .sharding import Mesh, get_mesh, pipeline_axes


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def default_mesh(axis: str = "ref") -> Mesh:
    """1-D mesh over every rank of the world, reference axis sharded."""
    return get_mesh(None, (axis,))


# ---------------------------------------------------------------------------
# Schedule: microbatch layout + padding/reshape/unpad glue
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """Microbatch layout for one pipeline launch.

    ``slots = n_dp * n_micro`` microbatch slots of ``mb`` queries each;
    slot s holds queries [s*mb, (s+1)*mb), dp row r owns slots
    [r*n_micro, (r+1)*n_micro). ``pack``/``unpack`` are inverses around
    the sharded call, so results come back in query order whatever the
    (dp, mp, n_micro) factorization — which makes the sharded path
    bitwise schedule-invariant for int32.
    """
    dp_axis: Optional[str]
    mp_axis: str
    n_dp: int
    n_mp: int
    n_micro: int
    mb: int
    nq: int

    @property
    def slots(self) -> int:
        return self.n_dp * self.n_micro

    def pack(self, arr, fill=0):
        """Pad a (nq, ...) tensor to slots*mb rows, reshape (slots, mb,
        ...)."""
        arr = torch.as_tensor(arr)
        pad = self.slots * self.mb - arr.shape[0]
        padded = torch.cat([arr, torch.full((pad,) + tuple(arr.shape[1:]),
                                            fill, dtype=arr.dtype,
                                            device=arr.device)])
        return padded.reshape((self.slots, self.mb) + tuple(arr.shape[1:]))

    def unpack(self, out):
        """Inverse of ``pack`` over a tensor or tuple of (slots, mb, ...)
        leaves."""
        flat = self.slots * self.mb

        def one(o):
            return o.reshape((flat,) + tuple(o.shape[2:]))[:self.nq]
        return tuple(map(one, out)) if isinstance(out, tuple) else one(out)


def make_schedule(mesh: Mesh, nq: int, *, ref_axis: str = "ref",
                  dp_axis: Optional[str] = None,
                  n_micro: Optional[int] = None) -> PipelineSchedule:
    """Resolve mesh axes and pick the microbatch layout for ``nq`` queries.

    Default ``n_micro`` fills the systolic pipeline (up to ``n_mp``
    microbatches per dp row) without exceeding the query count. An
    explicit ``n_micro`` is validated: every dp row must get at least one
    real query per microbatch slot, else the schedule would be pure
    padding — rejected, not clamped.
    """
    dpax, mpax = pipeline_axes(mesh, ref_axis=ref_axis, dp_axis=dp_axis)
    n_dp = mesh.shape[dpax] if dpax is not None else 1
    n_mp = mesh.shape[mpax]
    if n_micro is None:
        n_micro = max(1, min(n_mp, -(-max(1, nq) // n_dp)))
    else:
        n_micro = int(n_micro)
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        if n_dp * n_micro > max(1, nq):
            raise ValueError(
                f"n_micro={n_micro} exceeds the padded batch: {n_dp} dp "
                f"row(s) x {n_micro} microbatches > {nq} queries, so at "
                f"least one microbatch slot would be pure padding; lower "
                f"n_micro or leave it None")
    mb = max(1, -(-nq // (n_dp * n_micro)))
    return PipelineSchedule(dpax, mpax, n_dp, n_mp, n_micro, mb, nq)


def _segment_layout(m: int, n_mp: int, chunk: int):
    """Per-rank reference segment length (a chunk multiple) + the chunk."""
    seg = max(1, -(-m // n_mp))
    chunk = min(chunk, seg)
    seg = _ceil_to(seg, chunk)
    return seg, chunk


# ---------------------------------------------------------------------------
# Bounded pipeline cache (keyed on mesh fingerprints, not live Mesh objects)
# ---------------------------------------------------------------------------

_PIPELINE_CACHE: "OrderedDict[tuple, _Pipeline]" = OrderedDict()
PIPELINE_CACHE_MAX = 64


def _mesh_key(mesh: Mesh) -> tuple:
    return (tuple(mesh.axis_names), tuple(mesh.ranks.shape),
            tuple(int(r) for r in mesh.ranks.flat))


def clear_pipeline_cache() -> None:
    """Drop every cached pipeline (tests; a new process group)."""
    _PIPELINE_CACHE.clear()


def _cache_size() -> int:
    """Number of live cached pipelines (the ``_cache_size()`` pattern)."""
    return len(_PIPELINE_CACHE)


# ---------------------------------------------------------------------------
# Each rank's segment step
# ---------------------------------------------------------------------------

def _kernel_route(device: torch.device) -> bool:
    """Whether a rank on ``device`` scores its segment with the
    hand-written kernel (a CUDA device) or the plain schedule (the CPU).
    The CPU tests patch it to drive the kernel route's carry plumbing
    through the kernel's plain version."""
    return device.type == "cuda"


def _kernel_segment(q, seg_ref, ql, carry, j0: int, m_total: int, *,
                    metric, chunk, ban, top_k, zone, excl_span, track,
                    tune):
    """One segment through the kernel's chunk carry, the carry in and out
    in the reference's layout."""
    from repro_torch.stream.session import _pallas_step
    rlen = min(seg_ref.shape[0], m_total - j0)
    if rlen <= 0:            # wholly past the stream end: nothing to score
        return carry
    heap = carry[-3:] if top_k is not None else None
    base = carry[:-3] if top_k is not None else carry
    # A top-1 rides the kernel's own (best, end, start) lanes, which a
    # k = 1 heap equals; a top-K folds the last-row capture into the heap.
    top1 = top_k == 1
    best = base[-1]
    none = torch.full(best.shape, -1, dtype=torch.int32, device=best.device)
    end = heap[1][:, 0] if top1 else none
    kc = ((base[0], base[1], best, end, heap[2][:, 0] if top1 else none)
          if track else (base[0], best, end))
    lo, hi = ban or (None, None)
    folds = top_k is not None and not top1
    out, _, _ = _pallas_step(
        q, seg_ref, ql, kc, heap if folds else None, j0, rlen, zone,
        metric=metric, block_q=None, block_m=None, k=top_k or 1,
        excl_span=excl_span, track=track, want_lastrow=folds,
        with_heap=folds, excl_lo=lo, excl_hi=hi, fold=chunk, tune=tune)
    new = out[:3] if track else out[:2]
    if top_k is None:
        return new
    if folds:
        return new + tuple(out[-3:])
    start = out[4] if track else heap[2][:, 0]
    return new + (new[-1][:, None], out[len(new)][:, None], start[:, None])


def _segment_step(q, seg_ref, ql, carry, j0: int, m_total: int, *, kernel,
                  metric, chunk, lo, hi, ban, top_k, zone, excl_span, track,
                  tune):
    if kernel:
        return _kernel_segment(q, seg_ref, ql, carry, j0, m_total,
                               metric=metric, chunk=chunk, ban=ban,
                               top_k=top_k, zone=zone, excl_span=excl_span,
                               track=track, tune=tune)
    if top_k is not None:
        return sdtw_segment_topk(q, seg_ref, ql, carry, j0, m_total, metric,
                                 chunk, lo, hi, top_k, zone, excl_span,
                                 track)
    return sdtw_segment(q, seg_ref, ql, carry, j0, m_total, metric, chunk,
                        lo, hi)


# ---------------------------------------------------------------------------
# THE pipeline — the only systolic tick loop in the sharded layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Pipeline:
    """One pipeline configuration (the cache's value); called with the
    mesh it runs on."""
    dp_axis: Optional[str]
    mp_axis: str
    metric: str
    chunk: int
    n_micro: int
    top_k: Optional[int]
    excl_zone: Optional[int]
    excl_span: bool
    track_start: bool
    entry: str
    harvest: str

    def __call__(self, mesh: Mesh, r_macro, q_micro, qlen_micro, lo_micro,
                 hi_micro, m_total: int, j0_base: int, carry=None, *,
                 tune: str = "off"):
        """Run this rank's part of the schedule. ``r_macro`` is the
        (n_mp * seg,) reference (or macro-chunk), the microbatch tensors
        (slots, mb, ...) on this rank's device, ``carry`` (entry='carry')
        the stacked (slots, mb, ...) carry leaves. Returns the harvested
        (slots, mb, ...) leaves on every rank."""
        dev = q_micro.device
        at = mesh.coords()
        d = at[self.mp_axis]
        r = at[self.dp_axis] if self.dp_axis is not None else 0
        n_mp = mesh.shape[self.mp_axis]
        n_micro = self.n_micro
        mine = slice(r * n_micro, (r + 1) * n_micro)
        r_macro = torch.as_tensor(r_macro).reshape(-1)
        seg = r_macro.shape[0] // n_mp
        seg_ref = r_macro[d * seg:(d + 1) * seg].to(dev)
        j0 = int(j0_base) + d * seg
        m_total = int(m_total)
        q_mine, ql_mine = q_micro[mine], qlen_micro[mine].to(dev)
        lo_mine, hi_mine = lo_micro[mine].to(dev), hi_micro[mine].to(dev)
        mb, n = q_micro.shape[1], q_micro.shape[2]
        acc = accum_dtype(result_dtype(q_micro, seg_ref))
        fresh = sdtw_carry_init(mb, n, acc, track_start=self.top_k is not None
                                and self.track_start, device=dev)
        if self.top_k is not None:
            fresh = fresh + topk_init(mb, self.top_k, acc, device=dev)
        kernel = _kernel_route(dev)
        if kernel:
            from repro_torch.kernels.sdtw.ops import kernel_bans
            bans = [kernel_bans(lo_mine[mu], hi_mine[mu], mb, dev,
                                test_device=True) for mu in range(n_micro)]
        step = functools.partial(
            _segment_step, kernel=kernel, metric=self.metric,
            chunk=self.chunk, top_k=self.top_k, excl_span=self.excl_span,
            track=self.top_k is not None and self.track_start, tune=tune)

        def emit(c):
            if self.harvest == "carry":
                return tuple(c)
            if self.top_k is not None:
                return tuple(c[-3:])
            return (c[1],)

        kept = [] if d == n_mp - 1 else None
        incoming = None
        for t in range(n_micro + n_mp - 1):
            mu = t - d
            cout = None
            if 0 <= mu < n_micro:
                if d > 0:
                    cin = incoming
                elif self.entry == "carry":
                    cin = tuple(x[r * n_micro + mu].to(dev) for x in carry)
                else:
                    cin = fresh
                ql = ql_mine[mu]
                zone = (default_excl_zone(ql) if self.excl_zone is None
                        else torch.full(ql.shape, self.excl_zone,
                                        dtype=torch.int32, device=dev))
                cout = step(q_mine[mu], seg_ref, ql, cin, j0, m_total,
                            lo=lo_mine[mu], hi=hi_mine[mu],
                            ban=bans[mu] if kernel else None, zone=zone)
                if kept is not None:
                    kept.append(emit(cout))
            incoming = hand_off(
                mesh, self.mp_axis,
                cout if (cout is not None and d < n_mp - 1) else None,
                d > 0 and 0 <= t + 1 - d < n_micro, fresh, dev)
        outs = None
        if kept is not None:
            outs = tuple(torch.stack([e[i] for e in kept])
                         for i in range(len(kept[0])))
        res = psum_harvest(outs, emit(fresh), mesh, self.mp_axis,
                           self.dp_axis, n_micro, dev)
        return res if (self.harvest == "carry" or self.top_k is not None) \
            else res[0]


def build_pipeline(mesh: Mesh, *, dp_axis: Optional[str], mp_axis: str,
                   metric: str, chunk: int, n_micro: int,
                   top_k: Optional[int] = None, excl_zone=0,
                   excl_span: bool = False, track_start: bool = False,
                   entry: str = "fresh", harvest: str = "result"):
    """Build (or fetch) the systolic pipeline over ``mesh``.

    One parameterized body serves every sharded path:

      * ``entry='fresh'``  — each microbatch starts from the fresh sDTW
        carry (the batch paths); ``entry='carry'`` — stage 0 enters each
        microbatch from the caller's stacked carries (the streaming feed).
      * ``harvest='result'`` — the final result per microbatch (the
        running best, or the top-K heap triple); ``harvest='carry'`` —
        the full carry exiting the last stage, so the caller can keep
        feeding.

    With ``top_k`` set, the per-microbatch match heap rides the carry
    like the boundary column, which gains the start lane (``track_start``)
    so spans survive the hand-off: each rank folds its segment's
    candidates into the heap it received, so the heap leaving the last
    stage is the merged cross-shard top-K.

    Returns ``run(r_macro, q_micro, qlen_micro, lo_micro, hi_micro,
    m_total, j0_base[, carry], tune='off')`` (see ``_Pipeline``), called
    by every rank of ``mesh``.
    """
    if entry not in ("fresh", "carry"):
        raise ValueError(f"entry must be 'fresh' or 'carry', got {entry!r}")
    if harvest not in ("result", "carry"):
        raise ValueError(f"harvest must be 'result' or 'carry', got "
                         f"{harvest!r}")
    key = (_mesh_key(mesh), dp_axis, mp_axis, metric, chunk, n_micro,
           top_k, excl_zone, excl_span, track_start, entry, harvest)
    hit = _PIPELINE_CACHE.get(key)
    if hit is None:
        hit = _Pipeline(dp_axis, mp_axis, metric, chunk, n_micro, top_k,
                        excl_zone, excl_span, track_start, entry, harvest)
        _PIPELINE_CACHE[key] = hit
        while len(_PIPELINE_CACHE) > PIPELINE_CACHE_MAX:
            _PIPELINE_CACHE.popitem(last=False)
    else:
        _PIPELINE_CACHE.move_to_end(key)
    return functools.partial(hit, mesh)


# ---------------------------------------------------------------------------
# Entry points — thin instantiations of the one pipeline
# ---------------------------------------------------------------------------

def sdtw_sharded_feed(r_macro, q_micro, qlen_micro, lo_micro, hi_micro,
                      carry, j0: int, m_total: int, *, mesh: Mesh,
                      axis: str = "ref", dp_axis: Optional[str] = None,
                      chunk: int, metric: str, top_k=None, excl_zone=None,
                      excl_span: bool = False, track_start: bool = False,
                      tune: str = "off"):
    """Advance stacked per-microbatch carries by one sharded macro-chunk.

    ``r_macro`` is (n_mp * seg,) with seg a multiple of ``chunk``; stage d
    processes global columns ``[j0 + d*seg, j0 + (d+1)*seg)``. ``carry``
    leaves are (slots, mb, ...) with slots = n_dp * n_micro, as a previous
    feed returned them (or the caller's stacked fresh carry); so is the
    return value. ``m_total`` masks columns past the true stream end, so a
    right-padded final macro-chunk still folds exact distances and heaps
    (its exiting boundary column is not — a padded feed must be the
    last). SPMD: every rank of ``mesh`` calls it with the same arguments
    and gets the whole harvested carry."""
    dpax, mpax = pipeline_axes(mesh, ref_axis=axis, dp_axis=dp_axis)
    n_dp = mesh.shape[dpax] if dpax is not None else 1
    n_mp = mesh.shape[mpax]
    slots = q_micro.shape[0]
    if slots % n_dp:
        raise ValueError(f"{slots} microbatch slots do not split over "
                         f"{n_dp} dp rows")
    n_micro = slots // n_dp
    width = torch.as_tensor(r_macro).reshape(-1).shape[0]
    seg = width // n_mp
    if seg * n_mp != width or seg % chunk:
        raise ValueError(
            f"macro-chunk of {width} does not split into "
            f"{n_mp} devices x multiple of chunk={chunk}")
    run = build_pipeline(mesh, dp_axis=dpax, mp_axis=mpax, metric=metric,
                         chunk=chunk, n_micro=n_micro, top_k=top_k,
                         excl_zone=excl_zone, excl_span=excl_span,
                         track_start=track_start,
                         entry="carry", harvest="carry")
    return run(r_macro, q_micro, qlen_micro, lo_micro, hi_micro, m_total, j0,
               carry, tune=tune)


def sdtw_sharded(queries, reference, qlens=None, *, metric: str = "abs_diff",
                 mesh: Optional[Mesh] = None, axis: str = "ref",
                 dp_axis: Optional[str] = None,
                 chunk: int = 8192, n_micro: Optional[int] = None,
                 excl_lo=None, excl_hi=None,
                 top_k: Optional[int] = None,
                 excl_zone: Optional[int] = None,
                 return_positions: bool = False,
                 return_spans: bool = False, excl_mode: str = "end",
                 tune: str = "off", device=None):
    """Batched sDTW with the reference sharded across the mesh's ranks.

    queries (nq, N), reference (M,) → (nq,) distances, bitwise the
    single-device engine's for int32 inputs — across every (dp, mp)
    factorization and every valid ``n_micro``. SPMD: every rank of
    ``mesh`` calls it with the same arguments and gets the whole answer.

    On a 1-D mesh every rank is a pipeline stage; on a 2-D (dp, mp) mesh
    each dp row runs the pipeline over its share of the microbatches with
    the reference replicated within the row (``get_mesh`` builds one).

    ``top_k=k`` returns ``(dists (nq, k), positions (nq, k))`` — the heap
    travels with the microbatch through the pipeline, in the same
    hand-off as the boundary column, so the cross-shard merge costs no
    extra collective; positions are global reference indices.
    ``return_positions=True`` alone returns the top-1 pair;
    ``return_spans=True`` returns ``(dists, starts, ends)``.
    ``excl_mode='span'`` keys heap suppression on span overlap. ``tune``
    is the kernel launch's (``ops.tuned_launch``); ``device`` this rank's
    device (``None``: the CUDA device).
    """
    dev = resolve_device(device)
    if mesh is None:
        mesh = default_mesh(axis)
    queries = as_tensor(queries, dev)
    reference = torch.as_tensor(reference)
    nq, n = queries.shape
    m = reference.shape[0]
    qlens = (torch.full((nq,), n, dtype=torch.int32) if qlens is None
             else torch.as_tensor(qlens).to(torch.int32))
    excl_lo = (torch.full((nq,), -1, dtype=torch.int32) if excl_lo is None
               else torch.as_tensor(excl_lo).to(torch.int32))
    excl_hi = (torch.full((nq,), -1, dtype=torch.int32) if excl_hi is None
               else torch.as_tensor(excl_hi).to(torch.int32))

    sched = make_schedule(mesh, nq, ref_axis=axis, dp_axis=dp_axis,
                          n_micro=n_micro)
    seg, chunk = _segment_layout(m, sched.n_mp, chunk)
    r_pad = torch.nn.functional.pad(reference, (0, seg * sched.n_mp - m))

    wants_pair = top_k is not None or return_positions or return_spans
    kk = (1 if top_k is None else top_k) if wants_pair else None
    if excl_zone is not None and np.ndim(excl_zone) != 0:
        raise ValueError("sdtw_sharded takes a scalar excl_zone (or None "
                         "for the per-query default); per-query zone "
                         "arrays are only supported on the single-device "
                         "chunked path")
    # The plain pipeline ignores the zone: pin it so non-top-K calls share
    # one cache entry. None derives it per query in the body (half the
    # true query length, or 0 in span mode), as the single-device default.
    if kk is None:
        zone = 0
    elif excl_zone is not None:
        zone = int(excl_zone)
    else:
        zone = None if excl_mode == "end" else 0
    # The start lane crosses the hand-off only when starts are consumed.
    track = return_spans or excl_mode == "span"
    run = build_pipeline(mesh, dp_axis=sched.dp_axis, mp_axis=sched.mp_axis,
                         metric=metric, chunk=chunk, n_micro=sched.n_micro,
                         top_k=kk, excl_zone=zone,
                         excl_span=excl_mode == "span", track_start=track,
                         entry="fresh", harvest="result")
    outs = run(r_pad, sched.pack(queries),
               sched.pack(qlens.to(dev), fill=1),
               sched.pack(excl_lo.to(dev), fill=-1),
               sched.pack(excl_hi.to(dev), fill=-1), m, 0, tune=tune)
    if not wants_pair:
        return sched.unpack(outs)
    dists, poss, starts = sched.unpack(outs)
    if top_k is None:                       # top-1, unstacked
        if return_spans:
            return dists[:, 0], starts[:, 0], poss[:, 0]
        return dists[:, 0], poss[:, 0]
    if return_spans:
        return dists, starts, poss
    return dists, poss
