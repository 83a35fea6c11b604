"""Batched top-K pruned subsequence search — the query-answering front door.

Counterpart of ``repro.search.search``. ``search_topk()`` answers: where
are the K best matches of each query in this reference, and are they
distinct events? It composes, in order:

  1. ragged-query bucketing (the engine's),
  2. optional z-normalization (global reference, per-query moments),
  3. the lower-bound cascade of ``repro_torch.search.lower_bounds`` over
     the cached per-chunk envelope (``repro_torch.search.cache``),
  4. chunk-level pruning: a reference chunk is scored only if some
     query's bound says it could still improve that query's heap,
  5. exact DP of each surviving chunk, warmed up by a ``halo`` of
     left-context chunks so pruning never truncates an alignment.

Step 5 runs on one of two DP backends (``engine_impl``): ``'pallas'``,
the repo's hand-written sDTW kernel (the CUDA kernel on the card, its
plain version on the CPU), scores a whole halo group in one launch and
folds the kernel's last-row capture into the heap; ``'rowscan'`` runs the
chunked row-scan tile loop. Both honour ``excl_lo``/``excl_hi`` (the
kernel as its per-query column ban), and int32 heaps are bitwise equal
between the two. ``'auto'`` takes the kernel for tensors on a CUDA
device, exclusion ranges or not (the reference sends those to the row
scan); on the CPU it is the reference's rule. An explicit
``engine_impl='pallas'`` with exclusion ranges raises, as in the
reference.

Pruning semantics — two deviations from the exact streamed path, as in
the reference:

  * **Span cap**: a match whose alignment covers more than ``span_cap``
    reference columns (default 2N) may be missed or scored from
    truncated context. Under the cap, the top-1 *distance* is exactly
    ``engine.sdtw()``'s answer (bitwise for int32).
  * **Greedy order**: surviving chunks are visited in bound order, so for
    k > 1 the exclusion-zone suppression can resolve differently from the
    streamed path, and exact distance ties can report a different
    (equally optimal) end position.

With ``prune=False`` both caveats vanish: the kernel streams the whole
reference through its chunk carry, folding each chunk's last row into the
heap (``engine_impl='pallas'``), or the engine's chunked path runs it
(``'rowscan'``) — the same heap, bit for bit, for int32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.distances import accum_dtype, result_dtype
from repro_torch.core.request import SdtwRequest
from repro_torch.core.sdtw import (default_excl_zone, sdtw_carry_init,
                                   sdtw_chunk_batch_topk, sdtw_segment,
                                   topk_fold_lastrow)
from repro_torch.core.topk import topk_init
from repro_torch.device import as_tensor, resolve_device

from . import cache as cache_mod
from .lower_bounds import lb_cascade, znorm, znorm_padded

#: Default warping-span cap, in query lengths.
DEFAULT_SPAN_FACTOR = 2

#: Smallest pruning tile — below this the per-chunk dispatch overhead
#: exceeds the DP it would skip.
MIN_CHUNK = 64


@dataclasses.dataclass
class SearchResult:
    """Top-K matches plus pruning telemetry for one ``search_topk`` call."""
    distances: object           # (nq, k) best-first; BIG-padded
    positions: object           # (nq, k) global end indices; -1-padded
    chunk: int                  # pruning tile size used
    starts: object = None       # (nq, k) global start indices; -1-padded
    chunks_total: int = 0      # candidate chunks across all buckets
    chunks_pruned_kim: int = 0    # skipped on the constant-time bound
    chunks_pruned_keogh: int = 0  # skipped on the envelope bound
    chunks_processed: int = 0     # dispatched to the DP

    @property
    def chunks_pruned(self) -> int:
        return self.chunks_pruned_kim + self.chunks_pruned_keogh

    @property
    def spans(self):
        """(nq, k, 2) stacked (start, end) spans."""
        return torch.stack([self.starts, self.positions], dim=-1)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def default_chunk(m: int, n: int) -> int:
    """Pruning tile heuristic: ≥ MIN_CHUNK, ≥ the query (so one chunk can
    hold a whole match), ~eighth of the reference (so there is something
    to prune), capped at the engine's streaming default."""
    return max(MIN_CHUNK,
               min(engine.DEFAULT_CHUNK,
                   _pow2_at_least(max(n, m // 8))))


def _auto_engine(dev: torch.device) -> str:
    """``engine_impl='auto'``: the kernel on a CUDA device (exclusion
    ranges as its ban), the row scan elsewhere (the reference's rule)."""
    return "pallas" if dev.type == "cuda" else "rowscan"


def _pruned_chunk_step(queries, qlens, seg, heap_d, heap_p, heap_s, j0: int,
                       m_total: int, excl_lo, excl_hi, excl_zone, *, metric,
                       chunk: int, halo: int, k: int, excl_span: bool,
                       engine_impl: str = "rowscan"):
    """Score one surviving chunk and fold its candidates into the heap.

    ``seg`` is the chunk plus ``halo`` left-context chunks starting at
    global column ``j0`` (negative for the first ``halo`` chunks); the DP
    runs from a fresh carry at the group start, columns outside
    ``[0, m_total)`` masked, and only the *target* chunk's last-row
    candidates are harvested — the halo warms the boundary carry (value
    and start lanes), so a match of span ≤ halo·chunk is scored with full
    context.

    ``engine_impl='pallas'`` scores the whole group in one kernel launch
    with the last-row capture (the leading pad and trailing overhang are
    the kernel's ``ref_lead`` / ``ref_len`` masks, the exclusion ranges its
    ban, in global columns like the row scan's) and folds the target
    chunk's candidate row with the same ``topk_merge`` — int32 heaps are
    bitwise equal to the rowscan variant.
    """
    nq, n = queries.shape
    acc = accum_dtype(result_dtype(queries, seg))
    if engine_impl == "pallas":
        from repro_torch.kernels.sdtw import sdtw_cuda
        seg_len = seg.shape[0]
        _, lrow, lstart = sdtw_cuda(
            queries, seg, qlens, metric, track_start=True,
            return_lastrow=True, ref_offset=j0,
            ref_len=min(max(m_total - j0, 0), seg_len),
            ref_lead=max(0, -j0), device=queries.device, excl_lo=excl_lo,
            excl_hi=excl_hi)
        return topk_fold_lastrow(
            (heap_d.to(acc), heap_p, heap_s), lrow[:, halo * chunk:],
            lstart[:, halo * chunk:], j0 + halo * chunk, k, excl_zone,
            excl_span)
    carry = sdtw_carry_init(nq, n, acc, track_start=True,
                            device=queries.device)
    if halo:
        carry = sdtw_segment(queries, seg[:halo * chunk], qlens, carry, j0,
                             m_total, metric, chunk, excl_lo, excl_hi)
    carry = carry + (heap_d.to(acc), heap_p, heap_s)
    _, _, _, heap_d, heap_p, heap_s = sdtw_chunk_batch_topk(
        queries, seg[halo * chunk:], qlens, carry, j0 + halo * chunk,
        m_total, metric, excl_lo, excl_hi, k, excl_zone, excl_span,
        track_start=True)
    return heap_d, heap_p, heap_s


def _kernel_topk_scan(queries, reference, qlens, *, k, metric, chunk, zone,
                      excl_span, excl_lo=None, excl_hi=None):
    """The exact top-K heap through the kernel: the reference streams
    chunk by chunk through the kernel's chunk carry (start lane on, the
    exclusion ranges — ``kernel_bans`` output — as the kernel's ban), each
    chunk's last-row capture folded into the heap — the tile boundaries
    and the merge of ``sdtw_chunked``, so int32 heaps are bitwise its."""
    from repro_torch.kernels.sdtw import kernel_carry_init, sdtw_cuda
    nq, n = queries.shape
    m = reference.shape[0]
    acc = accum_dtype(result_dtype(queries, reference))
    n_chunks = -(-m // chunk)
    r_pad = torch.nn.functional.pad(reference, (0, n_chunks * chunk - m))
    carry = kernel_carry_init(nq, n, acc, track_start=True,
                              device=queries.device)
    heap = topk_init(nq, k, acc, device=queries.device)
    for t in range(n_chunks):
        off = t * chunk
        _, carry, lrow, lstart = sdtw_cuda(
            queries, r_pad[off:off + chunk], qlens, metric, carry=carry,
            return_carry=True, ref_offset=off, ref_len=min(chunk, m - off),
            track_start=True, return_lastrow=True, device=queries.device,
            excl_lo=excl_lo, excl_hi=excl_hi)
        heap = topk_fold_lastrow(heap, lrow, lstart, off, k, zone, excl_span)
    return heap


def _query_zones(qlens, nq, excl_zone, excl_mode, device):
    if excl_zone is not None:
        return torch.full((nq,), int(excl_zone), dtype=torch.int32,
                          device=device)
    if excl_mode == "end":
        return default_excl_zone(qlens).to(device)
    return torch.zeros((nq,), dtype=torch.int32, device=device)


def _search_padded(queries, reference, qlens, *, k, metric, chunk, prune,
                   halo, excl_zone, excl_mode, excl_lo, excl_hi, env,
                   engine_impl="rowscan"):
    """Pruned search for one padded (nq, N) bucket on the queries' device.
    Returns (dists, positions, starts, stats_tuple)."""
    nq, n = queries.shape
    m = reference.shape[0]
    dev = queries.device
    acc = accum_dtype(result_dtype(queries, reference))
    n_chunks = -(-m // chunk)
    if qlens is None:
        qlens = torch.full((nq,), n, dtype=torch.int32, device=dev)
    qlens = as_tensor(qlens, dev, torch.int32)
    if engine_impl == "pallas":
        # Tested once here, so that no launch synchronises on them.
        from repro_torch.kernels.sdtw.ops import kernel_bans
        excl_lo, excl_hi = kernel_bans(excl_lo, excl_hi, nq, dev,
                                       test_device=True) or (None, None)

    if not prune:
        if engine_impl == "pallas":
            d, p, s = _kernel_topk_scan(
                queries, reference, qlens, k=k, metric=metric, chunk=chunk,
                zone=_query_zones(qlens, nq, excl_zone, excl_mode, dev),
                excl_span=excl_mode == "span", excl_lo=excl_lo,
                excl_hi=excl_hi)
        else:
            d, s, p = engine.sdtw(queries, reference, qlens, metric=metric,
                                  impl="chunked", chunk=chunk, top_k=k,
                                  excl_zone=excl_zone, excl_lo=excl_lo,
                                  excl_hi=excl_hi, excl_mode=excl_mode,
                                  return_spans=True, device=dev)
        return d, p, s, (n_chunks, 0, 0, n_chunks)

    if engine_impl != "pallas":
        excl_lo = engine._normalize_excl(excl_lo, nq, dev)
        excl_hi = engine._normalize_excl(excl_hi, nq, dev)
    zone = _query_zones(qlens, nq, excl_zone, excl_mode, dev)

    mins, maxs = env
    kim, keogh = lb_cascade(queries, qlens, mins, maxs, halo, metric)
    kim = kim.cpu().numpy()
    keogh = keogh.cpu().numpy()

    # Right-pad to a chunk multiple, left-pad a halo of masked columns so
    # every chunk group has the same shape (j < 0 is masked in the DP).
    r_pad = torch.nn.functional.pad(reference, (0, n_chunks * chunk - m))
    r_ext = torch.nn.functional.pad(r_pad, (halo * chunk, 0))

    heap_d, heap_p, heap_s = topk_init(nq, k, acc, device=dev)
    pruned_kim = pruned_keogh = processed = 0
    # Most promising chunks first: thresholds tighten fastest. The k-th
    # best threshold only moves when a chunk is processed, so the one
    # device→host fetch happens per processed chunk; the comparison is
    # the reference's, in float64 on the host.
    thr = heap_d[:, -1].double().cpu().numpy()
    order = np.argsort(keogh.min(axis=0), kind="stable")
    for c in order:
        if np.all(kim[:, c] >= thr):
            pruned_kim += 1
            continue
        if np.all(keogh[:, c] >= thr):
            pruned_keogh += 1
            continue
        processed += 1
        group = r_ext[c * chunk:(c + halo + 1) * chunk]
        heap_d, heap_p, heap_s = _pruned_chunk_step(
            queries, qlens, group, heap_d, heap_p, heap_s,
            int((c - halo) * chunk), m, excl_lo, excl_hi, zone,
            metric=metric, chunk=chunk, halo=halo, k=k,
            excl_span=(excl_mode == "span"), engine_impl=engine_impl)
        thr = heap_d[:, -1].double().cpu().numpy()
    return heap_d, heap_p, heap_s, (n_chunks, pruned_kim, pruned_keogh,
                                    processed)


def search_topk(queries, reference, k: int = 1, *, qlens=None,
                metric: str = "abs_diff", chunk: Optional[int] = None,
                prune: bool = True, span_cap: Optional[int] = None,
                excl_zone: Optional[int] = None, excl_mode: str = "end",
                normalize: bool = False, excl_lo=None, excl_hi=None,
                mesh=None, ref_axis: str = "ref",
                cache: Optional[cache_mod.EnvelopeCache] = None,
                ref_key=None, engine_impl: str = "auto",
                device=None) -> SearchResult:
    """Top-K subsequence matches of each query in ``reference``.

    Args as ``repro.search.search_topk``: ``queries`` (nq, N) padded, one
    (N,) query, or a ragged list; ``reference`` (M,); ``k``; ``qlens``;
    ``metric``; ``chunk`` (pruning tile, default ``default_chunk``);
    ``prune``; ``span_cap`` (default 2N); ``excl_zone`` (scalar or None
    for the per-query default); ``excl_mode`` ('end' | 'span');
    ``normalize``; ``excl_lo``/``excl_hi``; ``cache`` (default
    ``DEFAULT_CACHE``); ``ref_key``; ``engine_impl`` ('auto', 'rowscan'
    or 'pallas', the hand-written kernel; 'auto' is the kernel on the
    card, exclusion ranges included). ``device`` is where it runs:
    ``None`` is the CUDA device, ``"cpu"`` the plain PyTorch versions.
    ``mesh`` (with ``prune=False``) scores every chunk on the sharded
    engine over the mesh's ranks along ``ref_axis`` (SPMD: every rank
    calls it alike).

    Returns a ``SearchResult`` whose distances/positions/starts are
    (nq, k) tensors on the device (or (k,) for a single 1-D query), best
    first, ``(BIG, -1, -1)``-padded.
    """
    return SdtwRequest(
        op="search_topk", queries=queries, reference=reference, top_k=k,
        qlens=qlens, metric=metric, chunk=chunk, prune=prune,
        span_cap=span_cap, excl_zone=excl_zone, excl_mode=excl_mode,
        normalize=normalize, excl_lo=excl_lo, excl_hi=excl_hi, mesh=mesh,
        ref_axis=ref_axis, cache=cache, ref_key=ref_key,
        engine_impl=engine_impl, device=device).run()


def _execute_search(req: SdtwRequest) -> SearchResult:
    """The search dispatcher behind ``SdtwRequest.run()`` (the request is
    validated)."""
    dev = resolve_device(req.device)
    k, metric, chunk = req.top_k, req.metric, req.chunk
    excl_lo, excl_hi = req.excl_lo, req.excl_hi
    engine_impl = req.engine_impl
    if engine_impl == "auto":
        engine_impl = _auto_engine(dev)
    reference = as_tensor(req.reference, dev)
    if req.normalize:
        reference = znorm(reference)
    m = reference.shape[0]
    cache = cache_mod.DEFAULT_CACHE if req.cache is None else req.cache

    queries = req.queries
    ragged = isinstance(queries, (list, tuple))
    single = False
    if ragged:
        qs = [q.cpu().numpy() if isinstance(q, torch.Tensor)
              else np.asarray(q) for q in queries]
        buckets = engine.bucketize([len(q) for q in qs])
        nq = len(qs)
        lo_all = engine._normalize_excl(excl_lo, nq, "cpu").numpy()
        hi_all = engine._normalize_excl(excl_hi, nq, "cpu").numpy()
    else:
        queries = as_tensor(queries, dev)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        nq = queries.shape[0]
        buckets = {queries.shape[1]: list(range(nq))}

    outs = []
    totals = [0, 0, 0, 0]
    used_chunk = None
    for blen, idxs in buckets.items():
        if ragged:
            padded, lens = engine.pad_ragged_bucket(qs, idxs, blen)
            bq = torch.from_numpy(padded).to(dev)
            bql = torch.from_numpy(lens).to(dev)
            blo = torch.from_numpy(lo_all[idxs]).to(dev)
            bhi = torch.from_numpy(hi_all[idxs]).to(dev)
        else:
            bq, bql, blo, bhi = queries, req.qlens, excl_lo, excl_hi
            if bql is not None:
                bql = as_tensor(bql, dev, torch.int32)
        if req.normalize:
            bq = znorm_padded(bq, torch.full((len(idxs),), blen,
                                             dtype=torch.int32, device=dev)
                              if bql is None else bql)
        n = bq.shape[1]
        c = default_chunk(m, n) if chunk is None else int(chunk)
        used_chunk = c if used_chunk is None else max(used_chunk, c)
        cap = (DEFAULT_SPAN_FACTOR * n if req.span_cap is None
               else int(req.span_cap))
        halo = max(1, -(-cap // c))
        if req.mesh is not None:
            d, s, p = engine.sdtw(bq, reference, bql, metric=metric,
                                  mesh=req.mesh, ref_axis=req.ref_axis,
                                  chunk=c, top_k=k, excl_zone=req.excl_zone,
                                  excl_mode=req.excl_mode, excl_lo=blo,
                                  excl_hi=bhi, return_spans=True, device=dev)
            stats = (-(-m // c), 0, 0, -(-m // c))
        else:
            # The cached envelope belongs to the array actually searched —
            # a normalized search must not share entries with a raw one
            # under the same user key.
            env_key = (None if req.ref_key is None
                       else (req.ref_key, bool(req.normalize)))
            env = cache.envelope(reference, c, key=env_key) if req.prune \
                else None
            d, p, s, stats = _search_padded(
                bq, reference, bql, k=k, metric=metric, chunk=c,
                prune=req.prune, halo=halo, excl_zone=req.excl_zone,
                excl_mode=req.excl_mode, excl_lo=blo, excl_hi=bhi, env=env,
                engine_impl=engine_impl)
        for t in range(4):
            totals[t] += stats[t]
        outs.append((idxs, d, p, s))

    if ragged:
        # Buckets may differ in dtype; stack on the host, in caller order.
        res = []
        for t in (1, 2, 3):
            rows = [None] * nq
            for out in outs:
                vals = out[t].cpu().numpy()
                for j, i in enumerate(out[0]):
                    rows[i] = vals[j]
            res.append(torch.from_numpy(np.stack(rows)).to(dev))
        dists, poss, starts = res
    else:
        _, dists, poss, starts = outs[0]
        if single:
            dists, poss, starts = dists[0], poss[0], starts[0]
    return SearchResult(distances=dists, positions=poss, starts=starts,
                        chunk=used_chunk, chunks_total=totals[0],
                        chunks_pruned_kim=totals[1],
                        chunks_pruned_keogh=totals[2],
                        chunks_processed=totals[3])
