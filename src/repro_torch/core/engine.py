"""The sDTW engine — the front door every caller routes through.

Counterpart of ``repro.core.engine``: ``sdtw`` and its dispatch,
``align`` (span plus warping path) and ``stream`` (online sessions,
``repro_torch.stream``). ``sdtw()`` hides the execution regimes behind
one call:

  * ``rowscan`` / ``wavefront`` — the in-core schedules of
    ``repro_torch.core.sdtw``, plain PyTorch on any device.
  * ``pallas``  — the repo's hand-written sDTW kernel
    (``repro_torch.kernels.sdtw``): the CUDA kernel for tensors on the
    card, its plain PyTorch version on the CPU. The name is kept from
    the reference so that callers port like for like.
  * ``chunked`` — reference streaming in fixed tiles with the O(N)
    boundary-column carry (MATSA's inter-subarray pass gates, §III-B).
  * ``sharded`` — the reference axis sharded across the ranks of a
    ``repro_torch.distributed.Mesh`` (``distributed.sdtw_sharded``): the
    chunk carry is handed between neighbouring ranks, each rank's
    segment scored by the kernel on the card. SPMD: every rank calls
    ``sdtw`` with the same arguments and gets the whole answer.

Dispatch rules (``impl="auto"``), the reference's rules with rule 3
read for the card:

  1. ``mesh`` given (or ``impl="sharded"``)        → sharded driver.
  2. ``top_k`` or ``chunk`` given                  → chunked streaming.
  3. the tensors are on a CUDA device              → the sDTW kernel (it
     loops over any M inside each block; exclusion zones become its
     per-query column ban, where the reference's rule 3 passes them on
     to rules 4-6 — the same answers, a fully banned query's end
     included).
  4. M ≥ ``CHUNK_THRESHOLD``                       → chunked streaming.
  5. M < 2·N                                       → wavefront.
  6. otherwise                                     → rowscan.

Rules 1-4 are structural; rules 5-6 are the ``tune='off'`` heuristics.
Under the default ``tune='model'`` the in-core choice on the CPU comes
from the ``repro_torch.tune`` ranking (or a tuning-table hit) with the
reference's CPU constants, so it matches the JAX package's; on the card
rule 3 stays structural and the oracle decides the kernel's launch —
kernel, R, warps, queries a block, tile (``ops.tuned_launch``); the
chunked path takes its ``chunk`` from the same oracle (on the CPU).
``sdtw(..., explain=True)`` returns the ``repro_torch.tune
.DispatchDecision`` of what ran and why.

``impl='pallas'`` with ``chunk=`` streams the reference through the
kernel's chunk carry: references up to ``PALLAS_FUSED_MAX`` samples run
as one launch (the kernel walks the whole reference itself, ``chunk`` is
advisory), longer ones slice by slice on the device, the carry never
leaving it (``_pallas_scan_streamed``). ``_pallas_host_loop`` keeps the
one-upload-per-slice loop for a reference held on the host.

Ragged batches: a *list* of 1-D queries is bucketed by power-of-two
padded length (at least ``MIN_BUCKET``) and each bucket runs as one call.

An explicit ``impl='pallas'`` with exclusion ranges raises, as in the
reference; only ``'auto'`` takes them to the kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import as_tensor, resolve_device, to_numpy
from .distances import accum_dtype, big, result_dtype
from .request import SdtwRequest, StreamRequest
from .sdtw import sdtw_batch, sdtw_chunked
from .traceback import DEFAULT_TRACE_CHUNK, AlignResult, traceback_path

CHUNK_THRESHOLD = 1 << 17   # auto-switch to streaming above this M
DEFAULT_CHUNK = 8192        # tile size for chunked streaming
MIN_BUCKET = 16             # smallest ragged-batch padded length
#: Longest reference the ``impl='pallas'`` + ``chunk=`` path runs as one
#: launch; longer references stream slice by slice.
PALLAS_FUSED_MAX = 1 << 22


def choose_impl_explained(nq: int, n: int, m: int, *,
                          backend: Optional[str] = None, mesh=None,
                          chunk: Optional[int] = None,
                          has_exclusion: bool = False,
                          top_k: Optional[int] = None, tune: str = "off",
                          metric: str = "abs_diff",
                          dtype: str = "int32") -> tuple:
    """``choose_impl`` with its reasoning: ``(impl, source, reason,
    candidates)``, with ``source``/``candidates`` as in
    ``repro_torch.tune.DispatchDecision``. ``backend`` is the device type
    the call runs on (``'cuda'``, the default, or ``'cpu'``). The
    structural rules fire before any scoring; with ``tune != 'off'`` the
    remaining in-core choice comes from the cost-model ranking (or a
    tuning-table hit) instead of the ``M < 2N`` rule."""
    if mesh is not None:
        return ("sharded", "structural", "mesh shards the reference axis",
                ())
    if top_k is not None:
        return ("chunked", "structural",
                "top-K heap rides the chunk boundary carry", ())
    if chunk is not None:
        return ("chunked", "structural", "explicit chunk forces streaming",
                ())
    backend = "cuda" if backend is None else backend
    if backend == "cuda":
        return ("pallas", "structural",
                "CUDA device (the sDTW kernel walks any M and bans "
                "exclusion zones per query)", ())
    if m >= CHUNK_THRESHOLD:
        return ("chunked", "structural",
                f"M >= CHUNK_THRESHOLD (1<<{CHUNK_THRESHOLD.bit_length() - 1})",
                ())
    if tune != "off":
        from repro_torch.tune import rank_incore
        res = rank_incore(nq, n, m, backend=backend, metric=metric,
                          dtype=dtype, mode=tune)
        impl = res.config.impl
        if impl in ("rowscan", "wavefront"):
            return (impl, res.source, f"in-core ranking ({res.source})",
                    res.candidates)
    if m < 2 * n:
        return ("wavefront", "legacy", "M < 2N: diagonal depth is cheap", ())
    return ("rowscan", "legacy", "default in-core schedule", ())


def choose_impl(nq: int, n: int, m: int, *, backend: Optional[str] = None,
                mesh=None, chunk: Optional[int] = None,
                has_exclusion: bool = False, top_k: Optional[int] = None,
                tune: str = "off", metric: str = "abs_diff",
                dtype: str = "int32") -> str:
    """The ``impl="auto"`` dispatch rule (see the module docstring)."""
    return choose_impl_explained(
        nq, n, m, backend=backend, mesh=mesh, chunk=chunk,
        has_exclusion=has_exclusion, top_k=top_k, tune=tune, metric=metric,
        dtype=dtype)[0]


def _bucket_len(length: int) -> int:
    return max(MIN_BUCKET, 1 << max(0, int(length) - 1).bit_length())


def _normalize_excl(val, nq: int, device):
    if val is None:
        return torch.full((nq,), -1, dtype=torch.int32, device=device)
    arr = as_tensor(val, device, torch.int32)
    return arr.expand(nq) if arr.ndim == 0 else arr


def sdtw(queries, reference, qlens=None, *, metric: str = "abs_diff",
         impl: str = "auto", chunk: Optional[int] = None, excl_lo=None,
         excl_hi=None, mesh=None, mesh_shape=None, ref_axis: str = "ref",
         n_micro: Optional[int] = None, top_k: Optional[int] = None,
         return_positions: bool = False, return_spans: bool = False,
         excl_zone=None, excl_mode: str = "end",
         block_q: Optional[int] = None, block_m: Optional[int] = None,
         tune: str = "model", explain: bool = False, device=None):
    """Subsequence-DTW distances of ``queries`` against ``reference``.

    Args as ``repro.core.engine.sdtw``: ``queries`` (nq, N) padded, a
    single (N,) query, or a list of 1-D queries (ragged); ``reference``
    (M,); ``qlens`` (nq,) true lengths; ``metric``; ``impl`` (one of
    ``request.IMPLS``; ``'pallas'`` is the hand-written sDTW kernel);
    ``chunk``; ``excl_lo``/``excl_hi``; ``top_k``; ``return_positions``;
    ``return_spans``; ``excl_zone``; ``excl_mode``; ``block_q``/
    ``block_m`` (the kernel's queries per block and staged reference
    tile); ``tune`` (``'model'``, the default, fills unset performance
    knobs from the ``repro_torch.tune`` oracle — on the card the kernel's
    launch, on the CPU the in-core schedule and the chunk size;
    ``'measure'`` refines the bucket with a short measured search first,
    once per process; ``'off'`` keeps the hand-set policies; explicit
    knobs always win, and int32 answers do not depend on it); ``explain``
    (return ``(result, DispatchDecision)``; not for ragged lists).
    ``device`` is where it runs: ``None`` is the CUDA device (an error
    when none is present), ``"cpu"`` the plain PyTorch versions.
    ``mesh`` (a ``repro_torch.distributed.Mesh``) or ``mesh_shape`` (an
    int, ``(mp,)`` or ``(dp, mp)``, built by ``distributed.get_mesh``)
    shards the reference over the mesh's ranks along ``ref_axis``;
    ``n_micro`` is the pipeline's microbatch count per dp row. A sharded
    call is SPMD: every rank of the mesh makes it with the same arguments
    and every rank gets the whole answer.

    Returns (nq,) distances in the accumulator dtype — a 0-d tensor for a
    single 1-D query; a (dists, positions) pair or (dists, starts, ends)
    triple in the positions/spans modes; (nq, k) stacks with ``top_k``.
    A query whose every column is banned by ``excl_lo``/``excl_hi`` gets
    distance BIG on every route, but its end and start depend on the
    route, as in the reference: column 0 on the row scan, -1 on the
    wavefront, chunked and top-K routes. On the card ``impl='auto'``
    takes the kernel, and answers as the route the reference's rules
    4-6 pick for the same shape (column 0 where that is the row scan).
    """
    return SdtwRequest(
        queries=queries, reference=reference, qlens=qlens, metric=metric,
        impl=impl, chunk=chunk, excl_lo=excl_lo, excl_hi=excl_hi, mesh=mesh,
        mesh_shape=mesh_shape, ref_axis=ref_axis, n_micro=n_micro,
        top_k=top_k, return_positions=return_positions,
        return_spans=return_spans, excl_zone=excl_zone, excl_mode=excl_mode,
        block_q=block_q, block_m=block_m, tune=tune, explain=explain,
        device=device).run()


def _execute_sdtw(req: SdtwRequest):
    """The dispatcher behind ``SdtwRequest.run()`` (the request is
    validated): shape resolution, ``impl='auto'`` dispatch and the
    execution paths."""
    dev = resolve_device(req.device)
    if isinstance(req.queries, (list, tuple)):
        if req.explain:
            raise ValueError(
                "explain=True is not supported for ragged query lists — "
                "each bucket may dispatch differently; call per bucket")
        return _sdtw_ragged(req, dev)

    queries = as_tensor(req.queries, dev)
    reference = as_tensor(req.reference, dev)
    single = queries.ndim == 1
    if single:
        queries = queries[None, :]
    nq, n = queries.shape
    m = reference.shape[0]
    qlens = None if req.qlens is None else as_tensor(req.qlens, dev,
                                                     torch.int32)
    dtype = str(result_dtype(queries, reference)).removeprefix("torch.")
    tune = req.tune
    if tune == "measure" and dev.type != "cuda":
        # The measured refinement runs before dispatch, once per process
        # per bucket; every later consultation is a table hit. On the card
        # the kernel's launch resolves it (``ops.tuned_launch``).
        from repro_torch.tune import resolve
        resolve(nq, n, m, backend=dev.type, metric=req.metric, dtype=dtype,
                mode="measure", span=req.return_spans)
    has_excl = req.excl_lo is not None or req.excl_hi is not None
    if req.impl == "pallas" and has_excl:
        raise ValueError("the pallas kernel does not support exclusion "
                         "zones; use impl='rowscan' or 'chunked'")
    impl = req.impl
    if impl == "auto":
        impl, source, reason, candidates = choose_impl_explained(
            nq, n, m, backend=dev.type, mesh=req.mesh, chunk=req.chunk,
            has_exclusion=has_excl, top_k=req.top_k, tune=tune,
            metric=req.metric, dtype=dtype)
    else:
        source, reason, candidates = ("explicit",
                                      "impl forced by the caller", ())

    config: dict = {}
    if impl in ("rowscan", "wavefront"):
        lo = _normalize_excl(req.excl_lo, nq, dev) if has_excl else None
        hi = _normalize_excl(req.excl_hi, nq, dev) if has_excl else None
        out = sdtw_batch(queries, reference, qlens, req.metric, impl, lo, hi,
                         return_positions=req.return_positions,
                         return_spans=req.return_spans)
    elif impl == "pallas":
        from repro_torch.kernels.sdtw import sdtw_cuda
        if req.chunk is None:
            out = sdtw_cuda(queries, reference, qlens, req.metric,
                            block_q=req.block_q, block_m=req.block_m,
                            return_positions=req.return_positions,
                            return_spans=req.return_spans, device=dev,
                            excl_lo=req.excl_lo, excl_hi=req.excl_hi,
                            tune=tune)
            if (has_excl and isinstance(out, tuple)
                    and choose_impl_explained(
                        nq, n, m, backend="cpu", has_exclusion=True,
                        tune=tune, metric=req.metric,
                        dtype=dtype)[0] == "rowscan"):
                out = _as_row_scan(out)
        else:
            out = _pallas_streamed(queries, reference, qlens, req.metric,
                                   req.chunk, req.block_q, req.block_m,
                                   req.return_positions, req.return_spans,
                                   tune=tune)
        if req.explain:
            config, kcands = _kernel_decision(req, queries, reference, dev,
                                              tune)
            candidates = candidates or kcands
    elif impl == "chunked":
        chunk = req.chunk
        if chunk is None and tune != "off":
            from repro_torch.tune import tuned_chunk
            chunk = tuned_chunk(nq, n, m, backend=dev.type,
                                metric=req.metric, dtype=dtype, mode=tune)
        config = {"chunk": chunk or DEFAULT_CHUNK}
        out = sdtw_chunked(queries, reference, qlens, req.metric,
                           config["chunk"],
                           _normalize_excl(req.excl_lo, nq, dev),
                           _normalize_excl(req.excl_hi, nq, dev),
                           top_k=req.top_k, excl_zone=req.excl_zone,
                           return_positions=req.return_positions,
                           return_spans=req.return_spans,
                           excl_mode=req.excl_mode)
    else:  # sharded
        from repro_torch.distributed.sdtw_sharded import sdtw_sharded
        n_micro = req.n_micro
        if n_micro is None and tune != "off" and req.mesh is not None:
            from repro_torch.tune import resolve_n_micro
            sizes = dict(req.mesh.shape)
            n_mp = int(sizes.pop(req.ref_axis, 1))
            n_dp = int(np.prod(list(sizes.values()))) if sizes else 1
            n_micro = resolve_n_micro(nq, n_dp, n_mp, n=n, m=m,
                                      backend=dev.type, metric=req.metric,
                                      dtype=dtype, mode=tune)
        config = {"chunk": req.chunk or DEFAULT_CHUNK, "n_micro": n_micro}
        out = sdtw_sharded(queries, reference, qlens, metric=req.metric,
                           mesh=req.mesh, axis=req.ref_axis, n_micro=n_micro,
                           chunk=req.chunk or DEFAULT_CHUNK,
                           excl_lo=_normalize_excl(req.excl_lo, nq, dev),
                           excl_hi=_normalize_excl(req.excl_hi, nq, dev),
                           top_k=req.top_k, excl_zone=req.excl_zone,
                           return_positions=req.return_positions,
                           return_spans=req.return_spans,
                           excl_mode=req.excl_mode, tune=tune, device=dev)
    if single:
        out = tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]
    if req.explain:
        from repro_torch.tune import DispatchDecision
        return out, DispatchDecision(
            impl=impl, source=source, reason=reason, config=config,
            score_us=candidates[0][1] if candidates else None,
            candidates=candidates)
    return out


def _kernel_decision(req: SdtwRequest, queries, reference, dev, tune):
    """The kernel route's ``explain`` payload: ``(config, candidates)`` —
    on the card the launch ``ops.tuned_launch`` resolves (the same oracle
    lookup the launch made) with, under ``'source'``, where its knobs came
    from (``'legacy'``: the hand-set policy); on the CPU the plain
    version, which has no launch knobs."""
    if dev.type != "cuda":
        return {"kernel": "plain"}, ()
    from repro_torch.core.distances import accum_dtype
    from repro_torch.kernels.sdtw import ops
    b, n = queries.shape
    bans = ops.kernel_bans(req.excl_lo, req.excl_hi, b, dev)
    acc = accum_dtype(result_dtype(queries, reference))
    cfg, res = ops.tuned_launch(
        b, n, reference.shape[0], sms=ops.sm_count(dev.index),
        block_q=req.block_q, block_m=req.block_m,
        variant="span" if req.return_spans else "plain",
        ban=bans is not None, metric=req.metric,
        dtype=str(acc).removeprefix("torch."), tune=tune)
    return ({**cfg, "source": res.source if res else "legacy"},
            res.candidates if res else ())


def stream(queries, *, qlens=None, metric: str = "abs_diff",
           impl: str = "auto", chunk: Optional[int] = None, mesh=None,
           mesh_shape=None, ref_axis: str = "ref",
           n_micro: Optional[int] = None, top_k: Optional[int] = None,
           excl_zone=None, excl_mode: str = "end",
           return_spans: bool = False, return_positions: bool = False,
           excl_lo=None, excl_hi=None, prune: bool = False,
           span_cap: Optional[int] = None, alert_threshold=None,
           on_alert=None, cache=None, ref_key=None,
           block_q: Optional[int] = None, block_m: Optional[int] = None,
           device=None):
    """Open an online monitoring session: the streaming front door.

    Args as ``repro.core.engine.stream``. The session's ``feed(chunk)``
    consumes the reference as an unbounded chunk sequence;
    ``results()`` at any point equals the offline ``sdtw()`` /
    ``search_topk()`` answer over the samples fed so far (bitwise for
    int32, any feed partition); ``snapshot()`` / ``StreamSession.restore``
    give fault-tolerant serving, in the reference's snapshot format.
    ``mesh``/``mesh_shape`` (or ``impl='sharded'``) open a
    ``ShardedStreamSession`` over the mesh's ranks (SPMD: every rank opens
    and feeds it alike). ``impl='pallas'`` streams fed tiles through the sDTW kernel's carry —
    top-K heaps, alerts and pruning scoring on its last-row capture;
    ``'auto'`` picks it on a CUDA device (per-query exclusion ranges as
    the kernel's column ban; an explicit ``'pallas'`` refuses them, as in
    the reference) and the row-scan loop elsewhere. ``device`` is where
    the session runs
    (``None``: the CUDA device).
    """
    return StreamRequest(
        queries=queries, qlens=qlens, metric=metric, impl=impl,
        chunk=chunk, mesh=mesh, mesh_shape=mesh_shape, ref_axis=ref_axis,
        n_micro=n_micro, top_k=top_k, excl_zone=excl_zone,
        excl_mode=excl_mode, return_spans=return_spans,
        return_positions=return_positions, excl_lo=excl_lo,
        excl_hi=excl_hi, prune=prune, span_cap=span_cap,
        alert_threshold=alert_threshold, on_alert=on_alert, cache=cache,
        ref_key=ref_key, block_q=block_q, block_m=block_m,
        device=device).open()


def align(queries, reference, qlens=None, *, metric: str = "abs_diff",
          impl: str = "auto", chunk: Optional[int] = None, mesh=None,
          ref_axis: str = "ref", trace_chunk: int = DEFAULT_TRACE_CHUNK,
          device=None):
    """Best alignment of each query, localized: span plus full warping
    path.

    Two bounded-memory passes, as ``repro.core.engine.align``: (1) the
    engine's span mode finds ``(distance, start, end)`` on ``device`` on
    whatever path ``impl``/"auto" selects (the kernel's span variant on
    the card); only those (B,) spans, the queries and each span's
    reference window come to the host; (2) ``traceback_path`` re-runs the
    DP inside the ``[start, end]`` window in ``trace_chunk``-column blocks
    to recover the monotone warping path.

    Returns an ``AlignResult`` for a single 1-D query, else a list of
    ``AlignResult`` (one per query, in caller order; ragged lists
    accepted). Saturated matches (distance ≥ BIG) come back with
    ``start = end = -1`` and ``path = None``. ``mesh`` runs pass (1) on
    the sharded engine (SPMD: every rank calls ``align`` alike).
    """
    ragged = isinstance(queries, (list, tuple))
    single = not ragged and np.ndim(queries) == 1
    d, s, e = sdtw(queries, reference, qlens, metric=metric, impl=impl,
                   chunk=chunk, mesh=mesh, ref_axis=ref_axis,
                   return_spans=True, device=device)
    d, s, e = (np.atleast_1d(to_numpy(x)) for x in (d, s, e))
    if ragged:
        qs = [to_numpy(q) for q in queries]
    else:
        q2 = to_numpy(queries)
        q2 = q2[None, :] if q2.ndim == 1 else q2
        lens = (np.full((q2.shape[0],), q2.shape[1], np.int64)
                if qlens is None else to_numpy(qlens).astype(np.int64))
        qs = [q2[i, :int(lens[i])] for i in range(q2.shape[0])]
    BIG = big(torch.float32 if d.dtype.kind == "f" else torch.int32)
    results = []
    for i, q in enumerate(qs):
        if d[i] >= BIG or s[i] < 0:
            results.append(AlignResult(distance=d[i], start=-1, end=-1,
                                       path=None))
            continue
        start, end = int(s[i]), int(e[i])
        window = to_numpy(reference[start:end + 1])
        path = traceback_path(q, window, 0, end - start, metric=metric,
                              chunk=trace_chunk)
        path[:, 1] += start
        results.append(AlignResult(distance=d[i], start=start, end=end,
                                   path=path))
    return results[0] if single else results


def _as_row_scan(out):
    """The kernel's ``(dists, ends)`` or ``(dists, starts, ends)`` with the
    row scan's end and start for a query whose last row never drops below
    BIG (every column banned): column 0, the row scan's argmin over an
    all-BIG row, where the kernel keeps -1. Under ``impl='auto'`` the
    kernel takes exclusion ranges where the reference's rule 3 passes
    them on to rules 4-6; where those pick the row scan, the kernel
    answers as the row scan does (the chunked and wavefront routes keep
    -1, as the kernel does). No host sync."""
    return (out[0],) + tuple(x.clamp_min(0) for x in out[1:])


def _pallas_streamed(queries, reference, qlens, metric, chunk, block_q,
                     block_m, return_positions, return_spans=False,
                     tune: str = "off"):
    """The ``impl='pallas'`` + ``chunk=`` dispatcher: one launch for
    references up to ``PALLAS_FUSED_MAX`` samples (``chunk`` advisory,
    the launch tuned as ``tune`` says), the device-side slice loop
    beyond."""
    from repro_torch.kernels.sdtw import sdtw_cuda
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if reference.shape[0] <= PALLAS_FUSED_MAX:
        return sdtw_cuda(queries, reference, qlens, metric, block_q=block_q,
                         block_m=block_m, return_positions=return_positions,
                         return_spans=return_spans, device=queries.device,
                         tune=tune)
    return _pallas_scan_streamed(queries, reference, qlens, metric,
                                 chunk=chunk, block_q=block_q,
                                 block_m=block_m,
                                 return_positions=return_positions,
                                 return_spans=return_spans)


def _unpack_kernel_carry(carry, return_positions, return_spans):
    if return_spans:
        _, _, best, pos, start = carry
        return best, start, pos
    _, best, pos = carry
    return (best, pos) if return_positions else best


def _pallas_scan_streamed(queries, reference, qlens, metric, *, chunk,
                          block_q, block_m, return_positions, return_spans):
    """Device-side slice loop: the reference, right-padded to a multiple
    of ``chunk`` on its device, is fed slice by slice through the
    kernel's carry, which never leaves the device; the tail slice is
    masked via ``ref_len``. The start lane joins the carry only when
    spans are requested."""
    from repro_torch.kernels.sdtw import kernel_carry_init, sdtw_cuda
    b, n = queries.shape
    m = reference.shape[0]
    n_slices = -(-m // chunk)
    r_pad = torch.nn.functional.pad(reference, (0, n_slices * chunk - m))
    acc = accum_dtype(result_dtype(queries, reference))
    carry = kernel_carry_init(b, n, acc, track_start=return_spans,
                              device=queries.device)
    for t in range(n_slices):
        off = t * chunk
        _, carry = sdtw_cuda(queries, r_pad[off:off + chunk], qlens, metric,
                             block_q=block_q, block_m=block_m, carry=carry,
                             ref_offset=off, ref_len=min(chunk, m - off),
                             return_carry=True, track_start=return_spans,
                             device=queries.device)
    return _unpack_kernel_carry(carry, return_positions, return_spans)


def _pallas_host_loop(queries, reference, qlens, metric, chunk, block_q=None,
                      block_m=None, return_positions=False,
                      return_spans=False):
    """One kernel call per slice of a reference that may stay on the host:
    each slice is cut, right-padded to ``chunk`` (masked via ``ref_len``)
    and moved to the queries' device. Not dispatched automatically; the
    semantic reference the device-side paths are tested against."""
    from repro_torch.kernels.sdtw import kernel_carry_init, sdtw_cuda
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    b, n = queries.shape
    m = reference.shape[0]
    dev = queries.device
    acc = accum_dtype(result_dtype(queries, reference))
    carry = kernel_carry_init(b, n, acc, track_start=return_spans,
                              device=dev)
    for off in range(0, m, chunk):
        sl = reference[off:off + chunk]
        cl = sl.shape[0]
        sl = torch.nn.functional.pad(sl, (0, chunk - cl)).to(dev)
        _, carry = sdtw_cuda(queries, sl, qlens, metric, block_q=block_q,
                             block_m=block_m, carry=carry, ref_offset=off,
                             ref_len=cl, return_carry=True,
                             track_start=return_spans, device=dev)
    return _unpack_kernel_carry(carry, return_positions, return_spans)


def bucketize(lengths: Sequence[int]):
    """Group query indices by padded power-of-two bucket length:
    ``{bucket_len: [query indices]}``, deterministically ordered."""
    buckets: dict[int, list[int]] = {}
    for i, L in enumerate(lengths):
        if L < 1:
            raise ValueError(f"query {i} is empty")
        buckets.setdefault(_bucket_len(L), []).append(i)
    return dict(sorted(buckets.items()))


def pad_ragged_bucket(qs, idxs, blen: int):
    """Zero-pad the selected numpy queries to (len(idxs), blen) in their
    promoted dtype. Returns numpy ``(padded, qlens)``."""
    dtype = np.result_type(*[qs[i].dtype for i in idxs])
    padded = np.zeros((len(idxs), blen), dtype)
    qlens = np.empty((len(idxs),), np.int32)
    for k, i in enumerate(idxs):
        padded[k, :len(qs[i])] = qs[i]
        qlens[k] = len(qs[i])
    return padded, qlens


def _sdtw_ragged(req: SdtwRequest, dev: torch.device):
    """Bucketed dispatch for mixed-length query sets. As in the reference,
    each bucket passes per-query exclusion arrays (``-1`` when none were
    given): the reference's ``impl='auto'`` then never picks its kernel,
    where here the card takes the kernel, which launches without a ban
    for ranges that are empty for every query. The buckets' results are
    put back in caller order by one gather per output."""
    qs = [q.cpu().numpy() if isinstance(q, torch.Tensor) else np.asarray(q)
          for q in req.queries]
    nq = len(qs)
    n_out = (3 if req.return_spans
             else 2 if (req.top_k is not None or req.return_positions)
             else 1)
    if nq == 0:
        shape = (0,) if req.top_k is None else (0, req.top_k)
        empty = tuple(torch.zeros(shape, dtype=torch.int32, device=dev)
                      for _ in range(n_out))
        return empty if n_out > 1 else empty[0]
    lo = _normalize_excl(req.excl_lo, nq, "cpu").numpy()
    hi = _normalize_excl(req.excl_hi, nq, "cpu").numpy()
    outs = [[] for _ in range(n_out)]
    order = []
    for blen, idxs in bucketize([len(q) for q in qs]).items():
        padded, qlens = pad_ragged_bucket(qs, idxs, blen)
        res = sdtw(torch.from_numpy(padded), req.reference,
                   torch.from_numpy(qlens), metric=req.metric, impl=req.impl,
                   chunk=req.chunk, excl_lo=torch.from_numpy(lo[idxs]),
                   excl_hi=torch.from_numpy(hi[idxs]), mesh=req.mesh,
                   ref_axis=req.ref_axis, n_micro=req.n_micro,
                   top_k=req.top_k,
                   return_positions=req.return_positions,
                   return_spans=req.return_spans, excl_zone=req.excl_zone,
                   excl_mode=req.excl_mode, block_q=req.block_q,
                   block_m=req.block_m, tune=req.tune, device=dev)
        res = res if isinstance(res, tuple) else (res,)
        for t in range(n_out):
            outs[t].append(res[t])
        order.extend(idxs)
    inverse = torch.empty(nq, dtype=torch.long)
    inverse[torch.as_tensor(order)] = torch.arange(nq)
    inverse = inverse.to(dev)
    stacked = tuple(torch.cat(o)[inverse] for o in outs)
    return stacked if n_out > 1 else stacked[0]
