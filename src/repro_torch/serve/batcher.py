"""Microbatch coalescing: many client requests → few engine dispatches.

Counterpart of ``repro.serve.batcher``. A drained window of admitted
requests is grouped by ``SdtwRequest.coalesce_key()`` (everything that
selects a launch or changes per-query semantics, the device included)
plus the reference identity and the query dtype. Each group becomes ONE
merged ragged engine call: every client's queries are trimmed to true
length and concatenated into one ragged list, so the engine's
power-of-two bucketing yields one dispatch per bucket per window.

Where the data lives:

  * queries are flattened on the host: numpy inputs as they are, CPU
    tensors as views, and a request's CUDA tensor copied to the host
    once — where the merge and the content dedup run (the engine's
    ragged path pads the merged buckets on the host anyway);
  * the reference is never copied or hashed: it is keyed by the caller's
    ``ref_key`` when given, else by object identity, with its shape,
    dtype and device folded in.

Within a group, **identical** requests deduplicate on ``(reference key,
query content, coalesce key)``: N concurrent clients asking the same
question cost one engine call and share one result object.

Correctness contract (pinned by ``tests/test_torch_serve.py``):

  * ``op='sdtw'`` — the DP is per-query independent and padded columns
    are masked by ``qlens``, so the merged call is **bitwise** identical
    (int32) to each client calling ``engine.sdtw`` alone.
  * ``op='search_topk'`` — the LB-cascade thresholds are batch-shared,
    so the merged call is bitwise identical to one offline *batched*
    ``search_topk`` over the same queries.

A group of one request dispatches the request unchanged. Delivery is
cancellation-safe: a client that cancelled its future is skipped (and
counted) without disturbing the other members.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core.request import SdtwRequest
from repro_torch.device import resolve_device, to_numpy

from .telemetry import RequestTrace


@dataclasses.dataclass
class Pending:
    """One admitted request waiting for dispatch."""
    request: SdtwRequest
    future: object               # concurrent.futures.Future
    trace: RequestTrace
    single: bool = False         # client passed one 1-D query
    entries: list = None         # true-length 1-D host query arrays
    dupes: list = None           # identical requests sharing this
                                 # member's engine call and result


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def ref_fingerprint(req: SdtwRequest):
    """Reference identity for grouping: the user's stable ``ref_key``
    when given (equal keys mean equal content, as for the envelope
    cache), else object identity; shape, dtype and device folded in so a
    stale key can never merge mismatched references. Reads no data."""
    ref = req.reference
    if not isinstance(ref, torch.Tensor):
        ref = np.asarray(ref)
    base = req.ref_key if req.ref_key is not None else ("id",
                                                        id(req.reference))
    where = ref.device.type if isinstance(ref, torch.Tensor) else "host"
    return (base, tuple(ref.shape), _dtype_name(ref), where)


def _host(x) -> np.ndarray:
    """A query array on the host: numpy as is, a tensor as a view (CPU)
    or one copy (CUDA)."""
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def query_entries(req: SdtwRequest):
    """Flatten a request's queries into true-length 1-D host arrays.

    Returns ``(entries, single)`` — padded 2-D input is trimmed per
    ``qlens`` (the engine masks padded columns by qlens, so repacking is
    bitwise-invariant)."""
    q = req.queries
    if isinstance(q, (list, tuple)):
        return [_host(x) for x in q], False
    arr = _host(q)
    if arr.ndim == 1:
        return [arr], True
    if req.qlens is not None:
        lens = _host(req.qlens).astype(int)
        return [arr[i, :lens[i]] for i in range(arr.shape[0])], False
    return list(arr), False


def query_fingerprint(p: Pending):
    """Content hash of a request's trimmed queries — the in-window dedup
    key component. ``single`` is folded in because a 1-D client's slice
    unwraps to a scalar shape."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"1" if p.single else b"0")
    for e in p.entries:
        arr = np.ascontiguousarray(e)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.digest()


def group_key(req: SdtwRequest, entries=None):
    """Full coalescing key: semantic key × reference × query dtype (the
    accumulator dtype depends on both operand dtypes). Per-query
    exclusion *arrays* are sized to one request's batch — such requests
    never coalesce (unique key), even when two clients share the array
    object."""
    if entries is None:
        entries, _ = query_entries(req)
    qdtype = (str(np.result_type(*{e.dtype for e in entries}))
              if entries else "none")
    per_query = tuple(np.ndim(v) != 0 for v in
                      (req.excl_zone, req.excl_lo, req.excl_hi)
                      if v is not None)
    solo = (id(req),) if any(per_query) else ()
    return req.coalesce_key(ref_id=ref_fingerprint(req)) + (qdtype,) + solo


def group_window(pending: list, *, dedup: bool = True) -> list:
    """Partition a drained window into coalescable groups (stable order).
    With ``dedup`` (the default), identical requests within a group
    collapse onto the first-submitted member's ``dupes`` list."""
    groups: dict = {}
    for p in pending:
        p.entries, p.single = query_entries(p.request)
        p.dupes = []
        groups.setdefault(group_key(p.request, p.entries), []).append(p)
    if not dedup:
        return list(groups.values())
    out = []
    for members in groups.values():
        primaries: dict = {}
        kept = []
        for p in members:
            fp = query_fingerprint(p)
            prim = primaries.get(fp)
            if prim is None:
                primaries[fp] = p
                kept.append(p)
            else:
                prim.dupes.append(p)
        out.append(kept)
    return out


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def group_shape(group: list):
    """The launch shape a merged group exercises: the pow-2 bucket its
    ragged batch lands in, the op and the reference's shape and dtype.
    The ``DevicePool`` keys device affinity on it (a card that ran the
    shape has built its kernels and holds its tuning decision); an
    imprecise match costs time, never correctness."""
    p0 = group[0]
    for p in group:
        if p.entries is None:
            p.entries, p.single = query_entries(p.request)
    total = sum(len(p.entries) for p in group)
    qmax = max((e.shape[-1] for p in group for e in p.entries), default=0)
    ref = p0.request.reference
    if not isinstance(ref, torch.Tensor):
        ref = np.asarray(ref)
    return (p0.request.op, _pow2(total), _pow2(qmax), tuple(ref.shape),
            _dtype_name(ref))


def group_members(group: list):
    """Every client request answered by this group's engine call — the
    surviving members plus their deduplicated twins."""
    for p in group:
        yield p
        yield from (p.dupes or ())


def _slice_result(res, i0: int, i1: int, single: bool):
    """Cut one client's rows out of a merged result (tensor, tuple of
    tensors, or SearchResult — every payload's leading axis is nq)."""
    if isinstance(res, tuple):
        return tuple(_slice_result(r, i0, i1, single) for r in res)
    if hasattr(res, "distances"):        # SearchResult: slice the payload,
        return dataclasses.replace(      # share the batch-level telemetry
            res,
            distances=_slice_result(res.distances, i0, i1, single),
            positions=_slice_result(res.positions, i0, i1, single),
            starts=_slice_result(res.starts, i0, i1, single))
    if res is None:
        return None
    out = res[i0:i1]
    return out[0] if single else out


def _deliver_one(p: Pending, result, exc, telemetry):
    """Resolve one member future, tolerating client cancellation and
    already-resolved futures."""
    fut = p.future
    if fut.cancelled():
        if telemetry is not None:
            telemetry.record_cancelled(p.trace)
        return
    if fut.done():
        return                          # answered elsewhere (close race)
    if not fut.set_running_or_notify_cancel():
        if telemetry is not None:       # cancelled between the checks
            telemetry.record_cancelled(p.trace)
        return
    p.trace.mark_complete(error=exc is not None)
    if telemetry is not None:
        telemetry.record_complete(p.trace)
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)


def fail_group(group: list, exc, telemetry=None):
    """Answer every not-yet-resolved member future with ``exc``."""
    for p in group_members(group):
        _deliver_one(p, None, exc, telemetry)


def wait_for_card(req: SdtwRequest):
    """Wait for the current CUDA stream when ``req`` runs on the card, so
    that its results are complete when handed over."""
    if resolve_device(req.device).type == "cuda":
        torch.cuda.current_stream().synchronize()


def execute_group(group: list, telemetry=None):
    """Run one coalesced group and deliver every client future.

    Never raises: an execution error is propagated into every member
    future (admitted requests are always answered). Deduplicated twins
    receive the *same* result object as their surviving member. Each
    trace is completed and recorded *before* its future resolves. A group
    on the card waits for its stream before it delivers, so a client
    reads a finished result from any thread or stream."""
    n_queries = sum(len(p.entries) for p in group)
    n_members = sum(1 for _ in group_members(group))
    for p in group_members(group):
        p.trace.mark_dispatch(batch_requests=n_members,
                              batch_queries=n_queries)

    def deliver(p, result=None, exc=None):
        for member in (p, *(p.dupes or ())):
            _deliver_one(member, result, exc, telemetry)

    try:
        base = group[0].request
        if len(group) == 1:
            res = base.run()
            wait_for_card(base)
            deliver(group[0], res)
            return
        merged = [e for p in group for e in p.entries]
        res = dataclasses.replace(base, queries=merged, qlens=None).run()
        wait_for_card(base)
        i0 = 0
        for p in group:
            i1 = i0 + len(p.entries)
            deliver(p, _slice_result(res, i0, i1, p.single))
            i0 = i1
    except Exception as exc:                           # noqa: BLE001
        fail_group(group, exc, telemetry=telemetry)
