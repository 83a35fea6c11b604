"""Online sDTW monitoring over the chunk-carry protocol.

Counterpart of ``repro.stream.session``. A ``StreamSession`` holds a batch
of (possibly ragged) queries and their DP carries on a device, and
``session.feed(chunk)`` advances every query by that chunk through the
same chunk functions the offline engine runs: the row-scan tile loop
(``impl='rowscan'``) or the repo's hand-written sDTW kernel
(``impl='pallas'``: the CUDA kernel for a session on the card, its plain
version on the CPU). Any partition of the reference fed through a session
reproduces ``engine.sdtw`` distances, spans and top-K bitwise (int32).
On the kernel, top-K heaps, threshold alerts and online pruning all
consume the kernel's last-row capture (the per-tile candidate row),
folded with the ``topk_fold_lastrow`` merge the row-scan path uses, so
both impls produce the same bits. Per-query exclusion ranges ride the
kernel as its column ban when ``impl='auto'`` picks it on the card; an
explicit ``impl='pallas'`` with exclusion ranges raises, as in the
reference.

Mechanics, as in the reference:

  * **One shape per tile.** Fed chunks are buffered on the host and the
    DP advances in fixed ``chunk``-sized tiles; a partial tile is
    right-padded and masked, its boundary column taken at the true last
    column (the row scan's ``clen``, the kernel's ``ref_len``), so a
    flushed session can keep streaming.
  * **Online pruning** (``prune=True``): each tile's [min, max] envelope
    extends the shared ``EnvelopeCache`` under ``((ref_key, False),
    chunk)`` and feeds the LB_Kim/LB_Keogh cascade against the heap
    thresholds; a tile no query can improve on is skipped, a surviving
    one is scored from a fresh carry warmed by a ``halo`` of buffered
    tiles (the ``span_cap`` caveat of ``repro_torch.search``).
  * **Threshold alerts**: any query whose candidate row drops to
    ``<= alert_threshold`` inside a tile fires an ``AlertEvent``. The
    test runs on the device; only the per-query (count, column, value,
    start) of a tile with a hit reaches the host.
  * **Fault tolerance**: ``snapshot()`` returns a flat dict of numpy
    arrays in the reference's format (``_SNAP_VERSION``, the same keys
    and leaves; the kernel carry in the reference's layout), so a session
    snapshotted by either package restores into the other and continues
    bit for bit.

``results()`` applies the buffered tail to a copy of the carry (polling
never perturbs tile alignment) and returns numpy arrays, as the
reference does. ``flush()`` pushes the tail through destructively; in
pruned mode it is terminal. A mid-stream ``flush()`` on a k > 1 session
shifts every later tile boundary, so the next ``feed()`` warns (top-1
stays exact). ``ShardedStreamSession`` (``stream.sharded``) is the
multi-rank sibling.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import engine as engine_mod
from repro_torch.core.distances import INT_FAR, big
from repro_torch.core.request import StreamRequest
from repro_torch.core.sdtw import (default_excl_zone, sdtw_carry_init,
                                   sdtw_chunk_batch, sdtw_chunk_batch_topk,
                                   topk_fold_lastrow)
from repro_torch.core.topk import topk_init
from repro_torch.device import resolve_device, to_numpy
from repro_torch.search import cache as cache_mod
from repro_torch.search.lower_bounds import chunk_envelope, lb_cascade
from repro_torch.search import search as search_mod
from repro_torch.search.search import DEFAULT_SPAN_FACTOR, _pruned_chunk_step

#: Default DP tile size — the engine's streaming default.
DEFAULT_STREAM_CHUNK = engine_mod.DEFAULT_CHUNK

_SNAP_VERSION = 1


@dataclasses.dataclass(frozen=True)
class AlertEvent:
    """One threshold crossing: query ``query`` matched the stream at cost
    ``distance`` ending at global sample ``end`` (span start ``start``;
    -1 when the session does not track starts). ``hits`` counts every
    sub-threshold end column inside the triggering tile
    ``[tile_start, tile_end)``; the reported (distance, end) is the best
    (leftmost on ties)."""
    query: int
    distance: float
    start: int
    end: int
    tile_start: int
    tile_end: int
    hits: int


@dataclasses.dataclass
class StreamResult:
    """Streamed match state after ``samples`` reference samples (numpy).

    ``distances`` is (nq,) — or (nq, k) in top-K mode, best first,
    BIG/-1-padded. ``positions``/``starts`` are present when the session
    tracks ends/spans. Tile counters are per *tile* across the whole
    batch: ``tiles_pruned + tiles_processed == tiles_total``."""
    distances: object
    positions: object = None
    starts: object = None
    samples: int = 0
    tiles_total: int = 0
    tiles_pruned_kim: int = 0
    tiles_pruned_keogh: int = 0
    tiles_processed: int = 0

    @property
    def tiles_pruned(self) -> int:
        return self.tiles_pruned_kim + self.tiles_pruned_keogh

    @property
    def spans(self):
        """Stacked (start, end) spans, shape (..., 2)."""
        if self.starts is None or self.positions is None:
            raise ValueError("this session does not track spans — open it "
                             "with return_spans=True (or top_k=/prune=)")
        return np.stack([np.asarray(self.starts), np.asarray(self.positions)],
                        axis=-1)


@dataclasses.dataclass
class _Bucket:
    """One padded query bucket and its carry through the stream (tensors
    on the session's device)."""
    idxs: List[int]
    queries: torch.Tensor       # (nb, blen)
    qlens: torch.Tensor         # (nb,)
    lo: torch.Tensor            # (nb,) banned-range lower bounds
    hi: torch.Tensor
    zone: torch.Tensor          # (nb,) top-K suppression radii
    carry: tuple                # chunk carry (+ heap in match mode)
    halo: int = 0               # pruned mode: left-context tiles
    thr: Optional[np.ndarray] = None  # pruned mode: per-query k-th best
    # ``kernel_bans(lo, hi)``: the ranges the kernel takes, or None when
    # every range is empty (its launches then run without a ban).
    ban: Optional[tuple] = None


def _pallas_step(queries, tile, qlens, kcarry, heap, j0, clen, zone, *,
                 metric, block_q, block_m, k, excl_span, track, want_lastrow,
                 with_heap, excl_lo=None, excl_hi=None, fold=None,
                 tune="off"):
    """One streamed tile through the sDTW kernel: advance the kernel chunk
    carry and — when the session consumes candidate rows — fold the
    last-row capture into the top-K heap with the per-tile
    ``topk_merge`` the rowscan path runs. ``excl_lo``/``excl_hi`` are the
    kernel's per-query ban (global columns, on the device), or ``None``.
    ``block_m`` is the wavefront kernel's staged tile; a rows- or
    chain-kernel launch stages none, so it is passed to wavefront launches
    only. ``fold`` folds the first ``clen`` columns of the last row
    ``fold`` at a time, in order (a sharded rank's segment of several
    chunks merges as the reference's chunk loop does); ``None`` folds the
    tile at once. ``tune`` is the launch's (``ops.tuned_launch``)."""
    from repro_torch.kernels.sdtw import choose_kernel, sdtw_cuda
    if choose_kernel(queries.shape[1]) != "wavefront":
        block_m = None
    out = sdtw_cuda(queries, tile, qlens, metric, block_q=block_q,
                    block_m=block_m, carry=kcarry, return_carry=True,
                    ref_offset=j0, ref_len=clen, track_start=track,
                    return_lastrow=want_lastrow, device=queries.device,
                    excl_lo=excl_lo, excl_hi=excl_hi, tune=tune)
    if not want_lastrow:
        _, kc = out
        return kc, None, None
    if track:
        _, kc, lrow, lstart = out
    else:
        _, kc, lrow = out
        lstart = None
    if with_heap:
        width = lrow.shape[1] if fold is None else fold
        for c0 in range(0, lrow.shape[1] if fold is None else clen, width):
            heap = topk_fold_lastrow(
                heap, lrow[:, c0:c0 + width],
                None if lstart is None else lstart[:, c0:c0 + width],
                j0 + c0, k, zone, excl_span)
        return kc + tuple(heap), lrow, lstart
    return kc, lrow, lstart


def _heap_step(queries, tile, qlens, carry, j0, m_total, clen, lo, hi, zone,
               *, metric, k, excl_span, track, lastrow):
    out = sdtw_chunk_batch_topk(queries, tile, qlens, carry, j0, m_total,
                                metric, lo, hi, k, zone, excl_span, track,
                                clen=clen, return_lastrow=lastrow)
    if not lastrow:
        return out, None, None
    if track:
        return out[:6], out[6], out[7]
    return out[:5], out[5], None


class StreamSession:
    """Online sDTW monitor: a query batch streamed against an unbounded
    reference, one ``feed()`` at a time. See the module docstring;
    ``engine.stream()`` is the front door. ``device=None`` is the CUDA
    device; ``impl='auto'`` is the kernel there and the row scan
    elsewhere."""

    def __init__(self, queries, *, qlens=None, metric: str = "abs_diff",
                 chunk: Optional[int] = None, impl: str = "rowscan",
                 top_k: Optional[int] = None, excl_zone=None,
                 excl_mode: str = "end", return_spans: bool = False,
                 return_positions: bool = False,
                 excl_lo=None, excl_hi=None,
                 prune: bool = False, span_cap: Optional[int] = None,
                 alert_threshold=None,
                 on_alert: Optional[Callable[[AlertEvent], None]] = None,
                 cache: Optional[cache_mod.EnvelopeCache] = None,
                 ref_key=None, block_q: Optional[int] = None,
                 block_m: Optional[int] = None, device=None):
        if impl not in ("auto", "rowscan", "pallas"):
            raise ValueError(f"impl must be 'auto', 'rowscan' or 'pallas' "
                             f"for a stream session, got {impl!r}")
        StreamRequest(
            queries=queries, qlens=qlens, metric=metric, impl=impl,
            chunk=chunk, top_k=top_k, excl_zone=excl_zone,
            excl_mode=excl_mode, return_spans=return_spans,
            return_positions=return_positions, excl_lo=excl_lo,
            excl_hi=excl_hi, prune=prune, span_cap=span_cap,
            alert_threshold=alert_threshold, on_alert=on_alert,
            cache=cache, ref_key=ref_key, block_q=block_q,
            block_m=block_m).validate_session()

        self.device = resolve_device(device)
        self.metric = metric
        self._auto = impl == "auto"
        self.impl = search_mod._auto_engine(self.device) if self._auto \
            else impl
        self.chunk = int(DEFAULT_STREAM_CHUNK if chunk is None else chunk)
        self.top_k = top_k
        self.excl_mode = excl_mode
        self.return_spans = bool(return_spans)
        self.return_positions = bool(return_positions)
        self.prune = bool(prune)
        self.alert_threshold = (None if alert_threshold is None
                                else float(alert_threshold))
        self.on_alert = on_alert
        self.ref_key = ref_key
        self.cache = cache_mod.DEFAULT_CACHE if cache is None else cache
        self.block_q = block_q
        self.block_m = block_m
        self.alerts: List[AlertEvent] = []

        self._derive_modes()
        self._dtype = None           # pinned by the first feed

        # --- bucket the query batch (ragged lists via the engine rules) --
        self._ragged = isinstance(queries, (list, tuple))
        if self._ragged:
            if qlens is not None:
                raise ValueError("qlens is implied by ragged (list) queries")
            qs = [to_numpy(q) for q in queries]
            if not qs:
                raise ValueError("need at least one query")
            self._nq = len(qs)
            self._single = False
            bucket_arrays = []
            for blen, idxs in engine_mod.bucketize(
                    [len(q) for q in qs]).items():
                padded, lens = engine_mod.pad_ragged_bucket(qs, idxs, blen)
                bucket_arrays.append((idxs, padded, lens))
        else:
            q2 = to_numpy(queries)
            self._single = q2.ndim == 1
            if self._single:
                q2 = q2[None, :]
            self._nq = q2.shape[0]
            lens = (np.full((self._nq,), q2.shape[1], np.int32)
                    if qlens is None else to_numpy(qlens).astype(np.int32))
            bucket_arrays = [(list(range(self._nq)), q2, lens)]

        lo_all = engine_mod._normalize_excl(excl_lo, self._nq, "cpu").numpy()
        hi_all = engine_mod._normalize_excl(excl_hi, self._nq, "cpu").numpy()
        zone_all = (None if excl_zone is None else np.broadcast_to(
            to_numpy(excl_zone).astype(np.int32), (self._nq,)))

        self._buckets: List[_Bucket] = []
        span_caps = []
        for idxs, padded, lens in bucket_arrays:
            n = padded.shape[1]
            sel = np.asarray(idxs)
            if zone_all is None:
                zone = (default_excl_zone(lens).numpy()
                        if excl_mode == "end"
                        else np.zeros((len(idxs),), np.int32))
            else:
                zone = zone_all[sel]
            cap = (DEFAULT_SPAN_FACTOR * n if span_cap is None
                   else int(span_cap))
            span_caps.append(cap)
            halo = max(1, -(-cap // self.chunk)) if self.prune else 0
            b = self._bucket(idxs, padded, lens, lo_all[sel], hi_all[sel],
                             zone, halo)
            b.carry = self._fresh_carry(b)
            if self.prune:
                b.thr = np.full((len(idxs),), np.inf)
            self._buckets.append(b)
        self.span_cap = max(span_caps)
        self._max_halo = max(b.halo for b in self._buckets)

        # --- stream state ------------------------------------------------
        self._buf = np.zeros((0,), np.int32)
        self._offset = 0             # samples advanced through the DP
        self._finalized = False
        self._flush_shift_pending = False   # mid-stream flush happened
        self._ring: List[np.ndarray] = []   # pruned mode: last halo tiles
        self._env_tail: List[tuple] = []    # pruned mode: trailing envelopes
        # The full streamed envelope (one entry per tile), what
        # cache.extend() has received; snapshotted so a restore into a
        # fresh cache can install the whole prefix.
        self._env_mins: List[np.ndarray] = []
        self._env_maxs: List[np.ndarray] = []
        self.tiles_total = 0
        self.tiles_pruned_kim = 0
        self.tiles_pruned_keogh = 0
        self.tiles_processed = 0

    def _bucket(self, idxs, queries, qlens, lo, hi, zone, halo, carry=None,
                thr=None) -> _Bucket:
        from repro_torch.kernels.sdtw.ops import kernel_bans

        def dev(x, dtype=None):
            return torch.from_numpy(np.array(x)).to(self.device, dtype)
        lo, hi = dev(lo, torch.int32), dev(hi, torch.int32)
        return _Bucket(idxs=list(idxs), queries=dev(queries),
                       qlens=dev(qlens, torch.int32), lo=lo, hi=hi,
                       zone=dev(zone, torch.int32), carry=carry, halo=halo,
                       thr=thr, ban=kernel_bans(lo, hi, len(idxs),
                                                self.device,
                                                test_device=True))

    # ------------------------------------------------------------------
    # carry plumbing
    # ------------------------------------------------------------------

    def _derive_modes(self):
        """The mode lattice, derived in one place so ``restore()`` unpacks
        carries under the layout of the session that snapshotted them: a
        heap rides the carry as soon as any positional output (or an
        alert feed) is consumed; the start lane only when spans or span
        suppression need it. The kernel tracks the top-1 (value, end,
        start) in its own carry, so a kernel session appends the heap
        only for a real top-K and asks for the last-row capture exactly
        when a candidate row is consumed (top-K folding or alerts)."""
        self._k = 1 if self.top_k is None else self.top_k
        self._wants_heap = self._heap_on(self.impl)
        self._want_lastrow = (self.alert_threshold is not None
                              or (self.impl == "pallas"
                                  and self.top_k is not None))
        self._track = self.return_spans or self.excl_mode == "span"

    def _heap_on(self, impl: str) -> bool:
        """Whether ``impl``'s exact-mode carry ends in the top-K heap."""
        if impl == "pallas":
            return self.top_k is not None
        return (self.top_k is not None or self.return_spans
                or self.return_positions or self.alert_threshold is not None)

    def _acc(self, b: _Bucket):
        qdt = np.dtype(str(b.queries.dtype).replace("torch.", ""))
        rdt = self._dtype if self._dtype is not None else qdt
        return (torch.float32 if np.issubdtype(np.result_type(qdt, rdt),
                                               np.floating)
                else torch.int32)

    def _fresh_carry(self, b: _Bucket, impl: Optional[str] = None):
        nb, n = b.queries.shape
        acc = self._acc(b)
        dev = self.device
        impl = self.impl if impl is None else impl
        if self.prune:
            # Pruned mode scores surviving tiles from fresh halo-warmed
            # carries (on either impl) — the session carry is the heap.
            return topk_init(nb, self._k, acc, device=dev)
        if impl == "pallas":
            if self._dtype is None:
                return None          # accumulator unknown until first feed
            from repro_torch.kernels.sdtw import kernel_carry_init
            kc = kernel_carry_init(nb, n, acc, track_start=self._track,
                                   device=dev)
            if self._heap_on(impl):
                return kc + topk_init(nb, self._k, acc, device=dev)
            return kc
        if self._heap_on(impl):
            return (sdtw_carry_init(nb, n, acc, track_start=self._track,
                                    device=dev)
                    + topk_init(nb, self._k, acc, device=dev))
        return sdtw_carry_init(nb, n, acc, device=dev)

    # ------------------------------------------------------------------
    # feeding
    # ------------------------------------------------------------------

    @property
    def samples_seen(self) -> int:
        """Reference samples fed so far (including the buffered tail)."""
        return self._offset + int(self._buf.shape[0])

    def feed(self, data) -> "StreamSession":
        """Append reference samples (numpy or a tensor); advance the DP by
        every whole tile."""
        if self._finalized:
            raise RuntimeError("session is finalized (a pruned-mode flush "
                               "is terminal); snapshot/restore to branch "
                               "earlier")
        data = to_numpy(data)
        if data.ndim != 1:
            raise ValueError(f"feed() takes a 1-D chunk, got shape "
                             f"{data.shape}")
        if data.shape[0] == 0:
            return self
        if self._flush_shift_pending:
            self._flush_shift_pending = False
            if self.top_k is not None and self._k > 1:
                warnings.warn(
                    "feeding a k>1 session after a mid-stream flush(): the "
                    "partial tile shifted every later merge boundary, so "
                    "heap entries beyond top-1 may differ from an "
                    "aligned-boundary (offline or unflushed) run — the "
                    "top-1 distance/span stays exact. Poll results() "
                    "instead of flush() to read the tail without moving "
                    "boundaries.", RuntimeWarning, stacklevel=2)
        if self._dtype is None:
            self._dtype = data.dtype
            self._buf = np.zeros((0,), data.dtype)
            if self._offset == 0:
                # The carry's accumulator dtype depends on the stream's —
                # rebuild the untouched fresh carries now that it is known.
                for b in self._buckets:
                    b.carry = self._fresh_carry(b)
        elif data.dtype != self._dtype:
            raise ValueError(f"stream dtype changed mid-flight: "
                             f"{self._dtype} -> {data.dtype}")
        self._buf = np.concatenate([self._buf, data])
        while self._buf.shape[0] >= self.chunk:
            tile, self._buf = (self._buf[:self.chunk],
                               self._buf[self.chunk:])
            self._advance(tile, self.chunk)
        return self

    def flush(self) -> "StreamSession":
        """Destructively push the buffered tail through the DP. Exact mode
        keeps streaming afterwards; pruned mode finalizes the session."""
        if self._buf.shape[0]:
            tail, self._buf = self._buf, self._buf[:0]
            self._advance(self._padded(tail), int(tail.shape[0]))
            if self.prune:
                self._finalized = True
            elif tail.shape[0] % self.chunk:
                self._flush_shift_pending = True
        return self

    def _padded(self, tail):
        padded = np.zeros((self.chunk,), tail.dtype)
        padded[:tail.shape[0]] = tail
        return padded

    def _advance(self, tile_np: np.ndarray, clen: int):
        """Advance every bucket by one (possibly right-padded) tile."""
        j0 = self._offset
        if self.prune:
            self._advance_pruned(tile_np, clen, j0)
        else:
            tile = torch.from_numpy(tile_np).to(self.device)
            for b in self._buckets:
                b.carry, lrow, lstart = self._step_exact(b, tile, j0, clen,
                                                         b.carry)
                if self.alert_threshold is not None:
                    self._emit_alerts(b, lrow, lstart, j0, clen)
            self.tiles_processed += 1      # exact mode runs every tile
        self.tiles_total += 1
        self._offset += clen

    def _step_exact(self, b: _Bucket, tile, j0: int, clen: int, carry):
        """One exact-mode tile for one bucket — pure in ``carry``."""
        if self.impl == "pallas":
            kc = carry[:-3] if self._wants_heap else carry
            heap = carry[-3:] if self._wants_heap else None
            lo, hi = b.ban or (None, None)
            return _pallas_step(
                b.queries, tile, b.qlens, kc, heap, j0, clen, b.zone,
                metric=self.metric, block_q=self.block_q,
                block_m=self.block_m, k=self._k,
                excl_span=self.excl_mode == "span", track=self._track,
                want_lastrow=self._want_lastrow, with_heap=self._wants_heap,
                excl_lo=lo, excl_hi=hi)
        if self._wants_heap:
            return _heap_step(b.queries, tile, b.qlens, carry, j0, j0 + clen,
                              clen, b.lo, b.hi, b.zone, metric=self.metric,
                              k=self._k, excl_span=self.excl_mode == "span",
                              track=self._track, lastrow=self._want_lastrow)
        return (sdtw_chunk_batch(b.queries, tile, b.qlens, carry, j0,
                                 j0 + clen, self.metric, b.lo, b.hi,
                                 clen=clen), None, None)

    def _emit_alerts(self, b: _Bucket, lrow, lstart, j0: int, clen: int):
        lr = lrow[:, :clen]
        # The reference compares numpy rows with a Python float: int32 in
        # float64, float32 in float32.
        hits = (lr if lr.dtype.is_floating_point
                else lr.double()) <= self.alert_threshold
        count = hits.sum(dim=1)
        if not bool(count.any()):
            return
        # Leftmost minimum among the hits: non-hits exceed every hit.
        col = torch.argmin(torch.where(hits, lr, big(lr.dtype)), dim=1)
        dist = torch.gather(lr, 1, col[:, None])[:, 0]
        start = (None if lstart is None
                 else torch.gather(lstart[:, :clen], 1, col[:, None])[:, 0])
        count, col, dist = to_numpy(count), to_numpy(col), to_numpy(dist)
        start = None if start is None else to_numpy(start)
        for row, orig in enumerate(b.idxs):
            if not count[row]:
                continue
            ev = AlertEvent(
                query=orig, distance=dist[row].item(),
                start=int(start[row]) if start is not None else -1,
                end=j0 + int(col[row]), tile_start=j0, tile_end=j0 + clen,
                hits=int(count[row]))
            self.alerts.append(ev)
            if self.on_alert is not None:
                self.on_alert(ev)

    # ------------------------------------------------------------------
    # online pruning (LB cascade against the live heap thresholds)
    # ------------------------------------------------------------------

    def _advance_pruned(self, tile_np: np.ndarray, clen: int, j0: int):
        env_min, env_max = (x.numpy() for x in chunk_envelope(
            torch.from_numpy(tile_np[:clen]), self.chunk))
        if self.ref_key is not None:
            # The full-prefix copy exists only for the cache hand-off (and
            # its snapshot/restore); a keyless session keeps the trailing
            # bound window only, so unbounded streams stay O(halo).
            self._env_mins.append(env_min)
            self._env_maxs.append(env_max)
            self.cache.extend((self.ref_key, False), self.chunk, env_min,
                              env_max, at=self.tiles_total)
        self._env_tail.append((float(env_min[0]), float(env_max[0])))
        self._env_tail = self._env_tail[-(self._max_halo + 1):]
        # Per-tile telemetry: the tile counts as processed if any bucket's
        # DP ran, else it goes to the cheapest bound that discharged
        # every bucket.
        decisions = []
        for b in self._buckets:
            decision, heap = self._step_pruned(b, tile_np, clen, j0,
                                               (b.thr, b.carry))
            decisions.append(decision)
            if decision == "processed":
                b.carry = heap
                b.thr = to_numpy(heap[0][:, -1].double())
        if "processed" in decisions:
            self.tiles_processed += 1
        elif "keogh" in decisions:
            self.tiles_pruned_keogh += 1
        else:
            self.tiles_pruned_kim += 1
        # The halo ring keeps raw context for future surviving tiles.
        self._ring.append(np.asarray(tile_np))
        self._ring = self._ring[-max(1, self._max_halo):]

    def _tile_bounds(self, b: _Bucket, win):
        mins = torch.tensor([w[0] for w in win], dtype=torch.float32)
        maxs = torch.tensor([w[1] for w in win], dtype=torch.float32)
        kim, keogh = lb_cascade(b.queries, b.qlens, mins, maxs, b.halo,
                                self.metric)
        return to_numpy(kim[:, -1]), to_numpy(keogh[:, -1])

    def _step_pruned(self, b: _Bucket, tile_np, clen: int, j0: int, state):
        """Bound-check one tile for one bucket; score it if it survives.
        Pure in ``state = (thr, heap)``. Returns (decision, new_heap) with
        decision in {'kim', 'keogh', 'processed'}."""
        thr, heap = state
        win = self._env_tail[-(b.halo + 1):]
        kim, keogh = self._tile_bounds(b, win)
        if np.all(kim >= thr):
            return "kim", heap
        if np.all(keogh >= thr):
            return "keogh", heap
        group = np.zeros(((b.halo + 1) * self.chunk,), tile_np.dtype)
        ctx = self._ring[-b.halo:] if b.halo else []
        if ctx:
            ctx_flat = np.concatenate(ctx)
            group[b.halo * self.chunk - ctx_flat.shape[0]:
                  b.halo * self.chunk] = ctx_flat
        group[b.halo * self.chunk:] = tile_np
        hd, hp, hs = _pruned_chunk_step(
            b.queries, b.qlens, torch.from_numpy(group).to(self.device),
            heap[0], heap[1], heap[2], j0 - b.halo * self.chunk, j0 + clen,
            *(b.ban or (None, None)), b.zone, metric=self.metric,
            chunk=self.chunk, halo=b.halo, k=self._k,
            excl_span=self.excl_mode == "span", engine_impl=self.impl)
        return "processed", (hd, hp, hs)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def results(self) -> StreamResult:
        """Current match state — non-destructive: the buffered tail is
        applied to a copy of the carry, so the live session's tile
        alignment is untouched and results() can be polled freely."""
        carries = {}
        tail = self._buf
        for bi, b in enumerate(self._buckets):
            carry = b.carry
            if tail.shape[0]:
                padded = self._padded(tail)
                if self.prune:
                    # Peek with copies of (thr, heap); ring/cache untouched.
                    saved_env = list(self._env_tail)
                    mn, mx = chunk_envelope(torch.from_numpy(tail),
                                            self.chunk)
                    self._env_tail = (saved_env + [(float(mn[0]),
                                                    float(mx[0]))]
                                      )[-(self._max_halo + 1):]
                    try:
                        _, carry = self._step_pruned(
                            b, padded, int(tail.shape[0]), self._offset,
                            (b.thr, carry))
                    finally:
                        self._env_tail = saved_env
                else:
                    carry, _, _ = self._step_exact(
                        b, torch.from_numpy(padded).to(self.device),
                        self._offset, int(tail.shape[0]), carry)
            carries[bi] = carry
        return self._assemble(carries)

    def _assemble(self, carries) -> StreamResult:
        kk = self._k
        out_d = [None] * self._nq
        out_p = [None] * self._nq
        out_s = [None] * self._nq
        wants_pos = (self._wants_heap or self.impl == "pallas") and \
            (self.top_k is not None or self.return_positions
             or self.return_spans)
        for bi, b in enumerate(self._buckets):
            carry = carries[bi]
            if self.prune:
                d, p, s = (to_numpy(x) for x in carry)
            elif self.impl == "pallas":
                if carry is None:
                    acc = self._acc(b)
                    nb = b.queries.shape[0]
                    d = np.full((nb, kk), big(acc),
                                np.float32 if acc.is_floating_point
                                else np.int32)
                    p = np.full((nb, kk), -1, np.int32)
                    s = np.full((nb, kk), -1, np.int32)
                elif self._wants_heap:
                    d, p, s = (to_numpy(x) for x in carry[-3:])
                else:
                    if self._track:
                        _, _, d, p, s = (to_numpy(x) for x in carry)
                    else:
                        _, d, p = (to_numpy(x) for x in carry)
                        s = np.full_like(p, -1)
                    d, p, s = d[:, None], p[:, None], s[:, None]  # (nb, 1)
            elif self._wants_heap:
                d, p, s = (to_numpy(x) for x in carry[-3:])
            else:
                d = to_numpy(carry[-1])[:, None]
                p = s = np.full_like(d, -1, dtype=np.int32)
            for row, orig in enumerate(b.idxs):
                out_d[orig] = d[row]
                out_p[orig] = p[row]
                out_s[orig] = s[row]
        dists = np.stack(out_d)
        poss = np.stack(out_p)
        starts = np.stack(out_s)
        if self.top_k is None:          # unstacked top-1 / plain
            dists, poss, starts = dists[:, 0], poss[:, 0], starts[:, 0]
        else:
            dists, poss, starts = dists[:, :kk], poss[:, :kk], starts[:, :kk]
        if self._single:
            dists, poss, starts = dists[0], poss[0], starts[0]
        return StreamResult(
            distances=dists,
            positions=poss if wants_pos else None,
            starts=starts if (wants_pos and (self._track or self.prune))
            else None,
            samples=self.samples_seen,
            tiles_total=self.tiles_total,
            tiles_pruned_kim=self.tiles_pruned_kim,
            tiles_pruned_keogh=self.tiles_pruned_keogh,
            tiles_processed=self.tiles_processed)

    # ------------------------------------------------------------------
    # snapshot / restore (fault-tolerant serving)
    # ------------------------------------------------------------------

    def _relayout(self, b: _Bucket, carry, src: str, dst: str):
        """Bucket ``b``'s carry moved from impl ``src``'s layout to
        ``dst``'s. Pruned carries are the heap on both. In exact mode what
        ``results()`` reads is kept: the kernel's top-1 ``(best, end,
        start)`` and a k = 1 heap hold the same triple, the value and
        boundary lanes are the same on both; lanes that no output reads
        are refilled (ends and starts -1, boundary start lanes INT_FAR)."""
        if self.prune or src == dst:
            return carry
        track = self._track
        if carry is None:            # a kernel carry before the first feed
            return self._fresh_carry(b, dst)
        if src == "pallas":
            kc, heap = carry[:5 if track else 3], carry[5 if track else 3:]
            if track:
                bcol, bstart, best, pos, start = kc
            else:
                (bcol, best, pos), bstart = kc, None
                start = torch.full_like(pos, -1)
            if not self._heap_on(dst):
                return bcol, best
            if not heap:             # the top-1 as a k = 1 heap
                heap = (best[:, None], pos[:, None], start[:, None])
            return (bcol,) + ((bstart,) if track else ()) + (best,) + heap
        if self._dtype is None:
            return None
        bcol, heap = carry[0], ()
        if self._heap_on(src):
            best, heap = carry[-4], carry[-3:]
            bstart = carry[1] if track else None
            pos, start = heap[1][:, 0], heap[2][:, 0]
        else:
            best, bstart = carry[1], None
            pos = start = torch.full(best.shape, -1, dtype=torch.int32,
                                     device=best.device)
        if track and bstart is None:
            bstart = torch.full(bcol.shape, INT_FAR, dtype=torch.int32,
                                device=bcol.device)
        kc = (bcol, bstart, best, pos, start) if track else (bcol, best, pos)
        return kc + (heap if self._heap_on(dst) else ())

    def snapshot(self) -> dict:
        """Serialize the full session state as a flat dict of numpy arrays
        in the reference's format — ``np.savez(path, **snap)``-ready.
        ``restore()`` (of either package) continues bit for bit.

        The reference's kernel route takes no exclusion ranges, so a
        kernel session whose ranges ban (``impl='auto'`` on the card) is
        written in the row scan's layout under ``impl='rowscan'``, which
        both packages restore with its ranges. A session opened with
        ``'auto'`` records it (``meta['auto']``, which the reference
        ignores) and ``restore()`` here resolves it again on its device."""
        from repro_torch.kernels.sdtw import carry_to_numpy
        impl, carries = self.impl, [b.carry for b in self._buckets]
        if impl == "pallas" and any(b.ban is not None
                                    for b in self._buckets):
            impl = "rowscan"
            carries = [self._relayout(b, b.carry, self.impl, impl)
                       for b in self._buckets]
        meta = dict(
            version=_SNAP_VERSION, metric=self.metric, impl=impl,
            chunk=self.chunk, top_k=self.top_k, excl_mode=self.excl_mode,
            return_spans=self.return_spans,
            return_positions=self.return_positions, prune=self.prune,
            span_cap=self.span_cap,
            alert_threshold=self.alert_threshold,
            ref_key=self.ref_key if isinstance(self.ref_key, (str, int,
                                                              type(None)))
            else None,
            offset=self._offset, finalized=self._finalized,
            flush_shift=self._flush_shift_pending,
            block_q=self.block_q, block_m=self.block_m,
            dtype=None if self._dtype is None else np.dtype(
                self._dtype).name,
            nq=self._nq, single=self._single, ragged=self._ragged,
            tiles=[self.tiles_total, self.tiles_pruned_kim,
                   self.tiles_pruned_keogh, self.tiles_processed],
            env_tail=list(self._env_tail),
            n_buckets=len(self._buckets),
            bucket_idxs=[b.idxs for b in self._buckets],
            bucket_halos=[b.halo for b in self._buckets],
            carry_lens=[0 if c is None else len(c) for c in carries],
            n_ring=len(self._ring),
        )
        if self._auto:
            meta["auto"] = True
        snap = {"meta": np.array(json.dumps(meta)),
                "buffer": np.asarray(self._buf)}
        if self._env_mins:
            snap["env_mins"] = np.concatenate(self._env_mins)
            snap["env_maxs"] = np.concatenate(self._env_maxs)
        for t, tile in enumerate(self._ring):
            snap[f"ring{t}"] = np.asarray(tile)
        for bi, b in enumerate(self._buckets):
            for name in ("queries", "qlens", "lo", "hi", "zone"):
                snap[f"b{bi}_{name}"] = to_numpy(getattr(b, name))
            if b.thr is not None:
                snap[f"b{bi}_thr"] = np.asarray(b.thr)
            if carries[bi] is not None:
                for ci, leaf in enumerate(carry_to_numpy(carries[bi])):
                    snap[f"b{bi}_carry{ci}"] = leaf
        return snap

    @classmethod
    def restore(cls, snap, *, on_alert=None, cache=None, ref_key=None,
                device=None) -> "StreamSession":
        """Rebuild a session from ``snapshot()`` output of either package
        (or an ``np.load`` of it), its queries and carries on ``device``
        (``None``: the CUDA device). A session opened with ``impl='auto'``
        takes ``'auto'``'s impl on ``device``, its carries moved to that
        layout. ``on_alert``/``cache`` are not serialized — pass them
        again; ``ref_key`` overrides the snapshotted key."""
        meta = json.loads(str(np.asarray(snap["meta"])[()]))
        if meta["version"] != _SNAP_VERSION:
            raise ValueError(f"snapshot version {meta['version']} not "
                             f"supported (expected {_SNAP_VERSION})")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        for name in ("metric", "impl", "chunk", "top_k", "excl_mode",
                     "return_spans", "return_positions", "prune",
                     "span_cap", "alert_threshold", "block_q", "block_m"):
            setattr(self, name, meta[name])
        self._auto = bool(meta.get("auto", False))
        if self._auto:
            self.impl = search_mod._auto_engine(self.device)
        self.ref_key = meta["ref_key"] if ref_key is None else ref_key
        self.cache = cache_mod.DEFAULT_CACHE if cache is None else cache
        self.on_alert = on_alert
        self.alerts = []
        self._derive_modes()
        self._nq = meta["nq"]
        self._single = meta["single"]
        self._ragged = meta["ragged"]
        self._offset = meta["offset"]
        self._finalized = meta["finalized"]
        self._flush_shift_pending = meta.get("flush_shift", False)
        self._dtype = (None if meta["dtype"] is None
                       else np.dtype(meta["dtype"]))
        (self.tiles_total, self.tiles_pruned_kim, self.tiles_pruned_keogh,
         self.tiles_processed) = meta["tiles"]
        self._env_tail = [tuple(e) for e in meta["env_tail"]]
        self._buf = np.array(snap["buffer"])
        if "env_mins" in snap:
            self._env_mins = [np.asarray(snap["env_mins"])]
            self._env_maxs = [np.asarray(snap["env_maxs"])]
            if self.ref_key is not None:
                # Install the snapshotted prefix so a fresh cache sees the
                # whole stream — but never truncate a live entry that is
                # already further along.
                ck = (self.ref_key, False)
                cur = self.cache.peek(ck, self.chunk)
                if cur is None or len(cur[0]) < len(self._env_mins[0]):
                    self.cache.put(ck, self.chunk, snap["env_mins"],
                                   snap["env_maxs"])
        else:
            self._env_mins, self._env_maxs = [], []
        self._ring = [np.array(snap[f"ring{t}"])
                      for t in range(meta["n_ring"])]
        self._buckets = []
        for bi in range(meta["n_buckets"]):
            ncar = meta["carry_lens"][bi]
            carry = (tuple(torch.from_numpy(np.array(
                snap[f"b{bi}_carry{ci}"])).to(self.device)
                for ci in range(ncar)) if ncar else None)
            b = self._bucket(
                meta["bucket_idxs"][bi], snap[f"b{bi}_queries"],
                snap[f"b{bi}_qlens"], snap[f"b{bi}_lo"], snap[f"b{bi}_hi"],
                snap[f"b{bi}_zone"], meta["bucket_halos"][bi], carry,
                np.asarray(snap[f"b{bi}_thr"]) if f"b{bi}_thr" in snap
                else None)
            b.carry = self._relayout(b, carry, meta["impl"], self.impl)
            self._buckets.append(b)
        self._max_halo = max(b.halo for b in self._buckets)
        return self
