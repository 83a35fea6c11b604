"""Sharded streaming: per-rank chunk streams through the systolic carry.

Counterpart of ``repro.stream.sharded``. A ``ShardedStreamSession`` is
the multi-rank sibling of ``StreamSession``: fed reference samples are
buffered into *macro-chunks* of ``ndev * chunk`` samples, each split
across the mesh's systolic axis (stage d owns its contiguous
``chunk``-sized slice), and the chunk carry — boundary column, start
lane, running best, top-K heap — crosses ranks in the same pipeline the
offline sharded engine runs (``repro_torch.distributed.sdtw_sharded``).
Between feeds the harvested per-microbatch carries live with the session
on every rank, so an unbounded reference streams through a fixed
pipeline in bounded memory. On a CUDA device each stage advances its
slice through the hand-written kernel (the top-K heap folded from its
last-row capture), on the CPU through the plain row scan.

SPMD, as every sharded call: every rank of the mesh opens the session
with the same arguments and feeds it the same samples, and every rank
holds the same results.

Rank order equals reference order and every stage advances its slice in
the same ``chunk`` tiles, so the heap-merge partition is a single-process
``StreamSession(chunk=chunk)``'s, and the results are bitwise equal to
it in both exclusion modes.

The final partial macro-chunk is right-padded and masked: distances,
spans and heaps fold exactly, but the exiting boundary column does not
survive the pad, so ``flush()`` finalizes the session. ``snapshot()``
writes the reference's format and carry layout (``(bcol, [bstart,]
best)`` plus the heap, stacked by slot), which either package restores.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from repro_torch.core.distances import accum_dtype
from repro_torch.core.sdtw import sdtw_carry_init
from repro_torch.core.topk import topk_init
from repro_torch.device import resolve_device, to_numpy
from repro_torch.distributed.sdtw_sharded import (PipelineSchedule,
                                                  default_mesh,
                                                  make_schedule,
                                                  sdtw_sharded_feed)
from repro_torch.distributed.sharding import pipeline_axes

from .session import DEFAULT_STREAM_CHUNK, StreamResult, _SNAP_VERSION


class ShardedStreamSession:
    """Online sDTW monitor with the arriving reference sharded across a
    mesh axis. Padded 2-D query batches only (bucket ragged sets into
    separate sessions); no pruning (the LB cascade is single-process) and
    no alerts (the candidate row never leaves the ranks). ``device`` is
    this rank's device (``None``: the CUDA device); on the card the
    kernel's launches are tuned (``ops.tuned_launch``, ``tune='model'``,
    the engine's default)."""

    def __init__(self, queries, *, qlens=None, metric: str = "abs_diff",
                 mesh=None, axis: str = "ref", dp_axis: Optional[str] = None,
                 chunk: Optional[int] = None, n_micro: Optional[int] = None,
                 top_k: Optional[int] = None, excl_zone=None,
                 excl_mode: str = "end", return_spans: bool = False,
                 return_positions: bool = False,
                 excl_lo=None, excl_hi=None, device=None):
        if isinstance(queries, (list, tuple)):
            raise ValueError("sharded sessions take a padded 2-D batch; "
                             "bucket ragged query sets into separate "
                             "sessions")
        if excl_mode not in ("end", "span"):
            raise ValueError(f"excl_mode must be 'end' or 'span', got "
                             f"{excl_mode!r}")
        if excl_zone is not None and np.ndim(excl_zone) != 0:
            raise ValueError("sharded sessions take a scalar excl_zone "
                             "(or None for the per-query default)")
        self.device = resolve_device(device)
        self.mesh = default_mesh(axis) if mesh is None else mesh
        self.axis = axis
        self.metric = metric
        self.chunk = int(DEFAULT_STREAM_CHUNK if chunk is None else chunk)
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        self.top_k = top_k
        self.excl_mode = excl_mode
        self.return_spans = bool(return_spans)
        self.return_positions = bool(return_positions)

        queries = torch.as_tensor(to_numpy(queries))
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        self._single = single
        nq, n = queries.shape
        self._nq, self._n = nq, n
        qlens = (torch.full((nq,), n, dtype=torch.int32) if qlens is None
                 else torch.as_tensor(to_numpy(qlens)).to(torch.int32))

        def ranges(x):
            return (torch.full((nq,), -1, dtype=torch.int32) if x is None
                    else torch.as_tensor(to_numpy(x)).to(torch.int32)
                    .expand(nq).clone())
        lo, hi = ranges(excl_lo), ranges(excl_hi)

        # Microbatch layout — the same schedule the offline engine uses.
        self._sched = make_schedule(self.mesh, nq, ref_axis=axis,
                                    dp_axis=dp_axis, n_micro=n_micro)
        self.dp_axis = self._sched.dp_axis
        self.n_dp = self._sched.n_dp
        self.ndev = self._sched.n_mp           # systolic pipeline depth
        self.macro = self.ndev * self.chunk
        self.n_micro, self.mb = self._sched.n_micro, self._sched.mb
        self._pack_inputs(self._sched.pack(queries),
                          self._sched.pack(qlens, fill=1),
                          self._sched.pack(lo, fill=-1),
                          self._sched.pack(hi, fill=-1))

        self._derive_modes()
        # Zone pinning mirrors sdtw_sharded: None derives per query in the
        # pipeline (half the true length; 0 in span mode).
        if not self._wants_heap:
            self._zone = 0
        elif excl_zone is not None:
            self._zone = int(excl_zone)
        else:
            self._zone = None if excl_mode == "end" else 0

        self._carry = None           # built on the first feed (dtype)
        self._buf = np.zeros((0,), np.int32)
        self._dtype = None
        self._offset = 0
        self._finalized = False
        self.tiles_total = 0

    def _pack_inputs(self, q, ql, lo, hi):
        dev = self.device
        self._q_micro = torch.as_tensor(q).to(dev)
        self._ql_micro = torch.as_tensor(ql).to(dev, torch.int32)
        self._lo_micro = torch.as_tensor(lo).to(dev, torch.int32)
        self._hi_micro = torch.as_tensor(hi).to(dev, torch.int32)

    def _derive_modes(self):
        """Mode lattice shared by ``__init__`` and ``restore()`` — one
        derivation, so a restored session unpacks the harvested carries
        under the layout that wrote them."""
        self._wants_heap = (self.top_k is not None or self.return_spans
                            or self.return_positions)
        self._k = 1 if self.top_k is None else self.top_k
        self._track = self.return_spans or self.excl_mode == "span"

    def _fresh_carry(self, ref_dtype):
        acc = accum_dtype(torch.promote_types(
            self._q_micro.dtype, torch.from_numpy(np.zeros(0, ref_dtype))
            .dtype))
        fresh = sdtw_carry_init(self.mb, self._n, acc,
                                track_start=self._wants_heap and self._track,
                                device=self.device)
        if self._wants_heap:
            fresh = fresh + topk_init(self.mb, self._k, acc,
                                      device=self.device)
        return tuple(x.expand((self._sched.slots,) + tuple(x.shape)).clone()
                     for x in fresh)

    @property
    def samples_seen(self) -> int:
        return self._offset + int(self._buf.shape[0])

    def feed(self, data) -> "ShardedStreamSession":
        """Append reference samples; advance by every whole macro-chunk."""
        if self._finalized:
            raise RuntimeError("session is finalized (a sharded flush is "
                               "terminal — the padded macro-chunk poisons "
                               "the exiting boundary column)")
        data = to_numpy(data)
        if data.ndim != 1:
            raise ValueError(f"feed() takes a 1-D chunk, got {data.shape}")
        if data.shape[0] == 0:
            return self
        if self._dtype is None:
            self._dtype = data.dtype
            self._buf = np.zeros((0,), data.dtype)
            self._carry = self._fresh_carry(data.dtype)
        elif data.dtype != self._dtype:
            raise ValueError(f"stream dtype changed mid-flight: "
                             f"{self._dtype} -> {data.dtype}")
        self._buf = np.concatenate([self._buf, data])
        while self._buf.shape[0] >= self.macro:
            macro, self._buf = (self._buf[:self.macro],
                                self._buf[self.macro:])
            self._carry = self._advance(self._carry, macro, self.macro)
            self._offset += self.macro
            self.tiles_total += self.ndev
        return self

    def flush(self) -> "ShardedStreamSession":
        """Push the buffered tail through as a padded, masked macro-chunk.

        Terminal: distances, spans and heaps fold exactly; the boundary
        column does not survive the pad."""
        if self._buf.shape[0]:
            tail, self._buf = self._buf, self._buf[:0]
            self._carry = self._advance(self._carry, tail,
                                        int(tail.shape[0]))
            self._offset += int(tail.shape[0])
            self.tiles_total += -(-int(tail.shape[0]) // self.chunk)
            self._finalized = True
        return self

    def _advance(self, carry, chunk_np: np.ndarray, clen: int):
        padded = np.zeros((self.macro,), chunk_np.dtype)
        padded[:clen] = chunk_np[:clen]
        return sdtw_sharded_feed(
            torch.from_numpy(padded), self._q_micro, self._ql_micro,
            self._lo_micro, self._hi_micro, carry,
            self._offset, self._offset + clen, mesh=self.mesh,
            axis=self.axis, dp_axis=self.dp_axis,
            chunk=self.chunk, metric=self.metric,
            top_k=self._k if self._wants_heap else None,
            excl_zone=self._zone, excl_span=self.excl_mode == "span",
            track_start=self._track, tune="model")

    def results(self) -> StreamResult:
        """Current match state, as numpy; non-destructive — a buffered
        tail is applied to a copy of the carry."""
        carry = self._carry
        if carry is not None and self._buf.shape[0]:
            carry = self._advance(carry, self._buf, int(self._buf.shape[0]))
        kk = self._k
        flat = self._sched.slots * self.mb
        if carry is None:
            d = np.full((flat, kk), np.inf)
            p = np.full((flat, kk), -1, np.int32)
            s = np.full((flat, kk), -1, np.int32)
        elif self._wants_heap:
            d, p, s = (to_numpy(x).reshape(flat, kk) for x in carry[-3:])
        else:
            d = to_numpy(carry[-1]).reshape(flat, 1)
            p = s = np.full((flat, 1), -1, np.int32)
        d, p, s = d[:self._nq], p[:self._nq], s[:self._nq]
        if self.top_k is None:
            d, p, s = d[:, 0], p[:, 0], s[:, 0]
        if self._single:
            d, p, s = d[0], p[0], s[0]
        wants_pos = self._wants_heap and (
            self.top_k is not None or self.return_positions
            or self.return_spans)
        return StreamResult(
            distances=d,
            positions=p if wants_pos else None,
            starts=s if (wants_pos and self._track) else None,
            samples=self.samples_seen,
            tiles_total=self.tiles_total,
            tiles_processed=self.tiles_total)

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat numpy dict (``np.savez``-ready) in the reference's format;
        ``restore()`` of either package rebuilds it against an equally
        shaped mesh."""
        meta = dict(
            version=_SNAP_VERSION, kind="sharded", metric=self.metric,
            axis=self.axis, ndev=self.ndev, chunk=self.chunk,
            dp_axis=self.dp_axis, n_dp=self.n_dp,
            n_micro=self.n_micro, mb=self.mb, nq=self._nq, n=self._n,
            single=self._single, top_k=self.top_k,
            excl_mode=self.excl_mode, return_spans=self.return_spans,
            return_positions=self.return_positions,
            zone=self._zone, offset=self._offset,
            finalized=self._finalized, tiles_total=self.tiles_total,
            dtype=None if self._dtype is None else np.dtype(
                self._dtype).name,
            carry_len=0 if self._carry is None else len(self._carry))
        snap = {"meta": np.array(json.dumps(meta)),
                "buffer": np.asarray(self._buf),
                "q_micro": to_numpy(self._q_micro),
                "ql_micro": to_numpy(self._ql_micro),
                "lo_micro": to_numpy(self._lo_micro),
                "hi_micro": to_numpy(self._hi_micro)}
        if self._carry is not None:
            for ci, leaf in enumerate(self._carry):
                snap[f"carry{ci}"] = to_numpy(leaf)
        return snap

    @classmethod
    def restore(cls, snap, *, mesh=None,
                device=None) -> "ShardedStreamSession":
        """Rebuild a session from ``snapshot()`` output of either package
        (or an ``np.load`` of it) on ``mesh`` (default: every rank on the
        snapshot's axis), which must resolve to the snapshot's (dp, mp)
        layout; its tensors on ``device`` (``None``: the CUDA device)."""
        meta = json.loads(str(np.asarray(snap["meta"])[()]))
        if meta.get("kind") != "sharded":
            raise ValueError("not a sharded-session snapshot")
        if meta["version"] != _SNAP_VERSION:
            raise ValueError(f"snapshot version {meta['version']} not "
                             f"supported")
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.mesh = default_mesh(meta["axis"]) if mesh is None else mesh
        self.axis = meta["axis"]
        dpax, mpax = pipeline_axes(self.mesh, ref_axis=self.axis,
                                   dp_axis=meta.get("dp_axis"))
        n_dp = self.mesh.shape[dpax] if dpax is not None else 1
        n_mp = self.mesh.shape[mpax]
        if n_mp != meta["ndev"] or n_dp != meta.get("n_dp", 1):
            raise ValueError(
                f"snapshot was taken on a ({meta.get('n_dp', 1)}, "
                f"{meta['ndev']}) (dp, mp) layout, mesh resolves to "
                f"({n_dp}, {n_mp})")
        self.dp_axis, self.n_dp, self.ndev = dpax, n_dp, n_mp
        self.metric = meta["metric"]
        self.chunk = meta["chunk"]
        self.macro = self.ndev * self.chunk
        self.top_k = meta["top_k"]
        self.excl_mode = meta["excl_mode"]
        self.return_spans = meta["return_spans"]
        self.return_positions = meta["return_positions"]
        self.n_micro, self.mb = meta["n_micro"], meta["mb"]
        self._nq, self._n = meta["nq"], meta["n"]
        # The exact layout the snapshot was written under (not via
        # make_schedule, whose defaults may change).
        self._sched = PipelineSchedule(dpax, mpax, n_dp, n_mp,
                                       self.n_micro, self.mb, self._nq)
        self._single = meta["single"]
        self._derive_modes()
        self._zone = meta["zone"]
        self._offset = meta["offset"]
        self._finalized = meta["finalized"]
        self.tiles_total = meta["tiles_total"]
        self._dtype = (None if meta["dtype"] is None
                       else np.dtype(meta["dtype"]))
        self._buf = np.array(snap["buffer"])
        self._pack_inputs(*(torch.from_numpy(np.array(snap[k])) for k in
                            ("q_micro", "ql_micro", "lo_micro",
                             "hi_micro")))
        self._carry = (tuple(torch.from_numpy(np.array(snap[f"carry{ci}"]))
                             .to(self.device)
                             for ci in range(meta["carry_len"]))
                       if meta["carry_len"] else None)
        return self
