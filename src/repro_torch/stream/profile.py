"""Incremental matrix profile: the self-join that grows with the stream.

Counterpart of ``repro.stream.profile``. ``StreamProfile`` is the online
``repro_torch.search.profile.matrix_profile``: samples arrive through
``feed()``, and each arrival plays both self-join roles —

  * it **extends the reference**: every admitted window's nearest-
    neighbour carry advances over the new tile (``_step``: on the card one
    launch of the sDTW kernel's last-row capture with the start lane and
    each window's trivial-match band as its column ban, folded into a
    k = 1 heap; on the CPU the row-scan tile step ``_heap_step``);
  * it **admits new windows**: once the stream covers ``[s, s + window)``
    the window starting at ``s`` joins the batch, and since its neighbour
    may lie anywhere in the past, admission replays the recorded tiles
    for the new rows only (existing rows never recompute).

Exactness: each window's neighbour is a top-1 heap, exact under any feed
partition, so ``results()`` is int32-bitwise
``matrix_profile(series_so_far, ..., prune=False)`` however the stream was
sliced and however often ``flush()`` was called.

Costs, for T processed tiles and nw admitted windows: O(nw · window)
carries and O(M) sample history (kept for admissions); admission
catch-up replays O(T) tiles per admission, O(T²) tile steps over the
stream's life in the worst case (stride 1, small chunk). The window batch
is padded to a power-of-two capacity (``MIN_CAPACITY`` at least), so the
carries grow by doubling; padding rows ban every column and stay at the
``(BIG, -1, -1)`` heap sentinel.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distances import INT_FAR
from repro_torch.core.sdtw import sdtw_carry_init, self_join_exclusion
from repro_torch.core.topk import topk_init
from repro_torch.device import resolve_device, to_numpy
from repro_torch.search.profile import ProfileResult, _assemble_profile

from .session import DEFAULT_STREAM_CHUNK, _heap_step, _pallas_step

#: Smallest capacity of the admitted-window batch (power-of-two growth).
MIN_CAPACITY = 16


class StreamProfile:
    """Online sDTW matrix profile of an unbounded, growing series.

    ``feed(samples)`` appends to the series; ``results()`` returns the
    current ``ProfileResult`` (non-destructive: the buffered tail is
    applied to copies); ``flush()`` pushes the tail through destructively
    (exact: top-1 heaps do not depend on the partition). ``device=None``
    is the CUDA device, where every tile step is one kernel launch.
    """

    def __init__(self, window: int, stride: int = 1, k: int = 1, *,
                 metric: str = "abs_diff", chunk: Optional[int] = None,
                 excl_zone: Optional[int] = None, device=None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.window = int(window)
        self.stride = int(stride)
        self.k = int(k)
        self.metric = metric
        self.chunk = int(DEFAULT_STREAM_CHUNK if chunk is None else chunk)
        self.zone = window // 2 if excl_zone is None else int(excl_zone)
        if self.zone < 0:
            raise ValueError(f"excl_zone must be >= 0, got {excl_zone}")
        self.device = resolve_device(device)
        # Tile steps through the kernel (its plain version off the card).
        self._kernel = self.device.type == "cuda"

        self._dtype = None            # pinned by the first feed
        self._buf = np.zeros((0,), np.int32)
        self._offset = 0              # samples advanced through the DP
        # Processed-tile record for admission catch-up: (padded tile on
        # the device, true length, global start), replayed verbatim so a
        # late window sees exactly the tile partition the batch saw.
        self._tiles: List[Tuple[torch.Tensor, int, int]] = []
        self._hist = np.zeros((0,), np.int32)   # amortized doubling
        self._hist_len = 0
        self.tiles_processed = 0

        self._n = 0                   # admitted windows
        self._cap = 0
        self._q = None                # (cap, window) window slab
        self._lo = self._hi = None    # (cap,) banned ranges
        self._carry = None            # kernel or row-scan carry + heap

    # ------------------------------------------------------------------
    # feeding
    # ------------------------------------------------------------------

    @property
    def samples_seen(self) -> int:
        """Samples fed so far (including the buffered tail)."""
        return self._offset + int(self._buf.shape[0])

    @property
    def windows_admitted(self) -> int:
        return self._n

    def feed(self, data) -> "StreamProfile":
        """Append series samples; advance the DP by every whole tile."""
        data = to_numpy(data)
        if data.ndim != 1:
            raise ValueError(f"feed() takes a 1-D chunk, got shape "
                             f"{data.shape}")
        if data.shape[0] == 0:
            return self
        if self._dtype is None:
            self._dtype = data.dtype
            self._buf = np.zeros((0,), data.dtype)
            self._hist = np.zeros((self.chunk,), data.dtype)
        elif data.dtype != self._dtype:
            raise ValueError(f"stream dtype changed mid-flight: "
                             f"{self._dtype} -> {data.dtype}")
        self._buf = np.concatenate([self._buf, data])
        while self._buf.shape[0] >= self.chunk:
            tile, self._buf = (self._buf[:self.chunk],
                               self._buf[self.chunk:])
            self._advance(tile, self.chunk)
        return self

    def flush(self) -> "StreamProfile":
        """Destructively push the buffered tail through the DP. Exact, and
        the session keeps streaming (the partial tile replays with its
        true length for every later admission)."""
        if self._buf.shape[0]:
            tail, self._buf = self._buf, self._buf[:0]
            self._advance(self._padded(tail), int(tail.shape[0]))
        return self

    def _padded(self, tail):
        padded = np.zeros((self.chunk,), tail.dtype)
        padded[:tail.shape[0]] = tail
        return padded

    def _advance(self, tile_np: np.ndarray, clen: int):
        """One (possibly right-padded) tile: extend the reference for the
        admitted batch, then admit the windows the tile completed."""
        j0 = self._offset
        if self._hist_len + clen > self._hist.shape[0]:
            grown = np.zeros((max(self._hist.shape[0] * 2,
                                  self._hist_len + clen),), self._hist.dtype)
            grown[:self._hist_len] = self._hist[:self._hist_len]
            self._hist = grown
        self._hist[self._hist_len:self._hist_len + clen] = tile_np[:clen]
        self._hist_len += clen
        tile = torch.from_numpy(np.array(tile_np)).to(self.device)
        self._tiles.append((tile, clen, j0))
        if self._n:
            self._carry = self._step(self._q, self._lo, self._hi,
                                     self._carry, tile, clen, j0)
        self.tiles_processed += 1
        self._offset += clen
        self._admit()

    def _step(self, q, lo, hi, carry, tile, clen: int, j0: int):
        """One tile step over a capacity-padded batch: on the card one
        kernel launch (last-row capture, start lane, the ban) folded into
        the k = 1 heap; on the CPU the row-scan tile step."""
        cap = q.shape[0]
        qlens = torch.full((cap,), self.window, dtype=torch.int32,
                           device=self.device)
        zone = torch.zeros((cap,), dtype=torch.int32, device=self.device)
        if self._kernel:
            out, _, _ = _pallas_step(
                q, tile, qlens, carry[:-3], carry[-3:], j0, clen, zone,
                metric=self.metric, block_q=None, block_m=None, k=1,
                excl_span=False, track=True, want_lastrow=True,
                with_heap=True, excl_lo=lo, excl_hi=hi)
            return out
        return _heap_step(q, tile, qlens, carry, j0, j0 + clen, clen, lo, hi,
                          zone, metric=self.metric, k=1, excl_span=False,
                          track=True, lastrow=False)[0]

    # ------------------------------------------------------------------
    # window admission
    # ------------------------------------------------------------------

    def _pending_starts(self, covered: int) -> np.ndarray:
        """Starts of windows inside ``covered`` samples not yet admitted."""
        first = self._n * self.stride
        last = covered - self.window          # inclusive bound on starts
        if last < first:
            return np.zeros((0,), np.int64)
        return np.arange(first, last + 1, self.stride, dtype=np.int64)

    def _banned_rows(self, cap: int, starts: np.ndarray):
        """(lo, hi) on the device: real rows get the sample-unit trivial-
        match band, padding rows ban every column (their heaps stay at the
        sentinel)."""
        lo = torch.zeros((cap,), dtype=torch.int32)
        hi = torch.full((cap,), INT_FAR, dtype=torch.int32)
        if starts.size:
            lo[:starts.size], hi[:starts.size] = self_join_exclusion(
                starts, self.window, self.zone)
        return lo.to(self.device), hi.to(self.device)

    def _window_slab(self, cap: int, starts: np.ndarray,
                     hist: Optional[np.ndarray] = None) -> torch.Tensor:
        if hist is None:
            hist = self._hist[:self._hist_len]
        q = np.zeros((cap, self.window), self._dtype)
        col = np.arange(self.window, dtype=np.int64)
        if starts.size:
            q[:starts.size] = hist[starts[:, None] + col[None, :]]
        return torch.from_numpy(q).to(self.device)

    def _acc(self) -> torch.dtype:
        """The accumulator dtype of the stream (int32 until a feed)."""
        return (torch.float32 if self._dtype is not None
                and np.dtype(self._dtype).kind == "f" else torch.int32)

    def _fresh_carry(self, cap: int):
        acc = self._acc()
        heap = topk_init(cap, 1, acc, device=self.device)
        if self._kernel:
            from repro_torch.kernels.sdtw import kernel_carry_init
            return kernel_carry_init(cap, self.window, acc, True,
                                     self.device) + heap
        return sdtw_carry_init(cap, self.window, acc, track_start=True,
                               device=self.device) + heap

    def _catchup(self, starts: np.ndarray, tiles, hist=None):
        """Replay the recorded tiles for a batch of fresh windows; returns
        the finished capacity-padded carry (rows ``[0, len(starts))`` are
        the real ones)."""
        cap = max(MIN_CAPACITY, 1 << max(0, int(starts.size) - 1)
                  .bit_length())
        q = self._window_slab(cap, starts, hist)
        lo, hi = self._banned_rows(cap, starts)
        carry = self._fresh_carry(cap)
        for tile, clen, j0 in tiles:
            carry = self._step(q, lo, hi, carry, tile, clen, j0)
        return carry

    def _grow(self, need: int):
        """Double the admitted batch's capacity to hold ``need`` rows,
        padding every carry leaf with its fresh value."""
        new_cap = MIN_CAPACITY
        while new_cap < need:
            new_cap *= 2
        if new_cap == self._cap:
            return
        starts = np.arange(self._n, dtype=np.int64) * self.stride
        q = self._window_slab(new_cap, starts)
        lo, hi = self._banned_rows(new_cap, starts)
        carry = self._fresh_carry(new_cap)
        if self._carry is not None:
            for fresh, old in zip(carry, self._carry):
                fresh[:self._cap] = old
        self._q, self._lo, self._hi, self._carry = q, lo, hi, carry
        self._cap = new_cap

    def _admit(self):
        starts = self._pending_starts(self._offset)
        if not starts.size:
            return
        caught = self._catchup(starts, self._tiles)
        self._grow(self._n + starts.size)
        sl = slice(self._n, self._n + starts.size)
        lo, hi = self._banned_rows(starts.size, starts)
        self._q[sl] = self._window_slab(starts.size, starts)
        self._lo[sl], self._hi[sl] = lo, hi
        for main, new in zip(self._carry, caught):
            main[sl] = new[:starts.size]
        self._n += int(starts.size)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def results(self) -> ProfileResult:
        """The profile over everything fed so far — non-destructive: the
        buffered tail is applied to a copy of the carries (and the windows
        it completes are caught up on the side), so polling never moves
        the live session's tile boundaries."""
        tiles = list(self._tiles)
        carry = self._carry
        tail = self._buf
        if tail.shape[0]:
            padded = torch.from_numpy(self._padded(tail)).to(self.device)
            tiles.append((padded, int(tail.shape[0]), self._offset))
            if self._n:
                carry = self._step(self._q, self._lo, self._hi, carry,
                                   padded, int(tail.shape[0]), self._offset)
        n_live = self._n
        rows: List[Tuple[np.ndarray, ...]] = []
        if n_live:
            rows.append(tuple(to_numpy(x[:n_live, 0]) for x in carry[-3:]))
        pending = self._pending_starts(self.samples_seen)
        if pending.size:
            hist = np.concatenate([self._hist[:self._hist_len], self._buf])
            caught = self._catchup(pending, tiles, hist)
            rows.append(tuple(to_numpy(x[:pending.size, 0])
                              for x in caught[-3:]))
        nw = n_live + int(pending.size)
        if nw:
            nn_d, nn_p, nn_s = (np.concatenate(x) for x in zip(*rows))
        else:
            nn_d = to_numpy(torch.zeros((0,), dtype=self._acc()))
            nn_p = nn_s = np.zeros((0,), np.int64)
        starts = np.arange(nw, dtype=np.int64) * self.stride
        t = self.tiles_processed + (1 if tail.shape[0] else 0)
        return _assemble_profile(self.window, self.stride, self.k, starts,
                                 nn_d, nn_s.astype(np.int64),
                                 nn_p.astype(np.int64), self.zone,
                                 self.chunk, (t, 0, 0, t))
