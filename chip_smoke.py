#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed SEED]

Run from the root of a checkout, on a machine with a CUDA device, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA. It imports nothing of
JAX and nothing of the JAX package ``repro``. Phases, each of which raises
(and so exits non-zero) on any failed check:

  1. card identity (``nvidia-smi`` name and power limit, CUDA name);
  2. build every kernel from ``src/repro_torch/kernels/*/csrc`` with nvcc,
     all sources in parallel (timed; ptxas registers and spills logged);
  3. both kernels (rows and wavefront), every variant, against their
     plain PyTorch version on the card: int32 and float32, both metrics,
     plain / span / last-row, variable query lengths, R not dividing N,
     ``ref_lead``/``ref_len`` masks, carry chaining, block policy
     invariance, N up to 1536, and N = 5000 on the wavefront kernel in
     shared memory and in its global scratch — int32 and integer-valued
     float32 bitwise, real-valued float32 within ``rtol=1e-5``; then the
     ban (per-query column bans across slice edges, at a negative offset,
     empty and total), every variant, bitwise;
  4. the main path at full size: ``matsa(mode="query_filtering")`` on the
     paper's Table V "Human" workload (131,072 int32 queries of length
     120 against 7,997 samples), checked against the numpy oracle on 8
     queries and against the plain version on 1,024, bitwise;
  5. top-K matches through the last-row capture (the K3 variant folded by
     ``topk_fold_lastrow``) on all Human queries;
  6. a long reference: ``engine.sdtw(return_spans=True)`` at ECG's length
     (1,800,000 samples, queries of 512), 256 queries instead of 16,384;
  7. long queries (N = 5000, past the rows kernel): ``matsa()``, spans and
     top-K through the last row, on the wavefront kernel, against the
     plain version;
  8. every variant of both kernels timed with CUDA events at the Human
     and ECG-cut shapes beside its bound, the plain version once per
     variant and shape on one batch (16,384 Human or 32 ECG-cut queries,
     ``plain_queries`` in the JSON line); the rows kernel at Human with
     ragged lengths (its generic harvest); both kernels, every variant,
     at the other four Table V shapes cut to 4,224 queries (which is the
     faster: ``kernel="auto"``'s routing), checked equal to each other;
     the ban variants at ECG-cut with a self-join zone per query, both
     kernels held equal on every query and to the plain version on 32;
  9. pruned top-K search (``search_topk``, k = 3): all Human queries at
     full size, held on 64 queries against the exact search and the
     plain route (``engine_impl='rowscan'``); the ECG-cut batch, its top-1
     against phase 6; 8 queries of ECG's shape against a level-shifted
     reference, where chunks prune;
 10. a streaming session at ECG-cut: the 256 queries fed in 18 pieces of
     100,000 samples with spans, top-3 and alerts, its top-1 against
     phase 6, a snapshot after piece 9 restored and continued bitwise; a
     pruned stream of the 8 level-shifted queries against the exact one;
 11. alignment (``engine.align``) of 64 Human and 4 ECG-cut queries: every
     path valid and replaying its distance bitwise;
 12. the self-join at ECG's length: ``matsa(mode="self_join")`` with
     window and stride 512 (3,515 windows, the exact profile in batches
     of 256, every launch the rows kernel's K3 with the ban); its first
     batch (256 windows, 4 slices of 8,192 through the carry) held
     against the plain version slice by slice; 8 windows through the
     direct route (K1 and K2 with their bans) and their last rows held
     bitwise against the plain version over the whole series;
     the profile again in one batch of 4,096, bitwise; a self-join of
     1,600-sample windows on 100,000 samples (the wavefront kernel's
     bans, 4 windows against the plain version);
 13. the pruned profile (``matrix_profile``, k = 3) of the level-shifted
     series of ECG's length: its distances against the exact profile;
 14. ``StreamProfile(512, stride=512, k=3)`` over 262,144 samples, fed in
     ragged pieces with a mid-stream flush, against
     ``matrix_profile(prune=False)`` of the same prefix;
     then the JSON lines.

Phases 4-6 and 9-14 run on the rows kernel (``kernel="auto"``), phase 7
and the long self-join on the wavefront kernel; each path reads the
launch counts set to 0 just before it (``launches_by_path`` in the JSON
line).
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel variant — with and without the ban — with its launches
on its path, its largest difference from the plain version, its time,
the plain version's time and its bound.
Phase 2 also logs each library's registers and spills (``-Xptxas -v``)
and the static SASS instruction count of the main path's steady-state
loops (``cuobjdump -sass``).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

#: Peak device memory rate of an H100 SXM (NVIDIA's data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per SM on Hopper; the int32 rate is SMs × lanes × SM clock.
INT32_LANES_PER_SM = 64
#: int32 instructions the card needs per DP cell, as nvcc emits the
#: cell in the rows kernel's steady-state loop (``cuobjdump -sass``; the
#: counts phase 2 logs): plain, a subtract (IMAD.IADD), IABS (or IMAD for
#: square_diff), VIMNMX3 (the three-way min) and VIADDMNMX (add, then
#: the saturating min); with the start lane, the subtract, IABS, two
#: lexicographic mins of three compares (ISETP) and two predicated moves
#: each, and VIADDMNMX. The fused instructions are taken at the int32
#: rate (their own rate is not measured; a lower one would raise the
#: bound).
OPS_PER_CELL = {"plain": 4, "span": 13}


def log(*a):
    print(*a, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"
                          if query == "clocks.max.sm"
                          else "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


#: Main-path instantiations whose steady-state loop phase 2 counts:
#: (library, kernel name pattern in cuobjdump's listing, label, rows per
#: loop iteration). Rows kernel: <T, TRACK, SQUARE, R, BAN>; wavefront:
#: <T, TRACK, LASTROW, SQUARE, SCRATCH, BAN>, one row per thread per
#: diagonal at Human and ECG (threads per query >= N). BAN is the
#: per-query column ban; the self-join runs the rows kernel's K2/K3
#: instantiation with it (K2 and K3 share one: the last-row capture is a
#: runtime pointer there).
SASS_LOOPS = (
    ("sdtw_rows", r"sdtw_rows_kernelIiLb0ELb0ELi4ELb0EE",
     "rows K1 R=4 (Human)", 4),
    ("sdtw_rows", r"sdtw_rows_kernelIiLb1ELb0ELi4ELb0EE",
     "rows K2 R=4 (Human)", 4),
    ("sdtw_rows", r"sdtw_rows_kernelIiLb0ELb0ELi16ELb0EE",
     "rows K1 R=16 (ECG)", 16),
    ("sdtw_rows", r"sdtw_rows_kernelIiLb1ELb0ELi16ELb0EE",
     "rows K2 R=16 (ECG)", 16),
    ("sdtw_rows", r"sdtw_rows_kernelIiLb1ELb0ELi16ELb1EE",
     "rows K2/K3 R=16 with the ban (ECG self-join)", 16),
    ("sdtw", r"sdtw_wavefront_kernelIiLb0ELb0ELb0ELb0ELb0EE",
     "wavefront K1", 1),
    ("sdtw", r"sdtw_wavefront_kernelIiLb1ELb0ELb0ELb0ELb0EE",
     "wavefront K2", 1),
)


#: Opcodes of the DP cell's arithmetic that phase 2 counts in each loop
#: (a prefix; "@" counts only predicated instructions): a plain cell has
#: one IMAD.IADD (the subtract), IABS, VIMNMX3 and VIADDMNMX; a span cell
#: no VIMNMX3 but six compares and four predicated moves (its two
#: lexicographic mins). The loop's per-step instructions come on top.
CELL_OPCODES = ("IMAD.IADD", "IABS", "VIMNMX3", "VIADDMNMX", "ISETP",
                "@IMAD.MOV")


def _count_opcode(loop, key: str) -> int:
    pred = key.startswith("@")
    return sum(1 for t in loop
               if (not pred or t.startswith("@")) and re.sub(
                   r"^@!?U?P\w+\s+", "", t).startswith(key.lstrip("@")))


def sass_loops(sass: str, pattern: str):
    """The loops of the first kernel in ``sass`` (``cuobjdump -sass``
    text) whose name matches ``pattern``, one per predicated backward
    branch: ``[(instructions, shuffles, barriers, selects, {opcode:
    count for CELL_OPCODES})]``, largest first. Counts are static: every
    instruction between the loop's head and its back edge, rarely taken
    blocks included."""
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs[1:]
                if re.search(pattern, f.split("\n", 1)[0]))
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body)]
    loops = []
    for addr, text in ins:
        m = re.match(r"@!?U?P\w+\s+BRA\s+(?:\S+,\s+)?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loop = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            loops.append((len(loop), sum("SHFL" in t for t in loop),
                          sum("BAR.SYNC" in t for t in loop),
                          _count_opcode(loop, "SEL "),
                          {o: _count_opcode(loop, o) for o in CELL_OPCODES}))
    return sorted(loops, key=lambda x: x[:4], reverse=True)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flat(z)]
    return [x]


def cuda_ms(fn, reps: int = 3, warmup: bool = True) -> float:
    """Median time of ``fn`` over ``reps`` runs (after one warm-up run
    unless ``warmup`` is false), by CUDA events."""
    import torch
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Harness:
    """Runs the kernel and its plain version on the same card inputs and
    keeps, per variant, the largest difference seen."""

    def __init__(self, torch, ops, plain, dev):
        self.torch, self.ops, self.plain, self.dev = torch, ops, plain, dev
        self.err = {k: 0.0 for k in ops.LAUNCHES}

    def prep(self, q, r, qlens):
        from repro_torch.core.distances import accum_dtype, result_dtype
        t = self.torch
        q = t.as_tensor(q).to(self.dev)
        r = t.as_tensor(r).to(self.dev)
        acc = accum_dtype(result_dtype(q, r))
        qlens = (t.full((q.shape[0],), q.shape[1], dtype=t.int32,
                        device=self.dev) if qlens is None
                 else t.as_tensor(qlens).to(self.dev, t.int32))
        return q.to(acc).contiguous(), r.to(acc).contiguous(), qlens, acc

    def kernel(self, q, r, qlens=None, metric="abs_diff", track=False,
               lastrow=False, carry=None, **kw):
        """The kernel's outputs (``kernel=`` in ``kw`` picks it) as the raw
        tuple (best, pos, start, bcol, bstart, lastrow, lastrow_start)."""
        out = self.ops.sdtw_cuda(q, r, qlens, metric, carry=carry,
                                 return_carry=True, return_spans=track,
                                 return_positions=not track,
                                 return_lastrow=lastrow, device=self.dev,
                                 **kw)
        c = out[1]
        lr = list(out[2:]) + [None, None]
        if track:
            return (c[2], c[3], c[4], c[0], c[1], lr[0], lr[1])
        return (c[1], c[2], None, c[0], None, lr[0], None)

    def plain_raw(self, q, r, qlens=None, metric="abs_diff", track=False,
                  lastrow=False, carry=None, ref_offset=0, ref_len=None,
                  ref_lead=0, excl_lo=None, excl_hi=None):
        q, r, qlens, acc = self.prep(q, r, qlens)
        if excl_lo is not None:
            excl_lo, excl_hi = (self.torch.as_tensor(x).to(
                self.dev, self.torch.int32) for x in (excl_lo, excl_hi))
        if carry is None:
            carry = self.ops.kernel_carry_init(q.shape[0], q.shape[1], acc,
                                               track, self.dev)
        if track:
            bcol, bstart, best, pos, start = carry
        else:
            (bcol, best, pos), bstart, start = carry, None, None
        return self.plain(q, r, qlens, metric, bcol, best, pos, bstart, start,
                          ref_offset, ref_len, ref_lead, lastrow, excl_lo,
                          excl_hi)

    def compare(self, name, got, want, exact=True):
        """Bitwise (``exact``) or, for real-valued float32, distances
        within rtol=1e-5 with positions not compared."""
        t = self.torch
        t.cuda.synchronize()
        worst = 0.0
        for g, w in zip(got, want if exact else want[:1]):
            if g is None and w is None:
                continue
            d = (g.double() - w.double()).abs()
            d = d[t.isfinite(d)]
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
            if exact and not t.equal(g, w):
                raise AssertionError(f"{name}: kernel != plain version")
        if not exact and not t.allclose(got[0], want[0], rtol=1e-5, atol=0):
            raise AssertionError(f"{name}: distances beyond rtol=1e-5")
        return worst

    def check(self, name, q, r, qlens=None, metric="abs_diff", track=False,
              lastrow=False, exact=True, configs=None, **kw):
        """Every kernel configuration (``(kernel, launch kwargs)`` pairs;
        default both kernels with the default policy) against one run of
        the plain version. Returns the number of comparisons."""
        configs = configs or [(k, {}) for k in self.ops.KERNELS]
        want = self.plain_raw(q, r, qlens, metric, track, lastrow, **kw)
        for kernel, launch in configs:
            got = self.kernel(q, r, qlens, metric, track, lastrow,
                              kernel=kernel, **launch, **kw)
            ban = kw.get("excl_lo") is not None
            self.record(self.ops.variant(track, lastrow, kernel, ban),
                        self.compare(f"{kernel} {launch} {name}", got, want,
                                     exact))
        return len(configs)

    def record(self, var, worst):
        self.err[var] = max(self.err[var], worst)


def phase_kernels(h, np, rng):
    """Phase 3: every variant of both kernels against the plain version,
    which runs once per input."""
    n_checks = 0
    shapes = [(3, 5, 17), (16, 120, 1000), (5, 200, 900), (4, 512, 3000)]
    modes = [(False, False), (True, False), (False, True), (True, True)]
    for dtype in (np.int32, np.float32):
        for metric in ("abs_diff", "square_diff"):
            for b, n, m in shapes:
                for track, lastrow in modes:
                    q = rng.integers(-60, 60, (b, n)).astype(dtype)
                    r = rng.integers(-60, 60, m).astype(dtype)
                    qlens = rng.integers(1, n + 1, b).astype(np.int32)
                    qlens[0] = n
                    n_checks += h.check(
                        f"{dtype.__name__} {metric} {(b, n, m)} "
                        f"track={track} lastrow={lastrow}", q, r, qlens,
                        metric, track, lastrow, ref_offset=7)
    q = rng.integers(-60, 60, (2, 1536)).astype(np.int32)
    r = rng.integers(-60, 60, 2500).astype(np.int32)
    for track, lastrow in modes:
        n_checks += h.check(f"N=1536 track={track} lastrow={lastrow}", q, r,
                            None, "abs_diff", track, lastrow)
    # The rows kernel at every R (the policy picks R at N = 32·R - 3, which
    # R does not divide for R > 1), with a query ending on a lane's last
    # slot, one elsewhere and one with no last row.
    for rows in h.ops.ROWS_PER_LANE:
        n = 32 * rows - 3
        q = rng.integers(-60, 60, (4, n)).astype(np.int32)
        r = rng.integers(-60, 60, 700).astype(np.int32)
        for track, lastrow in modes:
            n_checks += h.check(
                f"R={rows} N={n} track={track} lastrow={lastrow}", q, r,
                np.array([n, rows, n - 1, 0], np.int32), "abs_diff", track,
                lastrow, configs=[("rows", {})])
    # N = 5000 on the wavefront kernel: shared memory, then global scratch.
    q = rng.integers(-60, 60, (3, 5000)).astype(np.int32)
    r = rng.integers(-60, 60, 600).astype(np.int32)
    for track, lastrow in modes:
        n_checks += h.check(
            f"N=5000 track={track} lastrow={lastrow}", q, r,
            np.array([5000, 4321, 1], np.int32), "abs_diff", track, lastrow,
            configs=[("wavefront", {}), ("wavefront", dict(block_q=2))])
    q = rng.integers(-60, 60, (6, 40)).astype(np.int32)
    r = rng.integers(-60, 60, 900).astype(np.int32)
    for lead, rlen in ((0, 500), (13, 900), (30, 30), (0, 0), (100, 640)):
        for track, lastrow in modes:
            n_checks += h.check(
                f"lead={lead} len={rlen}", q, r,
                np.array([40, 1, 17, 33, 2, 40], np.int32), "abs_diff",
                track, lastrow, ref_offset=1000, ref_lead=lead, ref_len=rlen)
    qf = rng.normal(0, 50, (8, 64)).astype(np.float32)
    rf = rng.normal(0, 50, 2000).astype(np.float32)
    n_checks += h.check("float32 real-valued (rtol=1e-5)", qf, rf,
                        exact=False)

    # Carry chaining: three slices through the carry == one launch.
    q = rng.integers(-60, 60, (9, 120)).astype(np.int32)
    r = rng.integers(-60, 60, 2000).astype(np.int32)
    for kernel in h.ops.KERNELS:
        for track in (False, True):
            whole = h.kernel(q, r, track=track, kernel=kernel)
            carry = None
            for off in range(0, 2000, 700):
                sl = np.zeros(700, np.int32)
                cl = min(700, 2000 - off)
                sl[:cl] = r[off:off + cl]
                _, carry = h.ops.sdtw_cuda(q, sl, carry=carry, ref_offset=off,
                                           ref_len=cl, return_carry=True,
                                           track_start=track, device=h.dev,
                                           kernel=kernel)
            chained = ((carry[2], carry[3], carry[4], carry[0], carry[1])
                       if track else (carry[1], carry[2], None, carry[0],
                                      None))
            h.compare(f"{kernel} carry chaining track={track}", chained,
                      whole[:5])
            n_checks += 1
    # Block-policy invariance, and the two kernels agree.
    base = h.kernel(q, r, track=True, kernel="wavefront")
    for kernel, launch in (("wavefront", dict(block_q=1, block_m=16)),
                           ("wavefront", dict(block_q=3, block_m=64)),
                           ("wavefront", dict(block_q=8, block_m=1024)),
                           ("rows", {}), ("rows", dict(block_q=1)),
                           ("rows", dict(block_q=8))):
        h.compare(f"{kernel} {launch}", h.kernel(
            q, r, track=True, kernel=kernel, **launch), base)
        n_checks += 1
    return n_checks


def bans_for(np, rng, b: int, lo_col: int, hi_col: int):
    """(b,) int32 banned global column ranges around the slice
    ``[lo_col, hi_col)``: across either edge, inside, outside, empty, and
    one query banned everywhere."""
    lo = rng.integers(lo_col - 200, hi_col + 50, b)
    hi = lo + rng.integers(0, 900, b)
    lo[0], hi[0] = 0, 2**31 - 1                  # fully banned
    if b > 1:
        hi[1] = lo[1]                            # empty
    return lo.astype(np.int32), hi.astype(np.int32)


def phase_bans(h, np, rng):
    """Phase 3 (the ban): every variant of both kernels with per-query
    column bans against the plain version with the same bans."""
    n_checks = 0
    modes = [(False, False), (True, False), (False, True), (True, True)]
    for dtype, metric in ((np.int32, "abs_diff"), (np.int32, "square_diff"),
                          (np.float32, "abs_diff")):
        for b, n, m, off, lead, rlen in ((7, 5, 300, 100, 0, 300),
                                         (8, 120, 1000, -200, 200, 1000),
                                         (8, 512, 3000, 4000, 0, 2500)):
            q = rng.integers(-60, 60, (b, n)).astype(dtype)
            r = rng.integers(-60, 60, m).astype(dtype)
            qlens = rng.integers(1, n + 1, b).astype(np.int32)
            qlens[:2] = n
            lo, hi = bans_for(np, rng, b, off, off + m)
            for track, lastrow in modes:
                n_checks += h.check(
                    f"ban {dtype.__name__} {metric} {(b, n, m)} offset="
                    f"{off} track={track} lastrow={lastrow}", q, r, qlens,
                    metric, track, lastrow, ref_offset=off, ref_lead=lead,
                    ref_len=rlen, excl_lo=lo, excl_hi=hi)
    # N = 1536 (the rows kernel's last R) and N = 5000 (the wavefront in
    # shared memory and in its global scratch), K1 and K3 with the start
    # lane (every line of the ban is in both).
    for n, m, configs in ((1536, 2500, None),
                          (5000, 600, [("wavefront", {}),
                                       ("wavefront", dict(block_q=2))])):
        q = rng.integers(-60, 60, (3, n)).astype(np.int32)
        r = rng.integers(-60, 60, m).astype(np.int32)
        lo, hi = bans_for(np, rng, 3, 0, m)
        for track, lastrow in (modes[0], modes[3]):
            n_checks += h.check(
                f"ban N={n} track={track} lastrow={lastrow}", q, r, None,
                "abs_diff", track, lastrow, configs=configs, excl_lo=lo,
                excl_hi=hi)
    # Carry chaining with bans across slice edges == one launch.
    q = rng.integers(-60, 60, (9, 120)).astype(np.int32)
    r = rng.integers(-60, 60, 2000).astype(np.int32)
    lo, hi = bans_for(np, rng, 9, 0, 2000)
    for kernel in h.ops.KERNELS:
        for track in (False, True):
            whole = h.kernel(q, r, track=track, kernel=kernel, excl_lo=lo,
                             excl_hi=hi)
            carry = None
            for off in range(0, 2000, 700):
                sl = np.zeros(700, np.int32)
                cl = min(700, 2000 - off)
                sl[:cl] = r[off:off + cl]
                _, carry = h.ops.sdtw_cuda(q, sl, carry=carry, ref_offset=off,
                                           ref_len=cl, return_carry=True,
                                           track_start=track, device=h.dev,
                                           kernel=kernel, excl_lo=lo,
                                           excl_hi=hi)
            chained = ((carry[2], carry[3], carry[4], carry[0], carry[1])
                       if track else (carry[1], carry[2], None, carry[0],
                                      None))
            h.compare(f"{kernel} ban carry chaining track={track}", chained,
                      whole[:5])
            n_checks += 1
    return n_checks


class KernelTimer:
    """CUDA events around every ``sdtw_cuda`` call the port makes while
    active (the package attribute the search and stream layers call is
    wrapped), so a path's kernel time can be set beside its wall time."""

    def __init__(self, torch, kpkg):
        self.torch, self.kpkg, self.events = torch, kpkg, []

    def __enter__(self):
        self.orig = self.kpkg.sdtw_cuda

        def timed(*a, **kw):
            ev = [self.torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            out = self.orig(*a, **kw)
            ev[1].record()
            self.events.append(ev)
            return out
        self.kpkg.sdtw_cuda = timed
        return self

    def __exit__(self, *exc):
        self.kpkg.sdtw_cuda = self.orig

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class NoRowScan:
    """Fails the path if the plain PyTorch schedules ran while active: the
    row scan's chunk and batch functions and the wavefront schedule of
    ``repro_torch.core.sdtw`` (every plain DP route goes through one of
    them) are wrapped with a counter."""
    NAMES = ("rowscan_chunk_batch", "rowscan_batch", "wavefront_batch")

    def __init__(self, name):
        self.name, self.calls = name, 0

    def __enter__(self):
        import importlib
        # (``repro_torch.core.sdtw`` the package attribute is the engine's
        # ``sdtw`` function; the module is what the schedules live in.)
        core_sdtw = importlib.import_module("repro_torch.core.sdtw")
        self.mod, self.orig = core_sdtw, {}
        for fn in self.NAMES:
            self.orig[fn] = getattr(core_sdtw, fn)

            def counted(*a, _fn=self.orig[fn], **kw):
                self.calls += 1
                return _fn(*a, **kw)
            setattr(core_sdtw, fn, counted)
        return self

    def __exit__(self, *exc):
        for fn, orig in self.orig.items():
            setattr(self.mod, fn, orig)
        if exc[0] is None and self.calls:
            raise AssertionError(f"{self.name}: {self.calls} calls of the "
                                 f"plain row scan on the card's path")


def level_shifted(np, rng, m: int, seg: int = 1 << 16):
    """int32 noise (sigma 40) around a level that moves by 1,000 every
    ``seg`` samples — a sensor whose operating point shifts, so the
    envelopes of far chunks bound a query away and chunks prune."""
    levels = 1000 * rng.permutation(-(-m // seg)) - 14000
    return (np.repeat(levels, seg)[:m]
            + rng.normal(0, 40, m)).astype(np.int32)


def _same_search(name, got, want):
    """Two SearchResults bitwise (all fields and the pruning counters)."""
    import torch
    for f in ("distances", "starts", "positions"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{name}: {f} differ")
    counters = ("chunks_total", "chunks_pruned_kim", "chunks_pruned_keogh",
                "chunks_processed")
    if [getattr(got, c) for c in counters] != \
            [getattr(want, c) for c in counters]:
        raise AssertionError(f"{name}: pruning counters differ")


def _counters(res, prefix="chunks"):
    keys = ("total", "pruned_kim", "pruned_keogh", "processed")
    return {k: getattr(res, f"{prefix}_{k}") for k in keys}


def phase_search(torch, np, ops, kpkg, human, ecg, ls8, dev):
    """Phase 9: pruned top-K search at full width. Returns the launches of
    each path."""
    from repro_torch.core import engine
    from repro_torch.search import search_topk
    k = 3
    qt, rt = human
    launches = {}
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer:
        res = search_topk(qt, rt, k=k, device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    kernel_ms = timer.ms()
    launches["search_human"] = dict(ops.LAUNCHES)
    if launches["search_human"]["rows_lastrow"] < 1 or sum(
            launches["search_human"].values()) != \
            launches["search_human"]["rows_lastrow"]:
        raise AssertionError(f"Human search missed the kernel: "
                             f"{launches['search_human']}")
    sub = qt[:64]
    exact = search_topk(sub, rt, k=k, prune=False, device=dev)
    if not torch.equal(res.distances[:64], exact.distances):
        raise AssertionError("Human search: distances != prune=False")
    same_spans = int(((res.starts[:64] == exact.starts)
                      & (res.positions[:64] == exact.positions)).all(1)
                     .sum())
    kern = search_topk(sub, rt, k=k, device=dev)
    plain = search_topk(sub, rt, k=k, engine_impl="rowscan", device=dev)
    _same_search("Human 64 queries kernel vs plain route", kern, plain)
    log(f"phase 9: search_topk(k={k}) Human {tuple(qt.shape)} vs "
        f"{rt.shape[0]}: {wall:.3f} s wall, kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / 1e3 / wall:.1%}), chunk {res.chunk}, "
        f"{_counters(res)}, launches {launches['search_human']}; 64 "
        f"queries: distances == prune=False (spans equal on {same_spans}/64"
        f"), kernel route == plain route bitwise")

    qe, re_, de = ecg
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer:
        res = search_topk(qe, re_, k=k, device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    kernel_ms = timer.ms()
    launches["search_ecg"] = dict(ops.LAUNCHES)
    if launches["search_ecg"]["rows_lastrow"] < 1:
        raise AssertionError(f"ECG search missed the kernel: "
                             f"{launches['search_ecg']}")
    if not torch.equal(res.distances[:, 0], de):
        raise AssertionError("ECG search top-1 != engine.sdtw (phase 6)")
    log(f"phase 9: search_topk(k={k}) ECG-cut {tuple(qe.shape)} vs "
        f"{re_.shape[0]}: {wall:.3f} s wall, kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / 1e3 / wall:.1%}), chunk {res.chunk}, "
        f"{_counters(res)}; top-1 == phase 6 bitwise")

    q8, r8 = ls8
    t0 = time.time()
    res = search_topk(q8, r8, k=k, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if res.chunks_pruned < 1:
        raise AssertionError(f"level-shifted search pruned nothing: "
                             f"{_counters(res)}")
    if not torch.equal(res.distances[:, 0],
                       engine.sdtw(q8, r8, device=dev)):
        raise AssertionError("level-shifted search top-1 != engine.sdtw")
    log(f"phase 9: search_topk(k={k}) 8 level-shifted queries of "
        f"{q8.shape[1]} vs {r8.shape[0]}: {wall:.3f} s wall, "
        f"{_counters(res)}; top-1 == engine.sdtw")
    return launches


def phase_stream(torch, np, ops, kpkg, ecg, ls8, dev):
    """Phase 10: a streaming session at ECG-cut. Returns its launches."""
    from repro_torch.core import engine
    from repro_torch.stream import StreamSession
    qe, re_, (de, se, ee) = ecg
    ref = re_.cpu().numpy()
    piece = 100_000
    thr = float(torch.quantile(de.double(), 0.1))
    kw = dict(return_spans=True, top_k=3, alert_threshold=thr, device=dev)
    ops.reset_launches()
    snap = None
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer:
        s = engine.stream(qe, **kw)
        for i, off in enumerate(range(0, len(ref), piece)):
            s.feed(ref[off:off + piece])
            if i == 8:
                snap = s.snapshot()
        # Alerts fire for processed tiles only (as in the reference;
        # results() reads the buffered tail on a copy and raises none), so
        # the tail is flushed before the alerts are held against the
        # offline distances over the whole reference.
        done = len(ref) // s.chunk * s.chunk      # samples in whole tiles
        s.flush()
        res = s.results()
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    if s.impl != "pallas" or launches["rows_lastrow"] < 1:
        raise AssertionError(f"stream missed the kernel: {launches}")
    for f, want in (("distances", de), ("starts", se), ("positions", ee)):
        if not np.array_equal(getattr(res, f)[:, 0], want.cpu().numpy()):
            raise AssertionError(f"stream top-1 {f} != engine.sdtw")
    best = {}
    for ev in s.alerts:
        if ev.distance > thr:
            raise AssertionError(f"alert above the threshold: {ev}")
        best[ev.query] = min(best.get(ev.query, ev.distance), ev.distance)
    d, ee_np = de.cpu().numpy(), ee.cpu().numpy()
    below = {int(i) for i in np.nonzero(d <= thr)[0]}
    in_tail = [i for i in sorted(below) if ee_np[i] >= done]
    if set(best) != below or any(best[i] != d[i] for i in below):
        raise AssertionError(f"alerts disagree with the offline distances: "
                             f"{sorted(set(best) ^ below)} differ in the "
                             f"set, {[i for i in below if best.get(i) != d[i]]}"
                             f" in the distance")
    restored = StreamSession.restore(snap, device=dev)
    at = restored.samples_seen
    restored.feed(ref[at:])
    restored.flush()
    res2 = restored.results()
    for f in ("distances", "starts", "positions"):
        if not np.array_equal(getattr(res2, f), getattr(res, f)):
            raise AssertionError(f"restored stream {f} differ")
    if restored.alerts != [e for e in s.alerts
                           if e.tile_start >= snap_offset(snap)]:
        raise AssertionError("restored stream alerts differ")
    log(f"phase 10: stream ECG-cut {tuple(qe.shape)}, {len(ref) // piece} "
        f"pieces of {piece} (tile {s.chunk}): {wall:.3f} s wall, kernel "
        f"{timer.ms():.3f} ms ({timer.ms() / 1e3 / wall:.1%}), tiles "
        f"{res.tiles_total} processed {res.tiles_processed}, "
        f"{len(s.alerts)} alerts (threshold {thr:.0f}) for {len(below)} "
        f"queries ({len(in_tail)} of them with their best match ending in "
        f"the last {len(ref) - done} samples, alerted at the flush); "
        f"launches {launches}; top-1 == phase 6 bitwise, snapshot after "
        f"piece 9 restored at {at} samples == bitwise")

    q8, r8 = ls8
    r8 = r8.cpu().numpy()
    exact = engine.stream(q8, top_k=3, return_spans=True, device=dev)
    pruned = engine.stream(q8, top_k=3, return_spans=True, prune=True,
                           device=dev)
    t0 = time.time()
    with KernelTimer(torch, kpkg) as ptimer:
        for off in range(0, len(r8), piece):
            pruned.feed(r8[off:off + piece])
        pres = pruned.results()
    pwall = time.time() - t0
    for off in range(0, len(r8), piece):
        exact.feed(r8[off:off + piece])
    eres = exact.results()
    if not np.array_equal(pres.distances, eres.distances):
        raise AssertionError("pruned stream distances != exact stream")
    if pres.tiles_pruned < 1:
        raise AssertionError("pruned stream pruned no tile")
    spans = int((np.all(pres.starts == eres.starts, axis=1)
                 & np.all(pres.positions == eres.positions, axis=1)).sum())
    log(f"phase 10: pruned stream, 8 level-shifted queries: {pwall:.3f} s "
        f"wall, kernel {ptimer.ms():.3f} ms, {_counters(pres, 'tiles')}; "
        f"distances == exact stream (spans equal on {spans}/8)")
    return launches


def _same_profile(name, got, want, fields=None):
    """Two ProfileResults bitwise in ``fields`` (default every per-window
    array and the motif/discord selections)."""
    import numpy as np
    for f in fields or ("starts", "nn_dist", "nn_start", "nn_end",
                        "nn_window", "motif_a", "motif_b", "motif_dist",
                        "discord_idx", "discord_dist"):
        g, w = getattr(got, f), getattr(want, f)
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{name}: {f} differ")


def _only(ops, key, name):
    """The launch counts since the last reset: ``key`` at least once and
    nothing else."""
    got = dict(ops.LAUNCHES)
    if got[key] < 1 or sum(got.values()) != got[key]:
        raise AssertionError(f"{name}: expected only {key} launches, got "
                             f"{ {k: v for k, v in got.items() if v} }")
    return got


def phase_self_join(torch, np, ops, kpkg, h, series, int32_rate, dev):
    """Phase 12: ``matsa(mode='self_join')`` at ECG's length — window 512
    (ECG's Table V query length), stride 512, the exact profile in the
    default batches of 256 — then 8 of its windows through the direct
    route (``engine.sdtw`` with their bans) against the plain version over
    the whole series, and the same profile in one batch of 4,096. Returns
    the launches by path and the profile."""
    from repro_torch.core import engine
    from repro_torch.core.matsa_api import matsa
    from repro_torch.core.sdtw import self_join_exclusion
    from repro_torch.search import matrix_profile
    w = 512
    st = torch.as_tensor(series, device=dev)
    launches = {}
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer, NoRowScan("self-join"):
        res = matsa(series, mode="self_join", window=w, stride=w, device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    kernel_ms = timer.ms()
    prof = res.profile
    nw = len(prof.starts)
    want = -(-nw // 256) * -(-len(series) // prof.chunk)
    launches["self_join_ecg"] = _only(ops, "rows_lastrow_ban", "self-join")
    if launches["self_join_ecg"]["rows_lastrow_ban"] != want:
        raise AssertionError(f"self-join: {want} launches expected")
    d = res.distances
    if d.shape != (nw,) or d.dtype != torch.int32 or d.device != st.device:
        raise AssertionError(f"self-join: unexpected result {d.shape} "
                             f"{d.dtype} on {d.device}")
    if not prof.valid.all() or not (prof.nn_dist < 2**29).all():
        raise AssertionError("self-join: a window without a neighbour")

    # One batch of the path as ``_kernel_topk_scan`` launches it: the first
    # 256 windows with their bans, slices of ``prof.chunk`` columns through
    # the carry, held against the plain version slice by slice (each on
    # its own carry) over the first 4 slices (the plain version's time
    # grows with the columns).
    c, nb, nsl = prof.chunk, min(256, nw), 4
    s_b = prof.starts[:nb]
    qb = torch.as_tensor(series[s_b[:, None] + np.arange(w)], device=dev)
    lob, hib = (x.to(dev) for x in self_join_exclusion(s_b, w))
    kc = pc = None
    t0 = time.time()
    for off in range(0, nsl * c, c):
        kw_ = dict(track=True, lastrow=True, ref_offset=off, ref_len=c,
                   excl_lo=lob, excl_hi=hib)
        got = h.kernel(qb, st[off:off + c], carry=kc, **kw_)
        ref = h.plain_raw(qb, st[off:off + c], carry=pc, **kw_)
        h.record("rows_lastrow_ban", h.compare(
            f"self-join batch of {nb}, slice at {off}", got, ref))
        kc = (got[3], got[4], got[0], got[1], got[2])
        pc = (ref[3], ref[4], ref[0], ref[1], ref[2])
    del got, ref, kc, pc
    log(f"phase 12: one batch of the path ({nb} windows with their bans, "
        f"{nsl} slices of {c} through the carry) == plain version slice by "
        f"slice, every output ({time.time() - t0:.1f} s)")
    cells = nw * w * len(series)
    bound_s = cells * OPS_PER_CELL["span"] / int32_rate
    log(f"phase 12: matsa(self_join) window {w} stride {w} on {len(series)}"
        f" samples: {nw} windows, {wall:.3f} s wall, kernel "
        f"{kernel_ms:.3f} ms ({kernel_ms / 1e3 / wall:.1%}), "
        f"{cells:.4g} cells ({cells / wall:.4g} cells/s, int32 bound "
        f"{bound_s:.3f} s), launches "
        f"{launches['self_join_ecg']['rows_lastrow_ban']} (chunk "
        f"{prof.chunk}); motifs {prof.motifs}, discords {prof.discords}")

    # 8 windows through the direct route, against the plain version with
    # their bans over the whole series (one plain run gives every output).
    idx = np.linspace(0, nw - 1, 8).astype(np.int64)
    s8 = prof.starts[idx]
    q8 = torch.as_tensor(series[s8[:, None] + np.arange(w)], device=dev)
    lo8, hi8 = self_join_exclusion(s8, w)
    ops.reset_launches()
    d8, st8, e8 = engine.sdtw(q8, st, excl_lo=lo8, excl_hi=hi8,
                              return_spans=True, device=dev)
    dp8, ep8 = engine.sdtw(q8, st, excl_lo=lo8, excl_hi=hi8,
                           return_positions=True, device=dev)
    torch.cuda.synchronize()
    launches["self_join_windows_ecg"] = dict(ops.LAUNCHES)
    if (launches["self_join_windows_ecg"]["rows_span_ban"] != 1
            or launches["self_join_windows_ecg"]["rows_plain_ban"] != 1):
        raise AssertionError(f"direct route missed the kernel: "
                             f"{launches['self_join_windows_ecg']}")
    raw_k = h.kernel(q8, st, track=True, lastrow=True, excl_lo=lo8,
                     excl_hi=hi8)
    raw_p = h.plain_raw(q8, st, track=True, lastrow=True, excl_lo=lo8,
                        excl_hi=hi8)
    h.record("rows_span_ban", h.compare(
        "8 self-join windows spans vs plain", (d8, e8, st8), raw_p[:3]))
    h.record("rows_plain_ban", h.compare(
        "8 self-join windows distances vs plain", (dp8, ep8), raw_p[:2]))
    h.record("rows_lastrow_ban", h.compare(
        "8 self-join windows last row vs plain", raw_k, raw_p))
    for f, got in (("nn_dist", d8), ("nn_start", st8), ("nn_end", e8)):
        if not np.array_equal(getattr(prof, f)[idx], got.cpu().numpy()):
            raise AssertionError(f"self-join {f} != the direct route")
    del raw_k, raw_p

    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer:
        whole = matrix_profile(series, w, stride=w, k=3, prune=False,
                               batch=4096, device=dev)
    wall_4096 = time.time() - t0
    _same_profile("batch 4096 vs 256", whole, prof,
                  ("starts", "nn_dist", "nn_start", "nn_end", "nn_window"))
    log(f"phase 12: 8 windows (direct route, K1 and K2 with bans) and their"
        f" last rows == plain version over the whole series, == the "
        f"profile; batch 4096 (one launch a chunk): {wall_4096:.3f} s wall, "
        f"kernel {timer.ms():.3f} ms, bitwise batch 256; k=3: motifs "
        f"{whole.motifs}, discords {whole.discords}")
    return launches, {"wall_s": wall, "kernel_ms": kernel_ms,
                      "wall_4096_s": wall_4096, "windows": nw}


def phase_self_join_long(torch, np, ops, h, series, dev):
    """Phase 12 (long windows): a self-join of 1,600-sample windows, past
    the rows kernel: the wavefront kernel's ban variants against the plain
    version. Returns its launches by path."""
    from repro_torch.core import engine
    from repro_torch.core.matsa_api import matsa
    from repro_torch.core.sdtw import self_join_exclusion
    w = 1600
    st = torch.as_tensor(series, device=dev)
    launches = {}
    ops.reset_launches()
    with NoRowScan("long self-join"):
        res = matsa(series, mode="self_join", window=w, stride=w,
                    device=dev)
        torch.cuda.synchronize()
    launches["self_join_long"] = _only(ops, "wavefront_lastrow_ban",
                                       "long self-join")
    prof = res.profile
    idx = np.unique(np.linspace(0, len(prof.starts) - 1, 4).astype(int))
    s4 = prof.starts[idx]
    q4 = torch.as_tensor(series[s4[:, None] + np.arange(w)], device=dev)
    lo4, hi4 = self_join_exclusion(s4, w)
    ops.reset_launches()
    d4, st4, e4 = engine.sdtw(q4, st, excl_lo=lo4, excl_hi=hi4,
                              return_spans=True, device=dev)
    dp4, ep4 = engine.sdtw(q4, st, excl_lo=lo4, excl_hi=hi4,
                           return_positions=True, device=dev)
    torch.cuda.synchronize()
    launches["self_join_long_windows"] = dict(ops.LAUNCHES)
    raw_k = h.kernel(q4, st, track=True, lastrow=True, excl_lo=lo4,
                     excl_hi=hi4)
    raw_p = h.plain_raw(q4, st, track=True, lastrow=True, excl_lo=lo4,
                        excl_hi=hi4)
    h.record("wavefront_span_ban", h.compare(
        "4 long windows spans vs plain", (d4, e4, st4), raw_p[:3]))
    h.record("wavefront_plain_ban", h.compare(
        "4 long windows distances vs plain", (dp4, ep4), raw_p[:2]))
    h.record("wavefront_lastrow_ban", h.compare(
        "4 long windows last row vs plain", raw_k, raw_p))
    for f, got in (("nn_dist", d4), ("nn_start", st4), ("nn_end", e4)):
        if not np.array_equal(getattr(prof, f)[idx], got.cpu().numpy()):
            raise AssertionError(f"long self-join {f} != the direct route")
    la = launches["self_join_long_windows"]
    if la["wavefront_span_ban"] != 1 or la["wavefront_plain_ban"] != 1:
        raise AssertionError(f"long windows missed the wavefront: {la}")
    log(f"phase 12: self-join of {len(prof.starts)} windows of {w} on "
        f"{len(series)} samples on the wavefront kernel "
        f"({launches['self_join_long']['wavefront_lastrow_ban']} launches "
        f"with the ban); 4 windows (K1, K2, K3 with bans) == plain version "
        f"and == the profile")
    return launches


def phase_profile_pruned(torch, np, ops, kpkg, ls_ref, dev):
    """Phase 13: the pruned profile (``matrix_profile``'s default
    ``prune=True``) of the level-shifted series at ECG's length, window
    and stride 512, k = 3; its distances against the exact profile."""
    from repro_torch.search import matrix_profile
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer, NoRowScan("pruned profile"):
        pr = matrix_profile(ls_ref, 512, stride=512, k=3, device=dev)
    wall = time.time() - t0
    launches = _only(ops, "rows_lastrow_ban", "pruned profile")
    t0 = time.time()
    exact = matrix_profile(ls_ref, 512, stride=512, k=3, prune=False,
                           batch=4096, device=dev)
    wall_exact = time.time() - t0
    _same_profile("pruned vs exact profile", pr, exact,
                  ("starts", "nn_dist"))
    if pr.chunks_pruned < 1:
        raise AssertionError("pruned profile pruned nothing")
    spans = int(((pr.nn_start == exact.nn_start)
                 & (pr.nn_end == exact.nn_end)).sum())
    log(f"phase 13: pruned matrix_profile, {len(pr.starts)} windows of 512 "
        f"on the level-shifted series: {wall:.3f} s wall, kernel "
        f"{timer.ms():.3f} ms ({timer.ms() / 1e3 / wall:.1%}), chunks "
        f"total {pr.chunks_total} pruned {pr.chunks_pruned} (kim "
        f"{pr.chunks_pruned_kim}, keogh {pr.chunks_pruned_keogh}) processed "
        f"{pr.chunks_processed}, launches {launches['rows_lastrow_ban']}; "
        f"distances == exact profile ({wall_exact:.3f} s, batch 4096; "
        f"spans equal on {spans}/{len(pr.starts)}); motifs {pr.motifs}, "
        f"discords {pr.discords}")
    return launches


def phase_stream_profile(torch, np, ops, kpkg, series, dev):
    """Phase 14: ``StreamProfile(512, stride=512, k=3)`` over the first
    262,144 samples, fed in ragged pieces with one mid-stream flush,
    against ``matrix_profile(prune=False)`` of the same prefix."""
    from repro_torch.search import matrix_profile
    from repro_torch.stream import StreamProfile
    pre = series[:262_144]
    cuts = [0, 30_000, 61_234, 100_000, 150_001, 200_000, len(pre)]
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer, NoRowScan("stream profile"):
        sp = StreamProfile(512, stride=512, k=3, device=dev)
        for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
            sp.feed(pre[a:b])
            if i == 2:
                sp.flush()
        res = sp.results()
    wall = time.time() - t0
    launches = _only(ops, "rows_lastrow_ban", "stream profile")
    want = matrix_profile(pre, 512, stride=512, k=3, prune=False,
                          device=dev)
    _same_profile("stream profile vs matrix_profile", res, want)
    log(f"phase 14: StreamProfile(512, stride=512, k=3) over {len(pre)} "
        f"samples in {len(cuts) - 1} pieces, flush after piece 3: "
        f"{wall:.3f} s wall, kernel {timer.ms():.3f} ms "
        f"({timer.ms() / 1e3 / wall:.1%}), {sp.tiles_processed} tiles, "
        f"{len(res.starts)} windows, launches {launches['rows_lastrow_ban']}"
        f"; == matrix_profile(prune=False) bitwise")
    return launches


def snap_offset(snap) -> int:
    """Samples a snapshot's session had advanced through the DP."""
    return json.loads(str(snap["meta"][()]))["offset"]


def phase_align(torch, np, ops, kpkg, human, ecg, dev):
    """Phase 11: alignment paths. Returns its launches."""
    from repro_torch.core import engine
    from repro_torch.core.traceback import check_path, path_cost
    ops.reset_launches()
    n_paths = 0
    times = {}
    for name, (q, r) in (("Human", human), ("ECG-cut", ecg)):
        t0 = time.time()
        with KernelTimer(torch, kpkg) as timer:
            res = engine.align(q, r, device=dev)
        times[name] = (f"{q.shape[0]} queries {time.time() - t0:.3f} s "
                       f"wall, kernel {timer.ms():.3f} ms")
        for i, a in enumerate(res):
            if a.path is None or not check_path(a.path, a.start, a.end,
                                                q.shape[1]):
                raise AssertionError(f"{name} query {i}: invalid path")
            if path_cost(q[i], r, a.path) != a.distance:
                raise AssertionError(f"{name} query {i}: path cost != "
                                     f"distance")
            n_paths += 1
    launches = dict(ops.LAUNCHES)
    if launches["rows_span"] < 2:
        raise AssertionError(f"align missed the kernel: {launches}")
    log(f"phase 11: align {times}: {n_paths} paths valid, each replaying "
        f"its distance bitwise; launches {launches}")
    return launches


def ptxas_summary(log_text: str):
    """``{kernel name: (registers, spill stores, spill loads)}`` from
    nvcc's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = [0, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.core import engine
    from repro_torch.core.matsa_api import (load_real_workload_shapes,
                                            matsa, synthetic_timeseries)
    from repro_torch.core.sdtw import (default_excl_zone, sdtw_chunked,
                                       topk_fold_lastrow)
    from repro_torch.core.sdtw_ref import sdtw_ref
    from repro_torch.core.topk import topk_init
    from repro_torch.kernels.sdtw import _build, ops
    from repro_torch.kernels.sdtw.sdtw import sdtw_kernel_plain

    t_start = time.time()
    dev = torch.device("cuda")
    # Phase 1: the card.
    card = smi("name,power.limit")
    log(card)
    kind = torch.cuda.get_device_name(0)
    sm_mhz = float(smi("clocks.max.sm"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = n_sm * INT32_LANES_PER_SM * sm_mhz * 1e6
    log(f"device: {kind}; {n_sm} SMs at up to {sm_mhz:.0f} MHz; int32 peak "
        f"{int32_rate / 1e12:.3f} Tops/s; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    # Phase 2: build.
    t0 = time.time()
    libs = _build.build()
    log(f"build: {sorted(libs)} in {time.time() - t0:.1f} s")
    ptxas = {}
    for lib in sorted(libs):
        summary = ptxas_summary(_build.build_log(lib))
        ptxas.update(summary)
        regs = [v[0] for v in summary.values()]
        log(f"  ptxas {lib}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers")
    for k, (reg, st, ld) in sorted(ptxas.items()):
        if st or ld:
            short = re.search(r"sdtw_(rows|wavefront)_kernel\w+?EE", k)
            log(f"  ptxas spill: {short.group(0) if short else k}: {reg} "
                f"registers, {st} bytes spill stores, {ld} bytes spill "
                f"loads")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = {lib: subprocess.run([cuobjdump, "-sass", str(path)],
                                capture_output=True, text=True, timeout=300,
                                check=True).stdout
            for lib, path in libs.items()}
    for lib, pattern, label, rows in SASS_LOOPS:
        # The rows kernel's two sweeps: the generic harvest is the one
        # with the unrolled select (more SELs) of the harvest slot.
        sweep = sorted((loop for loop in sass_loops(sass[lib], pattern)
                        if loop[1] or loop[2]), key=lambda x: x[3])
        names = (["fixed", "generic"] if len(sweep) == 2
                 else ["sweep"] * len(sweep))
        reg = next(v[0] for k, v in ptxas.items() if re.search(pattern, k))
        loops = "; ".join(
            f"{name} {x[0]} static instructions ({x[0] / rows:.2f} per "
            f"cell), cell arithmetic {x[4]}" for name, x in zip(names, sweep))
        log(f"  sass {label}: {reg} registers; steady-state loops {loops}")
    del sass

    # Phase 3: kernels against their plain versions.
    rng = np.random.default_rng(args.seed)
    h = Harness(torch, ops, sdtw_kernel_plain, dev)
    t0 = time.time()
    n_checks = phase_kernels(h, np, rng)
    log(f"phase 3: {n_checks} kernel-vs-plain checks passed in "
        f"{time.time() - t0:.1f} s (int32 and integer-valued float32 "
        f"bitwise; real-valued float32 rtol=1e-5)")
    t0 = time.time()
    n_checks = phase_bans(h, np, rng)
    log(f"phase 3: {n_checks} kernel-vs-plain checks with per-query column "
        f"bans passed in {time.time() - t0:.1f} s (bitwise)")

    # Phase 4: the main path at full size — Table V "Human".
    hw = load_real_workload_shapes()["Human"]
    nq, n, m = hw["num_queries"], hw["query_size"], hw["ref_size"]
    reference = synthetic_timeseries(rng, m)
    queries = synthetic_timeseries(rng, nq * n).reshape(nq, n)
    cells = nq * n * m
    ops.reset_launches()
    t0 = time.time()
    res = matsa(reference, queries, mode="query_filtering",
                anomaly_threshold=None)
    torch.cuda.synchronize()
    e2e_first_s = time.time() - t0
    human_launches = dict(ops.LAUNCHES)
    if human_launches["rows_plain"] < 1:
        raise AssertionError(f"matsa() did not launch the kernel: "
                             f"{human_launches}")
    d = res.distances
    if d.shape != (nq,) or d.dtype != torch.int32 or d.device.type != "cuda":
        raise AssertionError(f"unexpected result {d.shape} {d.dtype}")
    if not bool(((d >= 0) & (d < 2**29)).all()):
        raise AssertionError("distances outside [0, INT_BIG)")
    idx = rng.choice(nq, 8, replace=False)
    for i in idx:
        want = sdtw_ref(queries[i], reference)
        if float(d[i]) != want:
            raise AssertionError(f"query {i}: {int(d[i])} != oracle {want}")
    sub = slice(0, 1024)
    want = h.plain_raw(queries[sub], reference)[0]
    h.record("rows_plain", h.compare("Human 1024 queries vs plain",
                                     (d[sub],), (want,)))
    thr = float(torch.quantile(d.double(), 0.99))
    res_thr = matsa(reference, queries, anomaly_threshold=thr)
    n_anom = int(res_thr.anomalies.sum())
    log(f"phase 4: matsa(query_filtering) Human {nq}x{n} vs {m}: "
        f"{cells:.4g} cells, launches {human_launches}, first call "
        f"{e2e_first_s:.3f} s; oracle (8 queries) and plain (1024) agree; "
        f"{n_anom} anomalies above the 99th percentile {thr:.0f}")

    qt = torch.as_tensor(queries, device=dev)
    rt = torch.as_tensor(reference, device=dev)
    matsa_ms = cuda_ms(lambda: matsa(reference, queries))
    log(f"timing Human: matsa() end to end from host arrays {matsa_ms:.3f} "
        f"ms ({cells / (matsa_ms / 1e3):.4g} cells/s)")

    # Phase 5: top-K matches through the last-row capture (K3), all Human
    # queries, folded as the reference's search and stream layers fold it.
    k = 3
    zone = default_excl_zone(torch.full((nq,), n, dtype=torch.int32,
                                        device=dev))
    ops.reset_launches()
    _, lrow, lstart = ops.sdtw_cuda(qt, rt, return_spans=True,
                                    return_lastrow=True, device=dev)
    heap = topk_fold_lastrow(topk_init(nq, k, torch.int32, dev), lrow, lstart,
                             0, k, zone)
    torch.cuda.synchronize()
    topk_launches = dict(ops.LAUNCHES)
    if topk_launches["rows_lastrow"] < 1:
        raise AssertionError(f"top-K path missed the kernel: {topk_launches}")
    del lrow, lstart
    want = sdtw_chunked(qt[:64], rt, None, "abs_diff", chunk=8192, top_k=k,
                        return_spans=True)
    h.compare("top-K via last row vs chunked",
              (heap[0][:64], heap[2][:64], heap[1][:64]), want)
    raw_k = h.kernel(qt[:1024], rt, track=True, lastrow=True)
    raw_p = h.plain_raw(qt[:1024], rt, track=True, lastrow=True)
    h.record("rows_lastrow", h.compare("Human 1024 lastrow vs plain", raw_k,
                                       raw_p))
    del heap, raw_k, raw_p
    log(f"phase 5: top-{k} of {nq} Human queries via the last-row capture; "
        f"== chunked top-K on 64 queries, kernel == plain on 1024; launches "
        f"{topk_launches}")

    # Phase 6: a long reference — ECG's length, query count cut.
    ew = load_real_workload_shapes()["ECG"]
    ne, me, bq_e = ew["query_size"], ew["ref_size"], 256
    log(f"phase 6: ECG shape cut from {ew['num_queries']} to {bq_e} queries "
        f"(time limit); reference {me}, query length {ne}")
    ref_e = synthetic_timeseries(rng, me)
    q_e = synthetic_timeseries(rng, bq_e * ne).reshape(bq_e, ne)
    qe, re_ = (torch.as_tensor(q_e, device=dev),
               torch.as_tensor(ref_e, device=dev))
    ops.reset_launches()
    de, se, ee = engine.sdtw(qe, re_, return_spans=True)
    torch.cuda.synchronize()
    ecg_launches = dict(ops.LAUNCHES)
    if ecg_launches["rows_span"] < 1:
        raise AssertionError(f"ECG path missed the kernel: {ecg_launches}")
    raw_p = h.plain_raw(qe[:4], re_, track=True)
    h.record("rows_span", h.compare("ECG 4 queries vs plain",
                                    (de[:4], ee[:4], se[:4]), raw_p[:3]))
    if not bool(((de >= 0) & (de < 2**29)).all()):
        raise AssertionError("ECG distances outside [0, INT_BIG)")
    ecg_ms = cuda_ms(lambda: engine.sdtw(qe, re_, return_spans=True), reps=2)
    log(f"phase 6: engine.sdtw(spans) {ecg_ms:.3f} ms end to end, launches "
        f"{ecg_launches}; plain version agrees on 4 queries")

    # Phase 7: long queries, past the rows kernel — the wavefront kernel.
    nl, ml, bl = 5000, 4000, 8
    ref_l = synthetic_timeseries(rng, ml)
    q_l = synthetic_timeseries(rng, bl * nl).reshape(bl, nl)
    ql, rl = (torch.as_tensor(q_l, device=dev),
              torch.as_tensor(ref_l, device=dev))
    long_launches = {}
    ops.reset_launches()
    dl = matsa(ref_l, q_l).distances
    torch.cuda.synchronize()
    long_launches["wavefront_plain"] = ops.LAUNCHES["wavefront_plain"]
    h.record("wavefront_plain", h.compare(
        f"long queries N={nl} matsa vs plain", (dl,),
        h.plain_raw(ql, rl)[:1]))
    ops.reset_launches()
    dls, sls, els = engine.sdtw(ql, rl, return_spans=True)
    torch.cuda.synchronize()
    long_launches["wavefront_span"] = ops.LAUNCHES["wavefront_span"]
    h.record("wavefront_span", h.compare(
        f"long queries N={nl} spans vs plain", (dls, els, sls),
        h.plain_raw(ql, rl, track=True)[:3]))
    ops.reset_launches()
    _, lrow, lstart = ops.sdtw_cuda(ql, rl, return_spans=True,
                                    return_lastrow=True, device=dev)
    heap = topk_fold_lastrow(topk_init(bl, k, torch.int32, dev), lrow, lstart,
                             0, k, default_excl_zone(torch.full(
                                 (bl,), nl, dtype=torch.int32, device=dev)))
    torch.cuda.synchronize()
    long_launches["wavefront_lastrow"] = ops.LAUNCHES["wavefront_lastrow"]
    raw_p = h.plain_raw(ql, rl, track=True, lastrow=True)
    h.record("wavefront_lastrow", h.compare(
        f"long queries N={nl} last row vs plain", (lrow, lstart), raw_p[5:]))
    if min(long_launches.values()) < 1 or any(
            v for key, v in ops.LAUNCHES.items() if key.startswith("rows")):
        raise AssertionError(f"long queries missed the wavefront kernel: "
                             f"{long_launches}")
    del heap, lrow, lstart
    log(f"phase 7: N={nl}, {bl} queries against {ml}: matsa, spans and "
        f"top-{k} via the last row on the wavefront kernel == plain; "
        f"launches {long_launches}")

    # Phase 8: every variant of both kernels at both shapes; the plain
    # version once per variant and shape (both kernels share it), on one
    # batch of the queries (its time grows with the batch).
    variants = (("plain", False, False), ("span", True, False),
                ("lastrow", True, True))
    shapes = {"Human": (qt, rt, 16384), "ECG-cut": (qe, re_, 32)}
    times, plain_times = {}, {}
    for var, track, lastrow in variants:
        for shape, (qq, rr, batch) in shapes.items():
            cells_ = qq.shape[0] * qq.shape[1] * rr.shape[0]
            for kernel in ops.KERNELS:
                k_ms = cuda_ms(lambda: ops.sdtw_cuda(
                    qq, rr, return_spans=track, return_lastrow=lastrow,
                    device=dev, kernel=kernel),
                    reps=2 if shape == "ECG-cut" else 3)
                times[f"{kernel}_{var}", shape] = k_ms
                log(f"timing {kernel}_{var} at {shape}: kernel {k_ms:.3f} "
                    f"ms ({cells_ / (k_ms / 1e3):.4g} cells/s)")
            p_ms = cuda_ms(lambda: h.plain_raw(qq[:batch], rr, track=track,
                                               lastrow=lastrow),
                           reps=1, warmup=False)
            plain_times[var, shape] = p_ms
            log(f"timing plain version {var} at {shape}: {p_ms:.3f} ms for "
                f"one batch of {batch} of the {qq.shape[0]} queries")

    # Ragged lengths: Human K1 with every query one row shorter, so that
    # its last row is not a lane's last slot, beside full lengths.
    harvest = {"qlen = N": None,
               "qlen = N - 1": torch.full((nq,), n - 1, dtype=torch.int32,
                                          device=dev)}
    harvest_ms = {key: [] for key in harvest}
    for _ in range(2):
        for key, lens in harvest.items():
            harvest_ms[key].append(cuda_ms(lambda: ops.sdtw_cuda(
                qt, rt, lens, device=dev, kernel="rows")))
    log(f"timing rows_plain at Human by query length (runs alternated): "
        f"{harvest_ms}")

    # The ban variants at ECG-cut: each query banned on a self-join zone
    # (window 512 ± 256: 1,024 columns) spread over the reference, the
    # ranges on the card (so no launch tests them).
    ban_s = np.linspace(0, me - ne, bq_e).astype(np.int64)
    ban_lo = torch.as_tensor(np.maximum(ban_s - ne // 2, 0), dtype=torch.int32,
                             device=dev)
    ban_hi = torch.as_tensor(ban_s + ne + ne // 2, dtype=torch.int32,
                             device=dev)
    banned_cols = int((torch.clamp(ban_hi, max=me) - ban_lo).sum())
    # Each kernel's output (all queries) is held against the other's, and
    # its first 32 queries against the timed plain run.
    for var, track, lastrow in variants:
        outs = {}
        for kernel in ops.KERNELS:
            k_ms = cuda_ms(lambda: ops.sdtw_cuda(
                qe, re_, return_spans=track, return_lastrow=lastrow,
                device=dev, kernel=kernel, excl_lo=ban_lo, excl_hi=ban_hi),
                reps=2)
            times[f"{kernel}_{var}_ban", "ECG-cut"] = k_ms
            log(f"timing {kernel}_{var}_ban at ECG-cut: kernel {k_ms:.3f} ms"
                f" (without the ban {times[f'{kernel}_{var}', 'ECG-cut']:.3f}"
                f" ms)")
            outs[kernel] = h.kernel(qe, re_, track=track, lastrow=lastrow,
                                    kernel=kernel, excl_lo=ban_lo,
                                    excl_hi=ban_hi)
        pout = []
        p_ms = cuda_ms(lambda: pout.append(h.plain_raw(
            qe[:32], re_, track=track, lastrow=lastrow,
            excl_lo=ban_lo[:32], excl_hi=ban_hi[:32])), reps=1, warmup=False)
        plain_times[var + "_ban", "ECG-cut"] = p_ms
        h.compare(f"{var} with bans at ECG-cut: rows vs wavefront",
                  outs["rows"], outs["wavefront"])
        for kernel, out in outs.items():
            h.record(ops.variant(track, lastrow, kernel, True), h.compare(
                f"{kernel} {var} with bans at ECG-cut, 32 queries vs plain",
                [None if x is None else x[:32] for x in out], pout[0]))
        del outs, pout
        log(f"timing plain version {var} with bans at ECG-cut: {p_ms:.3f} ms "
            f"for one batch of 32 of the {bq_e} queries; both kernels equal "
            f"on all {bq_e} and the plain version on those 32")

    # The other Table V shapes, cut to 4,224 queries (32 warps on each of
    # 132 SMs) and a reference of at most 8e10 cells (at least 20 N
    # samples, and at most 6.4e8 last-row entries): which kernel is the
    # faster in each variant (``choose_kernel``); the two agree bitwise.
    for shape in ("Song", "Penguin", "Seismology", "Power"):
        w = load_real_workload_shapes()[shape]
        n_, b_ = w["query_size"], min(w["num_queries"], 4224)
        m_ = min(w["ref_size"], max(20 * n_, int(8e10) // (b_ * n_)),
                 int(6.4e8) // b_)
        qq = torch.as_tensor(synthetic_timeseries(rng, b_ * n_).reshape(
            b_, n_), device=dev)
        rr = torch.as_tensor(synthetic_timeseries(rng, m_), device=dev)
        for var, track, lastrow in variants:
            out, ms = {}, {}
            for kernel in ops.KERNELS:
                def run(kernel=kernel):
                    out[kernel] = _flat(ops.sdtw_cuda(
                        qq, rr, return_spans=track, return_positions=True,
                        return_lastrow=lastrow, device=dev, kernel=kernel))
                ms[kernel] = cuda_ms(run, reps=2)
            h.compare(f"{shape} {var} rows vs wavefront", out["rows"],
                      out["wavefront"])
            del out
            log(f"timing {var} at {shape} cut ({b_}x{n_} vs {m_}, R="
                f"{ops.resolve_rows(b_, n_, sms=n_sm)[1]}): rows "
                f"{ms['rows']:.3f} ms, wavefront {ms['wavefront']:.3f} ms; "
                f"rows/wavefront {ms['rows'] / ms['wavefront']:.3f}")
        del qq, rr

    # Phases 9-11: search, streaming and alignment at full width. The
    # 8-query runs use a level-shifted reference of ECG's length, where
    # far chunks bound the queries away (on ECG-cut's periodic reference
    # every chunk's envelope covers every query, so nothing prunes).
    import repro_torch.kernels.sdtw as kpkg
    ls_ref = level_shifted(np, rng, me)
    ls_q = np.stack([ls_ref[p:p + ne] for p in
                     rng.choice(me - ne, 8, replace=False)])
    ls_q = ls_q + rng.integers(-3, 4, ls_q.shape).astype(np.int32)
    ls8 = (torch.as_tensor(ls_q, device=dev),
           torch.as_tensor(ls_ref, device=dev))
    path_by = phase_search(torch, np, ops, kpkg, (qt, rt), (qe, re_, de),
                           ls8, dev)
    path_by["stream_ecg"] = phase_stream(torch, np, ops, kpkg,
                                         (qe, re_, (de, se, ee)), ls8, dev)
    path_by["align"] = phase_align(torch, np, ops, kpkg,
                                   (queries[:64], reference),
                                   (q_e[:4], ref_e), dev)

    # Phases 12-14: the self-join at ECG's length through the ban.
    sj_paths, _ = phase_self_join(torch, np, ops, kpkg, h, ref_e,
                                   int32_rate, dev)
    path_by.update(sj_paths)
    path_by.update(phase_self_join_long(torch, np, ops, h, ref_e[:100_000],
                                        dev))
    path_by["profile_pruned"] = phase_profile_pruned(torch, np, ops, kpkg,
                                                     ls_ref, dev)
    path_by["stream_profile"] = phase_stream_profile(torch, np, ops, kpkg,
                                                     ref_e, dev)
    path_by = {"matsa_human": human_launches, "topk_fold_human":
               topk_launches, "sdtw_spans_ecg": ecg_launches,
               "long_queries": long_launches, **path_by}

    def bound(b_, n_, m_, track, lastrow, banned=0):
        """Least time for the launch: ``banned`` columns (summed over the
        queries) are masked, so their cells do no arithmetic."""
        acc = 4
        byts = (b_ * n_ * acc + m_ * acc + b_ * 4          # q, r, qlens
                + 2 * (b_ * n_ * acc + b_ * 8)             # carry in + out
                + (2 * (b_ * n_ * 4 + b_ * 4) if track else 0)
                + (b_ * m_ * (acc + (4 if track else 0)) if lastrow else 0)
                + (b_ * 8 if banned else 0))               # the bans
        ops_ = ((b_ * m_ - banned) * n_
                * OPS_PER_CELL["span" if track else "plain"])
        t_bytes, t_ops = byts / HBM_BYTES_PER_S, ops_ / int32_rate
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes > t_ops else "operations")

    dims = {"Human": (nq, n, m), "ECG-cut": (bq_e, ne, me)}
    for var, track, lastrow in variants:
        for shape in shapes:
            b_ms, b_by = bound(*dims[shape], track, lastrow)
            log(f"bound {var} at {shape}: {b_ms:.3f} ms ({b_by}); rows "
                f"{times['rows_' + var, shape] / b_ms:.2f}x, wavefront "
                f"{times['wavefront_' + var, shape] / b_ms:.2f}x it")
    rows = []
    src = {"rows": "src/repro_torch/kernels/sdtw/csrc/sdtw_rows.cu",
           "wavefront": "src/repro_torch/kernels/sdtw/csrc/sdtw.cu"}
    # Launches on the path that runs the kernel (phases 4-7); times at the
    # Table V shape of the path that runs the variant at full width.
    # The ban variants: launches on the self-join paths (phase 12), times
    # at ECG-cut with self-join zones (phase 8).
    path_launches = {"rows_plain": human_launches["rows_plain"],
                     "rows_span": ecg_launches["rows_span"],
                     "rows_lastrow": topk_launches["rows_lastrow"],
                     **long_launches,
                     **{k: v for p_ in ("self_join_ecg",
                                        "self_join_windows_ecg",
                                        "self_join_long",
                                        "self_join_long_windows")
                        for k, v in path_by[p_].items()
                        if k.endswith("_ban") and v}}
    for (var, track, lastrow) in variants:
        b_ms, b_by = bound(*dims["ECG-cut"], track, lastrow, banned_cols)
        log(f"bound {var} with self-join bans at ECG-cut: {b_ms:.3f} ms "
            f"({b_by}); rows {times[f'rows_{var}_ban', 'ECG-cut'] / b_ms:.2f}x"
            f", wavefront "
            f"{times[f'wavefront_{var}_ban', 'ECG-cut'] / b_ms:.2f}x it")
    for ban in (False, True):
        for kernel in ops.KERNELS:
            for var, track, lastrow in variants:
                shape = "ECG-cut" if ban or var == "span" else "Human"
                suffix = "_ban" if ban else ""
                key = f"{kernel}_{var}{suffix}"
                b_ms, b_by = bound(*dims[shape], track, lastrow,
                                   banned_cols if ban else 0)
                rows.append({
                    "name": key, "route": "cuda", "source": src[kernel],
                    "replaces": "src/repro/kernels/sdtw/ops.py:140",
                    "launches": path_launches[key],
                    "launches_by_path": {path: c.get(key, 0)
                                         for path, c in path_by.items()},
                    "max_abs_err": h.err[key], "ms": times[key, shape],
                    "plain_ms": plain_times[var + suffix, shape],
                    "plain_queries": shapes[shape][2],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "shape": shape + (" with self-join bans" if ban else "")})
    log(f"card: {card}; total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
