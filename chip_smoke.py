#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed SEED]

Run from the root of a checkout, on a machine with a CUDA device, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA. It imports nothing of
JAX and nothing of the JAX package ``repro``. Phases, each of which raises
(and so exits non-zero) on any failed check:

  1. card identity (``nvidia-smi`` name and power limit, CUDA name);
  2. build every kernel from ``src/repro_torch/kernels/*/csrc`` with nvcc;
  3. every kernel variant against its plain PyTorch version on the card:
     int32 and float32, both metrics, plain / span / last-row, variable
     query lengths, ``ref_lead``/``ref_len`` masks, carry chaining, block
     policy invariance, N up to 1536 — int32 and integer-valued float32
     bitwise, real-valued float32 within ``rtol=1e-5``;
  4. the main path at full size: ``matsa(mode="query_filtering")`` on the
     paper's Table V "Human" workload (131,072 int32 queries of length
     120 against 7,997 samples), checked against the numpy oracle on 8
     queries and against the plain version on 1,024, bitwise;
  5. top-K matches through the last-row capture (the kernel's K3 variant
     folded by ``topk_fold_lastrow``) on all Human queries;
  6. a long reference: ``engine.sdtw(return_spans=True)`` at ECG's length
     (1,800,000 samples, queries of 512), 256 queries instead of 16,384;
  7. every variant timed with CUDA events at both shapes, kernel and
     plain version, beside its bound; then the JSON lines.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on its path, its largest difference
from the plain version, its time, the plain version's time and its bound.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

#: Peak device memory rate of an H100 SXM (NVIDIA's data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: INT32 lanes per SM on Hopper; the int32 rate is SMs × lanes × SM clock.
INT32_LANES_PER_SM = 64
#: int32 operations per DP cell of the recurrence the kernel evaluates:
#: subtract, abs (or multiply), two mins, add, saturating min; the start
#: lane adds two lexicographic mins of about four operations each.
OPS_PER_CELL = {"plain": 6, "span": 14}


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
        """The kernel's outputs as the raw tuple (best, pos, start, bcol,
        bstart, lastrow, lastrow_start)."""
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
                  ref_lead=0):
        q, r, qlens, acc = self.prep(q, r, qlens)
        if carry is None:
            carry = self.ops.kernel_carry_init(q.shape[0], q.shape[1], acc,
                                               track, self.dev)
        if track:
            bcol, bstart, best, pos, start = carry
        else:
            (bcol, best, pos), bstart, start = carry, None, None
        return self.plain(q, r, qlens, metric, bcol, best, pos, bstart, start,
                          ref_offset, ref_len, ref_lead, lastrow)

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
              lastrow=False, exact=True, **kw):
        got = self.kernel(q, r, qlens, metric, track, lastrow, **kw)
        want = self.plain_raw(q, r, qlens, metric, track, lastrow, **kw)
        worst = self.compare(name, got, want, exact)
        var = self.ops.variant(track, lastrow)
        self.err[var] = max(self.err[var], worst)
        return got


def phase_kernels(h, np, rng):
    """Phase 3: every variant against the plain version."""
    n_checks = 0
    shapes = [(3, 5, 17), (16, 120, 1000), (4, 512, 3000)]
    modes = [(False, False), (True, False), (False, True), (True, True)]
    for dtype in (np.int32, np.float32):
        for metric in ("abs_diff", "square_diff"):
            for b, n, m in shapes:
                for track, lastrow in modes:
                    q = rng.integers(-60, 60, (b, n)).astype(dtype)
                    r = rng.integers(-60, 60, m).astype(dtype)
                    qlens = rng.integers(1, n + 1, b).astype(np.int32)
                    qlens[0] = n
                    h.check(f"{dtype.__name__} {metric} {(b, n, m)} "
                            f"track={track} lastrow={lastrow}", q, r, qlens,
                            metric, track, lastrow, ref_offset=7)
                    n_checks += 1
    q = rng.integers(-60, 60, (2, 1536)).astype(np.int32)
    r = rng.integers(-60, 60, 2500).astype(np.int32)
    for track, lastrow in modes:
        h.check(f"N=1536 track={track} lastrow={lastrow}", q, r, None,
                "abs_diff", track, lastrow)
        n_checks += 1
    q = rng.integers(-60, 60, (6, 40)).astype(np.int32)
    r = rng.integers(-60, 60, 900).astype(np.int32)
    for lead, rlen in ((0, 500), (13, 900), (30, 30), (0, 0), (100, 640)):
        for track, lastrow in modes:
            h.check(f"lead={lead} len={rlen}", q, r,
                    np.array([40, 1, 17, 33, 2, 40], np.int32), "abs_diff",
                    track, lastrow, ref_offset=1000, ref_lead=lead,
                    ref_len=rlen)
            n_checks += 1
    qf = rng.normal(0, 50, (8, 64)).astype(np.float32)
    rf = rng.normal(0, 50, 2000).astype(np.float32)
    h.check("float32 real-valued (rtol=1e-5)", qf, rf, exact=False)
    n_checks += 1

    # Carry chaining: three slices through the carry == one launch.
    q = rng.integers(-60, 60, (9, 120)).astype(np.int32)
    r = rng.integers(-60, 60, 2000).astype(np.int32)
    for track in (False, True):
        whole = h.kernel(q, r, track=track)
        carry = None
        for off in range(0, 2000, 700):
            sl = np.zeros(700, np.int32)
            cl = min(700, 2000 - off)
            sl[:cl] = r[off:off + cl]
            _, carry = h.ops.sdtw_cuda(q, sl, carry=carry, ref_offset=off,
                                       ref_len=cl, return_carry=True,
                                       track_start=track, device=h.dev)
        chained = ((carry[2], carry[3], carry[4], carry[0], carry[1])
                   if track else (carry[1], carry[2], None, carry[0], None))
        h.compare(f"carry chaining track={track}", chained, whole[:5])
        n_checks += 1
    # Block-policy invariance.
    base = h.kernel(q, r, track=True)
    for bq, bm in ((1, 16), (3, 64), (8, 1024)):
        h.compare(f"block_q={bq} block_m={bm}", h.kernel(
            q, r, track=True, block_q=bq, block_m=bm), base)
        n_checks += 1
    return n_checks


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
    name = torch.cuda.get_device_name(0)
    sm_mhz = float(smi("clocks.max.sm"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = n_sm * INT32_LANES_PER_SM * sm_mhz * 1e6
    log(f"device: {name}; {n_sm} SMs at up to {sm_mhz:.0f} MHz; int32 peak "
        f"{int32_rate / 1e12:.3f} Tops/s; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    # Phase 2: build.
    t0 = time.time()
    libs = _build.build()
    log(f"build: {sorted(libs)} in {time.time() - t0:.1f} s")
    for line in _build.build_log("sdtw").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # Phase 3: kernels against their plain versions.
    rng = np.random.default_rng(args.seed)
    h = Harness(torch, ops, sdtw_kernel_plain, dev)
    t0 = time.time()
    n_checks = phase_kernels(h, np, rng)
    log(f"phase 3: {n_checks} kernel-vs-plain checks passed in "
        f"{time.time() - t0:.1f} s (int32 and integer-valued float32 "
        f"bitwise; real-valued float32 rtol=1e-5)")

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
    if human_launches["sdtw_plain"] < 1:
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
    h.err["sdtw_plain"] = max(h.err["sdtw_plain"], h.compare(
        "Human 1024 queries vs plain", (d[sub],), (want,)))
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
    if topk_launches["sdtw_lastrow"] < 1:
        raise AssertionError(f"top-K path missed the kernel: {topk_launches}")
    del lrow, lstart
    want = sdtw_chunked(qt[:64], rt, None, "abs_diff", chunk=8192, top_k=k,
                        return_spans=True)
    h.compare("top-K via last row vs chunked",
              (heap[0][:64], heap[2][:64], heap[1][:64]), want)
    raw_k = h.kernel(qt[:1024], rt, track=True, lastrow=True)
    raw_p = h.plain_raw(qt[:1024], rt, track=True, lastrow=True)
    h.err["sdtw_lastrow"] = max(h.err["sdtw_lastrow"], h.compare(
        "Human 1024 lastrow vs plain", raw_k, raw_p))
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
    if ecg_launches["sdtw_span"] < 1:
        raise AssertionError(f"ECG path missed the kernel: {ecg_launches}")
    raw_p = h.plain_raw(qe[:4], re_, track=True)
    h.err["sdtw_span"] = max(h.err["sdtw_span"], h.compare(
        "ECG 4 queries vs plain", (de[:4], ee[:4], se[:4]), raw_p[:3]))
    if not bool(((de >= 0) & (de < 2**29)).all()):
        raise AssertionError("ECG distances outside [0, INT_BIG)")
    ecg_ms = cuda_ms(lambda: engine.sdtw(qe, re_, return_spans=True), reps=2)
    log(f"phase 6: engine.sdtw(spans) {ecg_ms:.3f} ms end to end, launches "
        f"{ecg_launches}; plain version agrees on 4 queries")

    # Phase 7: every variant, kernel and plain version, at both shapes.
    variants = (("sdtw_plain", False, False), ("sdtw_span", True, False),
                ("sdtw_lastrow", True, True))
    shapes = {"Human": (qt, rt, 16384), "ECG-cut": (qe, re_, 32)}
    times = {}
    for var, track, lastrow in variants:
        for shape, (qq, rr, batch) in shapes.items():
            k_ms = cuda_ms(lambda: ops.sdtw_cuda(
                qq, rr, return_spans=track, return_lastrow=lastrow,
                device=dev), reps=2 if shape == "ECG-cut" else 3)
            p_ms = cuda_ms(lambda: [
                h.plain_raw(qq[s:s + batch], rr, track=track, lastrow=lastrow)
                for s in range(0, qq.shape[0], batch)], reps=1, warmup=False)
            cells_ = qq.shape[0] * qq.shape[1] * rr.shape[0]
            times[var, shape] = (k_ms, p_ms)
            log(f"timing {var} at {shape}: kernel {k_ms:.3f} ms "
                f"({cells_ / (k_ms / 1e3):.4g} cells/s), plain version "
                f"{p_ms:.3f} ms")

    def bound(b_, n_, m_, track, lastrow):
        acc = 4
        byts = (b_ * n_ * acc + m_ * acc + b_ * 4          # q, r, qlens
                + 2 * (b_ * n_ * acc + b_ * 8)             # carry in + out
                + (2 * (b_ * n_ * 4 + b_ * 4) if track else 0)
                + (b_ * m_ * (acc + (4 if track else 0)) if lastrow else 0))
        ops_ = b_ * n_ * m_ * OPS_PER_CELL["span" if track else "plain"]
        t_bytes, t_ops = byts / HBM_BYTES_PER_S, ops_ / int32_rate
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes > t_ops else "operations")

    dims = {"Human": (nq, n, m), "ECG-cut": (bq_e, ne, me)}
    for var, track, lastrow in variants:
        for shape in shapes:
            b_ms, b_by = bound(*dims[shape], track, lastrow)
            log(f"bound {var} at {shape}: {b_ms:.3f} ms ({b_by}); the "
                f"kernel takes {times[var, shape][0] / b_ms:.2f}x it")
    rows = []
    src_file = "src/repro_torch/kernels/sdtw/csrc/sdtw.cu"
    # Each kernel's numbers at the shape of the path that launched it.
    for (var, track, lastrow), launches, shape in zip(
            variants, (human_launches["sdtw_plain"], ecg_launches["sdtw_span"],
                       topk_launches["sdtw_lastrow"]),
            ("Human", "ECG-cut", "Human")):
        b_ms, b_by = bound(*dims[shape], track, lastrow)
        rows.append({"name": var, "route": "cuda", "source": src_file,
                     "replaces": "src/repro/kernels/sdtw/ops.py:140",
                     "launches": launches, "max_abs_err": h.err[var],
                     "ms": times[var, shape][0],
                     "plain_ms": times[var, shape][1], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "shape": shape})
    log(f"card: {card}; total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
