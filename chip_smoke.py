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
  3. the three kernels (rows, chain, wavefront), every variant, against
     their plain PyTorch version on the card (one plain run, with the
     start lane and the last row, holds every variant of an
     integer-valued input): int32 and float32, both
     metrics, plain / span / last-row, variable query lengths, R not
     dividing N, ``ref_lead``/``ref_len`` masks, carry chaining, block
     policy invariance, N up to 1536, and N = 5000 on the chain kernel and
     on the wavefront kernel in shared memory and in its global scratch —
     int32 and integer-valued float32 bitwise, real-valued float32 within
     ``rtol=1e-5``; then the ban (per-query column bans across slice
     edges, at a negative offset, empty and total), every variant,
     bitwise; then the chain kernel across several warps a query: every
     variant with and without the ban, both types and metrics, ragged
     lengths, N = 1, 33, 1,537, 4,000 and 8,192 (16 warps, its limit),
     the carry across slices with bans across their edges;
  4. the main path at full size: ``matsa(mode="query_filtering")`` on the
     paper's Table V "Human" workload (131,072 int32 queries of length
     120 against 7,997 samples), checked against the numpy oracle on 8
     queries and against the plain version on 1,024, bitwise;
  5. top-K matches through the last-row capture (the K3 variant folded by
     ``topk_fold_lastrow``) on all Human queries;
  6. a long reference: ``engine.sdtw(return_spans=True)`` at ECG's length
     (1,800,000 samples, queries of 512), 256 queries instead of 16,384;
  7. long queries through ``kernel="auto"``: ``matsa()``, spans and top-K
     through the last row at N = 5000 (the chain kernel) and N = 9000
     (past the chain kernel's 8,192: the wavefront), against the plain
     version;
  8. every variant of the three kernels timed with CUDA events at the
     Human and ECG-cut shapes beside its bound, the plain version once per
     variant and shape on one batch (16,384 Human or 32 ECG-cut queries,
     ``plain_queries`` in the JSON line); the rows kernel at Human with
     ragged lengths (its generic harvest); the three kernels, every
     variant, at the other four Table V shapes cut to 4,224 queries,
     checked equal to each other; the ban variants at ECG-cut with a
     self-join zone per query, the kernels held equal on every query and
     to the plain version on 32; the chain policy: the chain kernel at
     every R beside the policy's pick and the rows kernel, on self-join
     batches of 256 windows of 512 and 2,048, 64 queries of 4,096 and
     ECG-cut;
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
     window and stride 512 (3,515 windows, the exact profile in one
     batch, every launch the rows kernel's K3 with the ban); the profile
     again in batches of 256 (the chain kernel's K3 with the ban), timed,
     bitwise; the path's batch (2 slices of 8,192 through the carry) and
     the first 256 windows (4 slices) held against the plain version
     slice by slice; 8 windows
     through the direct route (K1 and K2 with their bans) and their last
     rows held bitwise against the plain version over the whole series;
     the direct route of every window of 120 of Human's reference
     (7,878 windows: the rows kernel's K1 and K2 bans); self-joins of
     1,600-sample windows on 100,000 samples (the chain kernel's bans)
     and of 9,000-sample windows on 40,000 (the wavefront's), 4 windows
     each against the plain version;
 13. the pruned profile (``matrix_profile``, k = 3) of the level-shifted
     series of ECG's length: its distances against the exact profile;
 14. ``StreamProfile(512, stride=512, k=3)`` over 262,144 samples, fed in
     ragged pieces with a mid-stream flush, against
     ``matrix_profile(prune=False)`` of the same prefix;
 15. long windows and queries at ECG's length on the chain kernel:
     ``matsa(mode="self_join", window=2048, stride=2048)`` (878 windows,
     the exact profile in one batch, every launch the chain kernel's K3
     with the ban), the profile again in batches of 256, timed, bitwise;
     the first batch of 256 through all 220 slices held bitwise against
     the wavefront kernel, the path's batch over 2 slices and 4 windows
     against the plain
     version over the whole series, motifs and discords against the
     distances; ``engine.sdtw(return_spans=True)`` of 64 queries of
     4,096 against the whole series on the chain kernel and on the
     wavefront, timed, bitwise equal;
 16. the autotuner: the shipped ``h100.json``; at each main shape (Human,
     ECG-cut, the self-join's batches of 256 windows of 512 and 2,048
     against a slice of 8,192, 64 × 4,096, the Table V shapes cut as in
     phase 8) the ``tune='off'`` and ``tune='model'`` launches, each
     timed, the model's within 5 % of the hand-set one or faster, the
     answers bitwise equal under off/model/measure; ``tune='measure'`` on
     a small bucket lands in the process table;
 17. the serving tier: a warmed ``Router`` serves Human at full width
     (64 requests of 2,048 from 8 client threads) in fewer dispatches than
     requests, every answer bitwise the client's offline call on the
     card, with latency percentiles and the batcher's host share of one
     window; 8 ``search_topk`` requests of ECG-cut queries in one dispatch
     and a stream fed through ``open_stream``/``feed``, each bitwise the
     offline call; ``python -m repro_torch.serve``;
 18. the sharded engine and stream sessions on ``torch.distributed``
     (one card holds one NCCL rank only, so this shows the protocol and
     its answers, not scaling): ``matsa(mesh=get_mesh())`` on Human at
     full width through one NCCL rank, bitwise phase 4's, timed beside
     it; a sharded ECG-cut stream at world 1, fed 18 pieces of 100,000
     with a snapshot after piece 9 restored through ``restore(mesh=)``,
     bitwise phase 10's; then 4 gloo ranks on the card (spawned; carries
     staged through the host) on meshes (1, 4) and (2, 2):
     ``engine.sdtw(mesh=, top_k=3, return_spans=True)`` with an
     ``n_micro`` sweep, ``search_topk(k=3, mesh=, prune=False)`` and the
     sharded stream with snapshot and restore at world 4, every rank's
     answers bitwise phases 6, 9 and 10, the kernel's K3 launched on
     every rank and no plain schedule run;
 19. the LM serving path (``repro_torch.models``, plain PyTorch, no
     kernel of its own): each family's 2-layer cut at full width
     (llama3.2-1b, granite-moe-1b-a400m, mamba2-780m; zamba2-2.7b at one
     group of 6) against the CPU at fp32 with the same weights, 2 prompts
     of 32 and 4 decode steps; then the ten configurations at full width
     — full depth for the six whose fp32 master and bf16 compute copy fit
     the card, 4 layers for phi3-medium-14b, qwen3-moe-30b-a3b,
     qwen1.5-32b and granite-34b — each built from a seeded generator on
     the card, prefill's last logits against ``forward``'s at fp32, then 8
     prompts of 512 and 64 greedy decode steps in bf16, timed (prefill
     ms, decode ms a step, tokens/s, peak memory) beside their bounds;
     llama3.2-1b's prompts come from ``TSAFilteredLM``, whose sDTW filter
     runs the kernel (path ``lm_tsa_filter``);
 20. the LM training path (``repro_torch.train``, ``optim``,
     ``checkpoint``, ``ft``, ``launch.train``; no kernel of its own):
     (a) one fp32 train step of llama3.2-1b and granite-moe-1b-a400m cut
     to 2 layers at full width on the card and on the CPU with the same
     weights (loss, grad norm, every gradient leaf); (b) llama3.2-1b at
     full width and depth built by ``launch.train.build`` with
     ``--data tsa`` (bf16, ``remat="full"``, 8 × 512 tokens), one warm-up
     and 8 timed steps (step ms, tokens/s, peak memory, the first and
     last loss beside the step's bound), the AdamW update timed beside
     its bound, the filter's K1 launches the path ``lm_train_tsa_filter``;
     (c) a ``TrainingRunner`` with an injected failure against an
     uninterrupted run on the two 2-layer cuts, bitwise (checkpoint save
     and restore seconds and bytes); (d) one timed step of each other
     config that phase 19 ran at full depth, at half its depth (the
     script's time limit);
 21. the sharded LM (``distributed.Axes``, DTensor state from
     ``launch.specs.tree_shardings``, the MoE's expert parallelism,
     ``compressed_psum``, GPipe, the elastic restore; no kernel of its
     own): (a) one NCCL rank, llama3.2-1b at full width and depth through
     the sharded code path on a (1, 1) ``("data", "model")`` mesh, its
     first step against the unsharded step from the same state and batch
     (bitwise), then 3 timed steps (step ms, host ms to enqueue a step,
     peak memory beside the bound), the filter's launches the path
     ``lm_train_sharded_filter``; (b) 4 gloo ranks sharing the card, 2
     layers at full width in fp32: llama3.2-1b's loss on (2, 2) against
     the card's unsharded loss; granite-moe-1b-a400m's train state on
     (2, 2), its a2a and replicated MoE paths on those sharded weights
     against the local one, a step, a checkpoint restored onto (4, 1)
     and a step; phi3-medium-14b with ``pad_heads`` on (1, 4);
     ``compressed_psum`` against the numpy two-phase formula (bitwise);
     GPipe over 4 stages against the sequential run (the ranks route
     gloo's functional all-gather of CUDA tensors through the host,
     ``stage_gloo_all_gather``); phases 20 and 21 print ``mfu``
     (``launch.roofline.model_flops`` over the step time at the bf16
     peak) beside their bound share;
 22. the dry run (``repro_torch.launch.{roofline,specs,dryrun}``): (a)
     a subprocess on a fake world of 1 with fake CUDA tensors counts
     phase 20's llama3.2-1b cell (16 layers, 8 × 512, bf16, remat full,
     dense attention, mesh (1, 1)): flops and live bytes; (b) one more
     real step on phase 20's state under ``FlopCounterMode`` with the
     peak reset: its flops must equal (a)'s, and its peak be within
     ``DRYRUN_MEM_RTOL`` of (a)'s live bytes; (c) ``mfu`` of phase 20's
     median step; (d) ``python -m repro_torch.launch.dryrun --arch
     llama3.2-1b --shape train_4k --acct extrapolated`` with its default
     device (fake CUDA tensors on a fake world of 256), its record
     printed; then the JSON lines.

Every path runs on ``kernel="auto"``'s choice under the engine's default
``tune='model'`` (the shipped tuning table, else the cost model, which
keeps the hand-set launch at every shape checked below): the rows kernel for
Human's 131,072 queries and every batch of at least 12 queries an SM
(phases 4, 5, 9, 11, 12), the chain kernel for smaller batches of
longer queries (ECG-cut's 256 in phases 6 and 9-11, the self-join's
batches of 256 windows in 12-14 and of 878 in 15) and past N = 1,536
(phases 7, 12, 15), the wavefront past 8,192 (phases 7, 12); each path
reads the launch counts set to 0 just before it
(``launches_by_path`` in the JSON line; ``launches`` sums them), and the
script fails if a kernel variant was launched on no path.
The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel variant — with and without the ban — with its launches
on the paths, its largest difference from the plain version, its time,
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
import tempfile
import time



def h100(key: str) -> float:
    """A rate of one H100 SXM from ``repro_torch.launch.roofline.H100``
    (NVIDIA's data sheet): ``"peak_flops"`` (dense bf16, op/s),
    ``"hbm_bw"`` (bytes/s)."""
    from repro_torch.launch.roofline import H100
    return H100[key]


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
#: loop iteration). Rows and chain kernels: <T, TRACK, SQUARE, R, BAN>;
#: wavefront:
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
    ("sdtw_chain", r"sdtw_chain_kernelIiLb0ELb0ELi4ELb0EE",
     "chain K1 R=4 (ECG-cut)", 4),
    ("sdtw_chain", r"sdtw_chain_kernelIiLb1ELb0ELi4ELb0EE",
     "chain K2/K3 R=4 (ECG-cut)", 4),
    ("sdtw_chain", r"sdtw_chain_kernelIiLb1ELb0ELi4ELb1EE",
     "chain K2/K3 R=4 with the ban (self-join, window 512)", 4),
    ("sdtw_chain", r"sdtw_chain_kernelIiLb1ELb0ELi8ELb0EE",
     "chain K2 R=8 (4,096-sample spans)", 8),
    ("sdtw_chain", r"sdtw_chain_kernelIiLb1ELb0ELi8ELb1EE",
     "chain K2/K3 R=8 with the ban (self-join, window 2,048)", 8),
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


def reps_for(kernel: str, reps: int) -> dict:
    """``cuda_ms`` arguments for a timing in phase 8: ``reps`` runs after a
    warm-up, one run for the wavefront kernel (3-9× the others' time, its
    instantiations launched in phase 3 already; its times vary by under
    0.1 % between runs), which keeps the script within its time limit."""
    return (dict(reps=1, warmup=False) if kernel == "wavefront"
            else dict(reps=reps))


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

    def check_modes(self, name, q, r, qlens=None, metric="abs_diff",
                    modes=(), kernel="chain", configs=None, **kw):
        """Every (track, lastrow) variant of every kernel configuration
        (``(kernel, launch kwargs)`` pairs; default ``kernel`` with its
        policy) against one run of the plain version with the start lane
        and the last row, whose outputs hold every variant's
        (integer-valued inputs: the values do not depend on the start
        lane). Returns the number of comparisons."""
        want = self.plain_raw(q, r, qlens, metric, True, True, **kw)
        ban = kw.get("excl_lo") is not None
        configs = configs or [(kernel, {})]
        for kern, launch in configs:
            for track, lastrow in modes:
                got = self.kernel(q, r, qlens, metric, track, lastrow,
                                  kernel=kern, **launch, **kw)
                self.record(self.ops.variant(track, lastrow, kern, ban),
                            self.compare(
                                f"{kern} {launch} {name} track={track} "
                                f"lastrow={lastrow}", got,
                                [None if g is None else w
                                 for g, w in zip(got, want)]))
        return len(modes) * len(configs)

    def record(self, var, worst):
        self.err[var] = max(self.err[var], worst)


def phase_kernels(h, np, rng):
    """Phase 3: every variant of the three kernels against the plain
    version, which runs once per input (integer-valued inputs: one run
    with the start lane and the last row holds every variant's outputs)."""
    n_checks = 0
    shapes = [(3, 5, 17), (16, 120, 1000), (5, 200, 900), (4, 512, 3000)]
    modes = [(False, False), (True, False), (False, True), (True, True)]
    every = [(k, {}) for k in h.ops.KERNELS]
    for dtype in (np.int32, np.float32):
        for metric in ("abs_diff", "square_diff"):
            for b, n, m in shapes:
                q = rng.integers(-60, 60, (b, n)).astype(dtype)
                r = rng.integers(-60, 60, m).astype(dtype)
                qlens = rng.integers(1, n + 1, b).astype(np.int32)
                qlens[0] = n
                n_checks += h.check_modes(
                    f"{dtype.__name__} {metric} {(b, n, m)}", q, r, qlens,
                    metric, modes, configs=every, ref_offset=7)
    q = rng.integers(-60, 60, (2, 1536)).astype(np.int32)
    r = rng.integers(-60, 60, 2500).astype(np.int32)
    n_checks += h.check_modes("N=1536", q, r, None, "abs_diff", modes,
                              configs=every)
    # The rows kernel at every R (the policy picks R at N = 32·R - 3, which
    # R does not divide for R > 1), with a query ending on a lane's last
    # slot, one elsewhere and one with no last row.
    for rows in h.ops.ROWS_PER_LANE:
        n = 32 * rows - 3
        q = rng.integers(-60, 60, (4, n)).astype(np.int32)
        r = rng.integers(-60, 60, 700).astype(np.int32)
        n_checks += h.check_modes(
            f"R={rows} N={n}", q, r, np.array([n, rows, n - 1, 0], np.int32),
            "abs_diff", modes, kernel="rows")
    # N = 5000 on the wavefront kernel (shared memory, then global
    # scratch) and on the chain kernel (10 warps of R = 16).
    q = rng.integers(-60, 60, (3, 5000)).astype(np.int32)
    r = rng.integers(-60, 60, 600).astype(np.int32)
    n_checks += h.check_modes(
        "N=5000", q, r, np.array([5000, 4321, 1], np.int32), "abs_diff",
        modes, configs=[("wavefront", {}), ("wavefront", dict(block_q=2)),
                        ("chain", {})])
    q = rng.integers(-60, 60, (6, 40)).astype(np.int32)
    r = rng.integers(-60, 60, 900).astype(np.int32)
    for lead, rlen in ((0, 500), (13, 900), (30, 30), (0, 0), (100, 640)):
        n_checks += h.check_modes(
            f"lead={lead} len={rlen}", q, r,
            np.array([40, 1, 17, 33, 2, 40], np.int32), "abs_diff", modes,
            configs=every, ref_offset=1000, ref_lead=lead, ref_len=rlen)
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
                           ("rows", dict(block_q=8)), ("chain", {}),
                           ("chain", dict(block_q=1)),
                           ("chain", dict(block_q=9))):
        h.compare(f"{kernel} {launch}", h.kernel(
            q, r, track=True, kernel=kernel, **launch), base)
        n_checks += 1
    return n_checks


def phase_chain(h, np, rng):
    """Phase 3 (the chain kernel): queries across several warps of a block
    against the plain version — every variant with and without the ban,
    int32 and float32, both metrics, ragged lengths (last rows in every
    warp, none at all), N not a multiple of 32·R, N = 1, 33 and 1,537,
    4,000 (16 warps of R = 8) and CHAIN_MAX_N (16 warps of R = 16), and
    the carry chained across slices with bans across their edges."""
    n_checks = 0
    modes = [(False, False), (True, False), (False, True), (True, True)]
    for dtype, metric in ((np.int32, "abs_diff"), (np.int32, "square_diff"),
                          (np.float32, "abs_diff"),
                          (np.float32, "square_diff")):
        b, n, m, off = 6, 600, 700, 300
        q = rng.integers(-60, 60, (b, n)).astype(dtype)
        r = rng.integers(-60, 60, m).astype(dtype)
        qlens = np.array([n, n - 1, 129, 128, 1, 0], np.int32)
        lo, hi = bans_for(np, rng, b, off, off + m)
        for bans in ({}, dict(excl_lo=lo, excl_hi=hi)):
            n_checks += h.check_modes(
                f"{dtype.__name__} {metric} N={n} ban={bool(bans)}", q, r,
                qlens, metric, modes, ref_offset=off, ref_lead=5,
                ref_len=m - 7, **bans)
    # The largest blocks check K1 and K3 with the start lane (every line
    # of the sweep), without the ban at N = 4000 and with it at 8192.
    for b, n, m, banned in ((3, 1, 200, None), (3, 33, 300, None),
                            (3, 1537, 400, None), (2, 4000, 300, False),
                            (2, h.ops.CHAIN_MAX_N, 200, True)):
        q = rng.integers(-60, 60, (b, n)).astype(np.int32)
        r = rng.integers(-60, 60, m).astype(np.int32)
        qlens = np.array([n, max(1, n - 1), max(1, n // 3)][:b], np.int32)
        lo, hi = bans_for(np, rng, b, 0, m)
        for bans in ({}, dict(excl_lo=lo, excl_hi=hi)):
            if banned is None or banned == bool(bans):
                n_checks += h.check_modes(
                    f"N={n} ban={bool(bans)}", q, r, qlens, "abs_diff",
                    modes if banned is None else (modes[0], modes[3]),
                    **bans)
    # The carry across three slices with bans across their edges == one
    # launch, at 1,700 rows (R = 4, 14 warps).
    q = rng.integers(-60, 60, (7, 1700)).astype(np.int32)
    r = rng.integers(-60, 60, 2000).astype(np.int32)
    lo, hi = bans_for(np, rng, 7, 0, 2000)
    for track in (False, True):
        whole = h.kernel(q, r, track=track, kernel="chain", excl_lo=lo,
                         excl_hi=hi)
        carry = None
        for off in range(0, 2000, 700):
            sl = np.zeros(700, np.int32)
            cl = min(700, 2000 - off)
            sl[:cl] = r[off:off + cl]
            _, carry = h.ops.sdtw_cuda(q, sl, carry=carry, ref_offset=off,
                                       ref_len=cl, return_carry=True,
                                       track_start=track, device=h.dev,
                                       kernel="chain", excl_lo=lo,
                                       excl_hi=hi)
        chained = ((carry[2], carry[3], carry[4], carry[0], carry[1])
                   if track else (carry[1], carry[2], None, carry[0], None))
        h.compare(f"chain ban carry chaining track={track}", chained,
                  whole[:5])
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
    """Phase 3 (the ban): every variant of the three kernels with
    per-query column bans against the plain version with the same bans
    (one plain run per integer-valued input holds every variant)."""
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
            n_checks += h.check_modes(
                f"ban {dtype.__name__} {metric} {(b, n, m)} offset={off}",
                q, r, qlens, metric, modes,
                configs=[(k, {}) for k in h.ops.KERNELS], ref_offset=off,
                ref_lead=lead, ref_len=rlen, excl_lo=lo, excl_hi=hi)
    # N = 1536 (the rows kernel's last R) and N = 5000 (the wavefront in
    # shared memory and in its global scratch), K1 and K3 with the start
    # lane (every line of the ban is in both).
    for n, m, configs in ((1536, 2500, None),
                          (5000, 600, [("wavefront", {}),
                                       ("wavefront", dict(block_q=2)),
                                       ("chain", {})])):
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
    if launches["search_ecg"]["chain_lastrow"] < 1:
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
    """Phase 10: a streaming session at ECG-cut. Returns its launches and
    its results (top-3 with spans, the whole reference)."""
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
    if s.impl != "pallas" or launches["chain_lastrow"] < 1:
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
    return launches, res


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


def _batch_vs_plain(torch, np, ops, h, st, starts, w, c, nsl, key, name):
    """The windows at ``starts`` as one batch of ``_kernel_topk_scan``
    launches it: with their bans, slices of ``c`` columns through the
    carry, the kernel ``"auto"`` picks for the batch (``key``, every
    launch) held against the plain version slice by slice (each on its
    own carry) over the first ``nsl`` slices. Returns the seconds."""
    from repro_torch.core.sdtw import self_join_exclusion
    qb = st[torch.as_tensor(starts[:, None] + np.arange(w), device=st.device)]
    lob, hib = (x.to(st.device) for x in self_join_exclusion(starts, w))
    kc = pc = None
    ops.reset_launches()
    t0 = time.time()
    for off in range(0, nsl * c, c):
        kw_ = dict(track=True, lastrow=True, ref_offset=off, ref_len=c,
                   excl_lo=lob, excl_hi=hib)
        got = h.kernel(qb, st[off:off + c], carry=kc, **kw_)
        ref = h.plain_raw(qb, st[off:off + c], carry=pc, **kw_)
        h.record(key, h.compare(f"{name}, slice at {off}", got, ref))
        kc = (got[3], got[4], got[0], got[1], got[2])
        pc = (ref[3], ref[4], ref[0], ref[1], ref[2])
    if _only(ops, key, name)[key] != nsl:
        raise AssertionError(f"{name}: {nsl} launches of {key} expected")
    return time.time() - t0


def phase_self_join(torch, np, ops, kpkg, h, series, int32_rate, dev):
    """Phase 12: ``matsa(mode='self_join')`` at ECG's length — window 512
    (ECG's Table V query length), stride 512, the exact profile in the
    path's batches (``profile_batch``: all 3,515 windows in one), that
    batch and the first 256 windows against the plain version slice by
    slice — then 8 of its windows through the direct route (``engine.sdtw`` with their
    bans) against the plain version over the whole series, and the same
    profile timed in batches of 256. Returns the launches by path and the
    timings."""
    from repro_torch.core import engine
    from repro_torch.core.matsa_api import matsa
    from repro_torch.core.sdtw import self_join_exclusion
    from repro_torch.search import matrix_profile
    from repro_torch.search.profile import profile_batch
    w = 512
    st = torch.as_tensor(series, device=dev)
    # "auto" at 256 windows (a batch of 256) and at 8: the chain kernel,
    # whose 4 warps a window fill the card where one warp does not.
    kern = ops.choose_kernel(w, "auto", 256, ops.sm_count(0))
    if kern != ops.choose_kernel(w, "auto", 8, ops.sm_count(0)):
        raise AssertionError("a batch of 256 and one of 8 windows of 512 "
                             "run on different kernels")
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
    n_chunks = -(-len(series) // prof.chunk)
    batch = profile_batch(nw, w, prof.chunk, exact_kernel=True)
    path_kern = ops.choose_kernel(w, "auto", batch, ops.sm_count(0))
    want = -(-nw // batch) * n_chunks
    launches["self_join_ecg"] = _only(ops, f"{path_kern}_lastrow_ban",
                                      "self-join")
    if launches["self_join_ecg"][f"{path_kern}_lastrow_ban"] != want:
        raise AssertionError(f"self-join: {want} launches expected")
    d = res.distances
    if d.shape != (nw,) or d.dtype != torch.int32 or d.device != st.device:
        raise AssertionError(f"self-join: unexpected result {d.shape} "
                             f"{d.dtype} on {d.device}")
    if not prof.valid.all() or not (prof.nn_dist < 2**29).all():
        raise AssertionError("self-join: a window without a neighbour")

    # The path's batch (every window, on the rows kernel) over 2 slices
    # and the first 256 windows (the chain kernel) over 4, against the
    # plain version slice by slice (its time grows with the columns).
    c = prof.chunk
    for nb, nsl, k_ in ((nw, 2, path_kern), (min(256, nw), 4, kern)):
        sec = _batch_vs_plain(torch, np, ops, h, st, prof.starts[:nb], w, c,
                              nsl, f"{k_}_lastrow_ban",
                              f"self-join batch of {nb}")
        log(f"phase 12: one batch of {nb} ({k_} kernel, windows with their "
            f"bans, {nsl} slices of {c} through the carry) == plain version "
            f"slice by slice, every output ({sec:.1f} s)")
    cells = nw * w * len(series)
    bound_s = cells * OPS_PER_CELL["span"] / int32_rate
    log(f"phase 12: matsa(self_join) window {w} stride {w} on {len(series)}"
        f" samples: {nw} windows in batches of {batch}, {wall:.3f} s wall, "
        f"kernel {kernel_ms:.3f} ms ({kernel_ms / 1e3 / wall:.1%}), "
        f"{cells:.4g} cells ({cells / wall:.4g} cells/s, int32 bound "
        f"{bound_s:.3f} s), launches {want} {path_kern} K3 (chunk "
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
    if (launches["self_join_windows_ecg"][f"{kern}_span_ban"] != 1
            or launches["self_join_windows_ecg"][f"{kern}_plain_ban"] != 1):
        raise AssertionError(f"direct route missed the kernel: "
                             f"{launches['self_join_windows_ecg']}")
    raw_k = h.kernel(q8, st, track=True, lastrow=True, excl_lo=lo8,
                     excl_hi=hi8)
    raw_p = h.plain_raw(q8, st, track=True, lastrow=True, excl_lo=lo8,
                        excl_hi=hi8)
    h.record(f"{kern}_span_ban", h.compare(
        "8 self-join windows spans vs plain", (d8, e8, st8), raw_p[:3]))
    h.record(f"{kern}_plain_ban", h.compare(
        "8 self-join windows distances vs plain", (dp8, ep8), raw_p[:2]))
    h.record(f"{kern}_lastrow_ban", h.compare(
        "8 self-join windows last row vs plain", raw_k, raw_p))
    for f, got in (("nn_dist", d8), ("nn_start", st8), ("nn_end", e8)):
        if not np.array_equal(getattr(prof, f)[idx], got.cpu().numpy()):
            raise AssertionError(f"self-join {f} != the direct route")
    del raw_k, raw_p

    # The same profile in batches of 256, the default before the path
    # sized its batch: the chain kernel, a launch a chunk a batch.
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer:
        small = matrix_profile(series, w, stride=w, prune=False, batch=256,
                               device=dev)
        torch.cuda.synchronize()
    wall_256 = time.time() - t0
    launches["self_join_ecg_256"] = _only(ops, f"{kern}_lastrow_ban",
                                          "self-join batch 256")
    if launches["self_join_ecg_256"][f"{kern}_lastrow_ban"] != (
            -(-nw // 256) * n_chunks):
        raise AssertionError("self-join batch 256: a launch a chunk a "
                             "batch expected")
    _same_profile(f"batch {batch} vs 256", prof, small)
    log(f"phase 12: 8 windows (direct route, K1 and K2 with bans) and their"
        f" last rows == plain version over the whole series, == the "
        f"profile; batch 256 ({kern} kernel, "
        f"{launches['self_join_ecg_256'][f'{kern}_lastrow_ban']} launches):"
        f" {wall_256:.3f} s wall, kernel {timer.ms():.3f} ms, bitwise "
        f"batch {batch} ({wall_256 / wall:.2f}x its wall)")
    return launches, {"wall_s": wall, "kernel_ms": kernel_ms,
                      "wall_256_s": wall_256, "windows": nw}


def phase_self_join_direct(torch, np, ops, h, series, w, dev):
    """Phase 12 (a full batch through the direct route): every window of
    ``w`` samples of ``series`` at stride 1 against the series, through
    ``engine.sdtw`` with the self-join bans — distances (K1) and spans
    (K2) on the rows kernel's ban instantiations, a batch that fills the
    card with one warp a window — held against the plain version on 64
    windows. Returns its launches by path."""
    from repro_torch.core import engine
    from repro_torch.core.sdtw import self_join_exclusion
    s = np.arange(len(series) - w + 1)
    st = torch.as_tensor(series, device=dev)
    q = torch.as_tensor(series[s[:, None] + np.arange(w)], device=dev)
    lo, hi = self_join_exclusion(s, w)
    ops.reset_launches()
    d, e = engine.sdtw(q, st, excl_lo=lo, excl_hi=hi, return_positions=True,
                       device=dev)
    launches = {"self_join_direct_human": _only(
        ops, "rows_plain_ban", "Human self-join distances")}
    ops.reset_launches()
    d2, s2, e2 = engine.sdtw(q, st, excl_lo=lo, excl_hi=hi,
                             return_spans=True, device=dev)
    launches["self_join_direct_human_spans"] = _only(
        ops, "rows_span_ban", "Human self-join spans")
    if not (torch.equal(d, d2) and torch.equal(e, e2)):
        raise AssertionError("Human self-join: K1 and K2 disagree")
    sub = np.linspace(0, len(s) - 1, 64).astype(np.int64)
    want = h.plain_raw(q[sub], st, track=True, excl_lo=lo[sub],
                       excl_hi=hi[sub])
    h.record("rows_span_ban", h.compare("Human self-join 64 windows spans",
                                        (d2[sub], e2[sub], s2[sub]),
                                        want[:3]))
    h.record("rows_plain_ban", h.compare(
        "Human self-join 64 windows distances", (d[sub], e[sub]), want[:2]))
    log(f"phase 12: direct self-join of {len(s)} windows of {w} (stride 1) "
        f"on {len(series)} samples: K1 and K2 with bans on the rows kernel, "
        f"equal; 64 windows == plain version")
    return launches


def chain_sweep(torch, np, ops, series, ecg, sms, dev):
    """Phase 8 (the chain policy): the chain kernel at every R it is built
    for (forced by replacing ``ops.resolve_chain`` for the call) beside
    the policy's own pick and, where it takes the query, the rows kernel:
    one self-join batch of 256 windows of 512 and of 2,048 (the first
    8,192 columns, K3 with the bans), 64 queries of 4,096 (262,144
    columns, K2) and ECG-cut K3. Returns ``{case: {config: ms}}``."""
    from repro_torch.core.sdtw import self_join_exclusion
    st = torch.as_tensor(series, device=dev)
    cases = {}
    for w in (512, 2048):
        s_b = np.arange(256) * w
        qb = torch.as_tensor(series[s_b[:, None] + np.arange(w)], device=dev)
        lo, hi = (x.to(dev) for x in self_join_exclusion(s_b, w))
        cases[f"self-join batch of 256 windows of {w}, K3 with bans"] = (
            qb, st[:8192], dict(return_spans=True, return_lastrow=True,
                                excl_lo=lo, excl_hi=hi))
    s64 = np.linspace(0, len(series) - 4096, 64).astype(np.int64)
    cases["64 queries of 4,096 against 262,144, K2"] = (
        torch.as_tensor(series[s64[:, None] + np.arange(4096)], device=dev),
        st[:262_144], dict(return_spans=True))
    cases["ECG-cut, K3"] = ecg + (dict(return_spans=True,
                                       return_lastrow=True),)
    real, out = ops.resolve_chain, {}
    for name, (qq, rr, kw) in cases.items():
        b, n = qq.shape
        ms = {}
        for rows in ops.CHAIN_ROWS:
            warps = -(-n // (32 * rows))
            if warps > ops.CHAIN_MAX_WARPS:
                continue
            ops.resolve_chain = lambda *a, w=warps, r=rows, **k: (w, r, 1)
            try:
                ms[f"chain R={rows} W={warps}"] = cuda_ms(
                    lambda: ops.sdtw_cuda(qq, rr, device=dev, kernel="chain",
                                          **kw), reps=2)
            finally:
                ops.resolve_chain = real
        if n <= ops.ROWS_MAX_N:
            ms["rows"] = cuda_ms(lambda: ops.sdtw_cuda(
                qq, rr, device=dev, kernel="rows", **kw), reps=2)
        out[name] = ms
        log(f"chain policy: {name} ({b}x{n} vs {rr.shape[0]}): pick (W, R, "
            f"queries a block) {real(b, n, sms=sms)}; "
            + ", ".join(f"{c} {t:.3f} ms" for c, t in ms.items()))
    return out


def phase_self_join_long(torch, np, ops, h, series, w, kernel, dev):
    """Phase 12 (long windows): a self-join of ``w``-sample windows, past
    the rows kernel, through ``kernel`` (``"auto"``'s choice at ``w``):
    its ban variants against the plain version. Returns its launches by
    path."""
    from repro_torch.core import engine
    from repro_torch.core.matsa_api import matsa
    from repro_torch.core.sdtw import self_join_exclusion
    st = torch.as_tensor(series, device=dev)
    launches = {}
    path = f"self_join_{w}"
    ops.reset_launches()
    with NoRowScan("long self-join"):
        res = matsa(series, mode="self_join", window=w, stride=w,
                    device=dev)
        torch.cuda.synchronize()
    launches[path] = _only(ops, f"{kernel}_lastrow_ban", f"self-join {w}")
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
    launches[path + "_windows"] = la = dict(ops.LAUNCHES)
    if (la[f"{kernel}_span_ban"] != 1 or la[f"{kernel}_plain_ban"] != 1
            or sum(la.values()) != 2):
        raise AssertionError(f"long windows missed the {kernel} kernel: "
                             f"{la}")
    raw_k = h.kernel(q4, st, track=True, lastrow=True, excl_lo=lo4,
                     excl_hi=hi4, kernel=kernel)
    raw_p = h.plain_raw(q4, st, track=True, lastrow=True, excl_lo=lo4,
                        excl_hi=hi4)
    h.record(f"{kernel}_span_ban", h.compare(
        f"4 windows of {w} spans vs plain", (d4, e4, st4), raw_p[:3]))
    h.record(f"{kernel}_plain_ban", h.compare(
        f"4 windows of {w} distances vs plain", (dp4, ep4), raw_p[:2]))
    h.record(f"{kernel}_lastrow_ban", h.compare(
        f"4 windows of {w} last row vs plain", raw_k, raw_p))
    for f, got in (("nn_dist", d4), ("nn_start", st4), ("nn_end", e4)):
        if not np.array_equal(getattr(prof, f)[idx], got.cpu().numpy()):
            raise AssertionError(f"self-join {w}: {f} != the direct route")
    log(f"phase 12: self-join of {len(prof.starts)} windows of {w} on "
        f"{len(series)} samples on the {kernel} kernel "
        f"({launches[path][f'{kernel}_lastrow_ban']} launches with the "
        f"ban); 4 windows (K1, K2, K3 with bans) == plain version and == "
        f"the profile")
    return launches


def phase_long_windows(torch, np, ops, kpkg, h, series, int32_rate, dev):
    """Phase 15: the chain kernel's full-width paths at ECG's length.
    ``matsa(mode="self_join", window=2048, stride=2048)`` (the exact
    profile in the path's batches, ``profile_batch``: all 878 windows in
    one; every launch the chain kernel's K3 with the ban), the same
    profile timed in batches of 256, the first batch of 256 through all
    slices against the wavefront kernel, the path's batch over 2 slices
    against the plain version, 4 of its windows against it over the whole
    series, its motifs and discords against
    its distances; then ``engine.sdtw(return_spans=True)`` of 64 queries
    of 4,096 against the whole series on both long-query kernels, timed
    and held bitwise. Returns the launches by path and the timings."""
    from repro_torch.core import engine
    from repro_torch.core.matsa_api import matsa
    from repro_torch.core.sdtw import self_join_exclusion
    from repro_torch.search import matrix_profile
    from repro_torch.search.profile import profile_batch
    w, m = 2048, len(series)
    st = torch.as_tensor(series, device=dev)
    launches, out = {}, {}
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer, NoRowScan("self-join 2048"):
        res = matsa(series, mode="self_join", window=w, stride=w, device=dev)
        torch.cuda.synchronize()
    out["self_join_s"] = wall = time.time() - t0
    out["self_join_kernel_ms"] = kernel_ms = timer.ms()
    prof = res.profile
    nw = len(prof.starts)
    launches["self_join_2048_ecg"] = _only(ops, "chain_lastrow_ban",
                                           "self-join 2048")
    n_launch = launches["self_join_2048_ecg"]["chain_lastrow_ban"]
    n_chunks = -(-m // prof.chunk)
    batch = profile_batch(nw, w, prof.chunk, exact_kernel=True)
    if n_launch != -(-nw // batch) * n_chunks:
        raise AssertionError(f"self-join 2048: {n_launch} launches")
    d = res.distances
    if (d.shape != (nw,) or d.dtype != torch.int32 or d.device != st.device
            or not prof.valid.all() or not (prof.nn_dist < 2**29).all()):
        raise AssertionError("self-join 2048: unexpected profile")
    # Motifs are mutual nearest neighbours at the cheaper of their two
    # distances; discords the farthest windows, farthest first.
    for a, b_, dist in prof.motifs:
        if not (prof.nn_window[a] == b_ and prof.nn_window[b_] == a
                and dist == min(prof.nn_dist[a], prof.nn_dist[b_])):
            raise AssertionError(f"motif ({a}, {b_}) != the profile")
    dd = [dist for _, dist in prof.discords]
    if (not prof.discords or dd != sorted(dd, reverse=True)
            or dd[0] != prof.nn_dist.max()
            or any(prof.nn_dist[i] != dist for i, dist in prof.discords)):
        raise AssertionError("discords != the profile's farthest windows")
    cells = nw * w * m
    log(f"phase 15: matsa(self_join) window {w} stride {w} on {m} samples: "
        f"{nw} windows, {wall:.3f} s wall, kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / 1e3 / wall:.1%}), {cells:.4g} cells "
        f"({cells / wall:.4g} cells/s, int32 bound "
        f"{cells * OPS_PER_CELL['span'] / int32_rate:.3f} s), {n_launch} "
        f"launches (chunk {prof.chunk}, batch {batch}, "
        f"{ops.resolve_chain(batch, w, sms=ops.sm_count(0))} (W, R, queries "
        f"a block)); motifs {prof.motifs}, discords {prof.discords}")

    # The same profile in batches of 256, the default before the path
    # sized its batch.
    ops.reset_launches()
    t0 = time.time()
    with KernelTimer(torch, kpkg) as timer:
        small = matrix_profile(series, w, stride=w, prune=False, batch=256,
                               device=dev)
        torch.cuda.synchronize()
    out["self_join_256_s"] = time.time() - t0
    out["self_join_256_kernel_ms"] = timer.ms()
    launches["self_join_2048_ecg_256"] = la = _only(
        ops, "chain_lastrow_ban", "self-join 2048 batch 256")
    if la["chain_lastrow_ban"] != -(-nw // 256) * n_chunks:
        raise AssertionError(f"self-join 2048 batch 256: {la} launches")
    _same_profile(f"self-join 2048 batch {batch} vs 256", prof, small)
    log(f"phase 15: the same profile in batches of 256: "
        f"{out['self_join_256_s']:.3f} s wall, kernel "
        f"{out['self_join_256_kernel_ms']:.3f} ms, "
        f"{la['chain_lastrow_ban']} launches "
        f"({ops.resolve_chain(256, w, sms=ops.sm_count(0))}), bitwise "
        f"batch {batch}")

    # The first batch of 256 as the path launches a batch
    # (``_kernel_topk_scan``: the reference right-padded to whole chunks,
    # the carry through them), on the chain kernel and on the wavefront,
    # every output of every slice bitwise; the batch's harvest equals the
    # profile.
    c, nb = prof.chunk, min(256, nw)
    s_b = prof.starts[:nb]
    qb = torch.as_tensor(series[s_b[:, None] + np.arange(w)], device=dev)
    lob, hib = (x.to(dev) for x in self_join_exclusion(s_b, w))
    r_pad = torch.nn.functional.pad(st, (0, -(-m // c) * c - m))
    carry = {"chain": None, "wavefront": None}
    ms = {"chain": 0.0, "wavefront": 0.0}
    for off in range(0, m, c):
        got = {}
        for kernel in carry:
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            got[kernel] = h.kernel(qb, r_pad[off:off + c], carry=carry[kernel],
                                   track=True, lastrow=True, ref_offset=off,
                                   ref_len=min(c, m - off), excl_lo=lob,
                                   excl_hi=hib, kernel=kernel)
            ev[1].record()
            ev[1].synchronize()
            ms[kernel] += ev[0].elapsed_time(ev[1])
            g = got[kernel]
            carry[kernel] = (g[3], g[4], g[0], g[1], g[2])
        h.record("chain_lastrow_ban", h.compare(
            f"self-join 2048 batch, slice at {off}: chain vs wavefront",
            got["chain"], got["wavefront"]))
    if not np.array_equal(carry["chain"][2].cpu().numpy(), prof.nn_dist[:nb]):
        raise AssertionError("self-join 2048: batch harvest != profile")
    out["batch_ms"] = ms
    log(f"phase 15: first batch ({nb} windows, {-(-m // c)} slices of {c} "
        f"through the carry): chain {ms['chain']:.3f} ms, wavefront "
        f"{ms['wavefront']:.3f} ms, every output of every slice bitwise "
        f"equal; harvest == profile")
    del got, carry

    # The path's batch (every window) over 2 slices against the plain
    # version slice by slice.
    sec = _batch_vs_plain(torch, np, ops, h, st, prof.starts, w, c, 2,
                          "chain_lastrow_ban", f"self-join 2048 batch of {nw}")
    log(f"phase 15: the path's batch ({nw} windows with their bans, 2 slices"
        f" of {c} through the carry) == plain version slice by slice, every "
        f"output ({sec:.1f} s)")

    # 4 windows through the direct route, against the plain version with
    # their bans over the whole series.
    idx = np.unique(np.linspace(0, nw - 1, 4).astype(int))
    s4 = prof.starts[idx]
    q4 = torch.as_tensor(series[s4[:, None] + np.arange(w)], device=dev)
    lo4, hi4 = self_join_exclusion(s4, w)
    ops.reset_launches()
    d4, st4, e4 = engine.sdtw(q4, st, excl_lo=lo4, excl_hi=hi4,
                              return_spans=True, device=dev)
    dp4, ep4 = engine.sdtw(q4, st, excl_lo=lo4, excl_hi=hi4,
                           return_positions=True, device=dev)
    torch.cuda.synchronize()
    launches["self_join_2048_windows"] = la = dict(ops.LAUNCHES)
    if la["chain_span_ban"] != 1 or la["chain_plain_ban"] != 1:
        raise AssertionError(f"window 2048 direct route: {la}")
    t0 = time.time()
    raw_p = h.plain_raw(q4, st, track=True, lastrow=True, excl_lo=lo4,
                        excl_hi=hi4)
    raw_k = h.kernel(q4, st, track=True, lastrow=True, excl_lo=lo4,
                     excl_hi=hi4, kernel="chain")
    h.record("chain_span_ban", h.compare(
        "4 windows of 2048 spans vs plain", (d4, e4, st4), raw_p[:3]))
    h.record("chain_plain_ban", h.compare(
        "4 windows of 2048 distances vs plain", (dp4, ep4), raw_p[:2]))
    h.record("chain_lastrow_ban", h.compare(
        "4 windows of 2048 last row vs plain", raw_k, raw_p))
    for f, got in (("nn_dist", d4), ("nn_start", st4), ("nn_end", e4)):
        if not np.array_equal(getattr(prof, f)[idx], got.cpu().numpy()):
            raise AssertionError(f"self-join 2048: {f} != the direct route")
    log(f"phase 15: 4 windows (K1, K2, K3 with bans) == plain version over "
        f"the whole series ({time.time() - t0:.1f} s) and == the profile")
    del raw_p, raw_k

    # 64 queries of 4,096 cut from the series (noised), spans against the
    # whole series: the path ("auto", the chain kernel), then both kernels
    # timed; every query's outputs bitwise equal.
    rng = np.random.default_rng(4096)
    s64 = rng.choice(m - 4096, 64, replace=False)
    q64 = torch.as_tensor(series[s64[:, None] + np.arange(4096)]
                          + rng.integers(-3, 4, (64, 4096)).astype(np.int32),
                          device=dev)
    ops.reset_launches()
    spans = engine.sdtw(q64, st, return_spans=True, device=dev)
    torch.cuda.synchronize()
    launches["spans_4096_ecg"] = _only(ops, "chain_span", "4,096 spans")
    wf = []
    out["spans_ms"] = {
        "chain": cuda_ms(lambda: engine.sdtw(q64, st, return_spans=True,
                                             device=dev), reps=2,
                         warmup=False),
        "wavefront": cuda_ms(lambda: wf.append(ops.sdtw_cuda(
            q64, st, return_spans=True, device=dev, kernel="wavefront")),
            reps=1, warmup=False)}
    h.compare("4,096 spans: chain vs wavefront", spans, wf[0])
    cells = 64 * 4096 * m
    out["spans_bound_ms"] = cells * OPS_PER_CELL["span"] / int32_rate * 1e3
    log(f"phase 15: engine.sdtw(spans) 64 queries of 4096 vs {m}: "
        f"{cells:.4g} cells; chain {out['spans_ms']['chain']:.3f} ms, "
        f"wavefront {out['spans_ms']['wavefront']:.3f} ms, K2 bound "
        f"{out['spans_bound_ms']:.3f} ms; chain "
        f"{ops.resolve_chain(64, 4096, sms=ops.sm_count(0))}; bitwise "
        f"equal on every query")
    return launches, out


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
    launches = _only(ops, "chain_lastrow_ban", "pruned profile")
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
        f"{pr.chunks_processed}, launches {launches['chain_lastrow_ban']}; "
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
    launches = _only(ops, "chain_lastrow_ban", "stream profile")
    want = matrix_profile(pre, 512, stride=512, k=3, prune=False,
                          device=dev)
    _same_profile("stream profile vs matrix_profile", res, want)
    log(f"phase 14: StreamProfile(512, stride=512, k=3) over {len(pre)} "
        f"samples in {len(cuts) - 1} pieces, flush after piece 3: "
        f"{wall:.3f} s wall, kernel {timer.ms():.3f} ms "
        f"({timer.ms() / 1e3 / wall:.1%}), {sp.tiles_processed} tiles, "
        f"{len(res.starts)} windows, launches {launches['chain_lastrow_ban']}"
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
    if launches["rows_span"] < 1 or launches["chain_span"] < 1:
        raise AssertionError(f"align missed the kernel: {launches}")
    log(f"phase 11: align {times}: {n_paths} paths valid, each replaying "
        f"its distance bitwise; launches {launches}")
    return launches


def table_v_cut(w: dict):
    """A Table V shape cut to 4,224 queries (32 warps on each of 132 SMs)
    and a reference of at most 8e10 cells (at least 20 N samples, and at
    most 6.4e8 last-row entries): ``(queries, N, M)``."""
    n_, b_ = w["query_size"], min(w["num_queries"], 4224)
    m_ = min(w["ref_size"], max(20 * n_, int(8e10) // (b_ * n_)),
             int(6.4e8) // b_)
    return b_, n_, m_


def phase_tune(torch, np, ops, shapes, sms, dev):
    """Phase 16: the autotuner on the card. For each main shape (``name:
    (queries, reference, variant, bans)``): the ``tune='off'`` launch (the
    hand-set policy) and the ``tune='model'`` one (the shipped
    ``h100.json``, else the cost model), each timed with CUDA events; the
    answers bitwise equal under ``'off'``, ``'model'`` and ``'measure'``;
    the model's launch within 5 % of the hand-set one's time or faster.
    Then ``tune='measure'`` on a small bucket, whose entry must land in
    the process table. A decision's time is its launch's, made
    explicitly (one timing when both decisions launch the same, else each
    twice in turns). Returns ``{name: {mode: (label, source, ms)}}``."""
    from repro_torch.core import engine
    from repro_torch.tune import bucket_key, default_table
    from repro_torch.tune.cost import launch_label
    table = default_table("h100")
    log(f"phase 16: h100.json, {len(table)} entries: {table.provenance}")
    out = {}
    for name, (q, r, variant, bans) in shapes.items():
        b, n = q.shape
        m = r.shape[0]
        kw = dict(return_spans=variant != "plain", return_positions=True,
                  return_lastrow=variant == "lastrow", device=dev)
        if bans is not None:
            kw.update(excl_lo=bans[0], excl_hi=bans[1])
        cfgs, answers = {}, {}
        for mode in ("off", "model", "measure"):
            cfgs[mode] = ops.tuned_launch(b, n, m, sms=sms, variant=variant,
                                          ban=bans is not None, tune=mode)
            answers[mode] = _flat(ops.sdtw_cuda(q, r, tune=mode, **kw))

        def launch(cfg):
            return ops.sdtw_cuda(
                q, r, tune="off", kernel=cfg["kernel"], block_q=cfg["block_q"],
                block_m=cfg["block_m"],
                rows=None if cfg["kernel"] == "wavefront" else cfg["rows"],
                **kw)
        # Each decision's launch timed as an explicit launch (the same
        # host path for both); one launch is timed once, two in turns.
        reps = 2 if m > 1e6 else 3
        if cfgs["off"][0] == cfgs["model"][0]:
            t = cuda_ms(lambda: launch(cfgs["off"][0]), reps=reps)
            ms = {"off": t, "model": t}
        else:
            runs = {"off": [], "model": []}
            for order in (("off", "model"), ("model", "off")):
                for mode in order:
                    runs[mode].append(cuda_ms(
                        lambda: launch(cfgs[mode][0]), reps=reps))
            ms = {mode: statistics.mean(v) for mode, v in runs.items()}
        res = {mode: (launch_label(cfgs[mode][0]),
                      cfgs[mode][1].source if cfgs[mode][1] else "legacy",
                      ms[mode]) for mode in ("off", "model")}
        for mode in ("model", "measure"):
            for g, w in zip(answers[mode], answers["off"]):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: tune={mode} answers != "
                                         f"tune='off'")
        del answers
        (lo, so, t_off), (lm, sm, t_mod) = res["off"], res["model"]
        log(f"phase 16: {name} ({b}x{n} vs {m}, {variant}"
            f"{' + ban' if bans is not None else ''}): off {lo} ({so}) "
            f"{t_off:.3f} ms; model {lm} ({sm}) {t_mod:.3f} ms; "
            f"model/off {t_mod / t_off:.3f}; answers bitwise equal under "
            f"off/model/measure")
        if t_mod > 1.05 * t_off:
            raise AssertionError(f"{name}: tune='model' {t_mod:.3f} ms is "
                                 f"over 5 % slower than 'off' {t_off:.3f}")
        out[name] = res
    rng = np.random.default_rng(16)
    q = torch.as_tensor(rng.integers(-100, 100, (64, 128)).astype(np.int32),
                        device=dev)
    r = torch.as_tensor(rng.integers(-100, 100, 2048).astype(np.int32),
                        device=dev)
    key = bucket_key("h100", "abs_diff", "int32", 64, 128, 2048, "plain")
    if table.get(key) is not None:
        raise AssertionError(f"{key} is in the shipped table already")
    got = engine.sdtw(q, r, tune="measure", device=dev)
    entry = table.get(key)
    if entry is None or entry.source != "measured":
        raise AssertionError(f"tune='measure' left no entry for {key}")
    if not torch.equal(got, engine.sdtw(q, r, tune="off", device=dev)):
        raise AssertionError("tune='measure' answers != tune='off'")
    log(f"phase 16: tune='measure' on {key}: "
        f"{launch_label(entry.to_json())} {entry.score_us:.1f} us, in the "
        f"process table; answers == tune='off'")
    return out


def phase_serve(torch, np, ops, human, ecg, dev):
    """Phase 17: the serving tier on the card. A warmed ``Router`` serves
    Human at full width — 131,072 queries of 120 against 7,997 as 64
    requests of 2,048 from 8 closed-loop client threads — with fewer
    dispatches than requests, every answer bitwise the client's own
    offline ``engine.sdtw`` on the card; one window replayed by hand for
    the batcher's host share; 8 ``search_topk(k=3)`` requests of 32
    ECG-cut queries coalesced into one dispatch, bitwise the offline
    batched search; one stream feed through ``open_stream``/``feed``,
    bitwise an ``engine.stream`` session fed the same pieces; and a short
    ``python -m repro_torch.serve``. Returns the served window's launches
    and its numbers."""
    import concurrent.futures
    import threading

    from repro_torch.core import engine
    from repro_torch.core.engine import pad_ragged_bucket
    from repro_torch.search import search_topk
    from repro_torch.serve import Router, RouterConfig, batcher
    from repro_torch.serve.telemetry import RequestTrace
    queries, reference = human
    per, n_req, clients = 2048, 64, 8
    reqs = [queries[i * per:(i + 1) * per] for i in range(n_req)]
    window = clients * per
    results = [None] * n_req
    with Router(RouterConfig(window_ms=5.0, window_full_queries=window,
                             max_queue=n_req)) as router:
        t0 = time.time()
        router.warmup(queries=queries[:window], reference=reference)
        warm_s = time.time() - t0

        def client(c):
            for i in range(c, n_req, clients):
                results[i] = router.sdtw(reqs[i], reference)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        ops.reset_launches()
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        serve_s = time.time() - t0
        launches = dict(ops.LAUNCHES)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve: a client thread did not finish")
        st = router.stats()
    if st.completed != n_req or st.errors or st.dispatches >= n_req:
        raise AssertionError(f"serve: {st.completed} completed, "
                             f"{st.errors} errors, {st.dispatches} "
                             f"dispatches for {n_req} requests")
    for i, got in enumerate(results):
        if not torch.equal(got, engine.sdtw(reqs[i], reference, device=dev)):
            raise AssertionError(f"serve: request {i} != its offline call")
    log(f"phase 17: served Human {queries.shape[0]}x{queries.shape[1]} vs "
        f"{len(reference)} as {n_req} requests of {per} from {clients} "
        f"threads in {serve_s:.3f} s (warm-up {warm_s:.3f} s): "
        f"{st.dispatches} dispatches for {st.completed} requests "
        f"(mean {st.mean_batch_requests:.2f} requests, "
        f"{st.mean_batch_queries:.0f} queries a dispatch), latency p50 "
        f"{st.p50_latency_us / 1e3:.3f} ms p99 {st.p99_latency_us / 1e3:.3f}"
        f" ms, queue p50 {st.p50_queue_us / 1e3:.3f} ms; launches "
        f"{ {k: v for k, v in launches.items() if v} }; every answer == "
        f"the client's offline engine.sdtw on the card")

    # One full window by hand: the batcher's host work against the
    # kernel's time on the merged bucket.
    def pending(i):
        return batcher.Pending(
            request=engine.SdtwRequest(queries=reqs[i], reference=reference),
            future=concurrent.futures.Future(),
            trace=RequestTrace(op="sdtw", nq=per))
    split = {}
    for _ in range(2):
        pend = [pending(i) for i in range(clients)]
        t0 = time.perf_counter()
        groups = batcher.group_window(pend)
        t1 = time.perf_counter()
        batcher.execute_group(groups[0])
        t2 = time.perf_counter()
        split = {"group_ms": (t1 - t0) * 1e3, "execute_ms": (t2 - t1) * 1e3}
    merged = [e for p in groups[0] for e in p.entries]
    padded, qlens = pad_ragged_bucket(merged, list(range(len(merged))),
                                      128)
    pq, pl = (torch.as_tensor(padded, device=dev),
              torch.as_tensor(qlens, device=dev))
    rt = torch.as_tensor(reference, device=dev)
    kernel_ms = cuda_ms(lambda: ops.sdtw_cuda(pq, rt, pl, tune="model",
                                              device=dev))
    wall = split["group_ms"] + split["execute_ms"]
    out = {"serve_s": serve_s, "dispatches": st.dispatches,
           "requests": st.completed, "p50_ms": st.p50_latency_us / 1e3,
           "p99_ms": st.p99_latency_us / 1e3, "window_ms": wall,
           "kernel_ms": kernel_ms, "host_share": 1 - kernel_ms / wall}
    log(f"phase 17: one window of {clients} requests ({len(merged)} "
        f"queries) by hand: group {split['group_ms']:.3f} ms + execute "
        f"{split['execute_ms']:.3f} ms = {wall:.3f} ms; kernel on the "
        f"merged bucket {kernel_ms:.3f} ms; host share "
        f"{out['host_share']:.3f}")

    # Search and a stream, ECG-cut.
    q_e, ref_e = ecg
    sq = [q_e[i * 32:(i + 1) * 32] for i in range(8)]
    with Router(RouterConfig(auto_dispatch=False)) as router:
        futs = [router.submit(queries=q, reference=ref_e, op="search_topk",
                              top_k=3, ref_key="ecg") for q in sq]
        router.drain()
        if router.stats().dispatches != 1:
            raise AssertionError("serve: search requests did not coalesce")
        want = search_topk([row for q in sq for row in q], ref_e, 3,
                           ref_key="ecg", cache=router.cache, device=dev)
        for f in ("distances", "positions", "starts"):
            got = torch.cat([getattr(x.result(), f) for x in futs])
            if not torch.equal(got, getattr(want, f)):
                raise AssertionError(f"serve: search {f} != offline")
        feed = ref_e[:262144]
        router.open_stream("ecg", "t0", queries=q_e[:16], top_k=3,
                           return_spans=True)
        session = engine.stream(q_e[:16], top_k=3, return_spans=True,
                                device=dev)
        for i in range(0, len(feed), 65536):
            router.feed("ecg", feed[i:i + 65536])
            session.feed(feed[i:i + 65536])
        served = router.sessions.finalize("ecg")["t0"]
        offline = session.results()
        for f in ("distances", "positions", "starts"):
            g, w = getattr(served, f), getattr(offline, f)
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"serve: stream {f} != offline")
    log("phase 17: 8 search_topk(k=3) requests of 32 ECG-cut queries in 1 "
        "dispatch == the offline batched search; a stream of 16 ECG-cut "
        "queries fed 262,144 samples through open_stream/feed == an "
        "engine.stream session fed the same pieces")

    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve()
                                          .parent / "src"))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--clients", "4",
         "--requests", "4", "--nq", "64", "--qlen", "128", "--reflen",
         "8192"], capture_output=True, text=True, timeout=600, env=env)
    if proc.returncode != 0:
        raise AssertionError(f"python -m repro_torch.serve failed: "
                             f"{proc.stderr[-2000:]}")
    snap = json.loads(proc.stdout)
    if snap["completed"] != 16 or snap["device"] != \
            torch.cuda.get_device_name(0):
        raise AssertionError(f"python -m repro_torch.serve: {snap}")
    log(f"phase 17: python -m repro_torch.serve: {snap['completed']} "
        f"requests in {snap['dispatches']} dispatches on {snap['device']}, "
        f"p50 {snap['p50_latency_us'] / 1e3:.3f} ms "
        f"({time.time() - t0:.1f} s with start-up)")
    return launches, out


def free_port() -> int:
    """A free TCP port on localhost (the rendezvous of a process group)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def same_heap(np, name, got, want):
    """Top-K triples (distances, starts, ends) equal, bitwise."""
    for f, g, w in zip(("distances", "starts", "ends"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape \
                or not np.array_equal(g, w):
            raise AssertionError(f"{name}: {f} differ")


def result_heap(res):
    return res.distances, res.starts, res.positions


#: Meshes of the gloo ranks in phase 18 and the n_micro each sweeps
#: besides the engine's default.
GLOO_MESHES = (((1, 4), (2, 4)), ((2, 2), (2,)))
GLOO_WORLD = 4


def sharded_stream(engine, mesh, qe, ref, piece, snap_at, restore, dev):
    """Feed ``ref`` in ``piece``-sample pieces through a sharded session
    on ``mesh`` (top-3, spans), snapshot after piece ``snap_at``, flush;
    then restore the snapshot (``restore(snap)``), feed it the rest and
    flush. Returns (heap, restored heap, samples at the snapshot)."""
    s = engine.stream(qe, mesh=mesh, top_k=3, return_spans=True, device=dev)
    snap = None
    for i, off in enumerate(range(0, len(ref), piece)):
        s.feed(ref[off:off + piece])
        if i == snap_at:
            snap = s.snapshot()
    s.flush()
    r2 = restore(snap)
    at = r2.samples_seen
    r2.feed(ref[at:])
    r2.flush()
    return result_heap(s.results()), result_heap(r2.results()), at


def sharded_rank(rank, world, port, data_path, out_dir, src):
    """Phase 18's body on one of the gloo ranks (all on the one card):
    every run of the phase on each mesh of ``GLOO_MESHES``; writes the
    answers, launches and times to ``out_dir/rank<r>.npz`` / ``.json``.
    ``data_path`` holds the reference and the queries."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.kernels.sdtw as kpkg
    from repro_torch.core import engine
    from repro_torch.distributed import get_mesh, init_multi_host
    from repro_torch.kernels.sdtw import ops
    from repro_torch.search import search_topk
    from repro_torch.stream import ShardedStreamSession
    init_multi_host(f"localhost:{port}", world, rank, backend="gloo")
    dev = torch.device("cuda")
    data = np.load(data_path)
    ref = data["ref"]
    qe = torch.as_tensor(data["queries"], device=dev)
    re_ = torch.as_tensor(ref, device=dev)
    out, meta = {}, {"launches": {}, "wall_s": {}, "kernel_ms": {}}

    def timed(path, fn):
        ops.reset_launches()
        dist.barrier()
        t0 = time.time()
        with KernelTimer(torch, kpkg) as timer, NoRowScan(path):
            res = fn()
            torch.cuda.synchronize()
        dist.barrier()
        meta["wall_s"][path] = time.time() - t0
        meta["kernel_ms"][path] = timer.ms()
        meta["launches"][path] = {k: v for k, v in ops.LAUNCHES.items()
                                  if v}
        return res

    for shape, sweep in GLOO_MESHES:
        mesh = get_mesh(shape)
        tag = "x".join(map(str, shape))
        res = timed(f"spans_{tag}", lambda: engine.sdtw(
            qe, re_, mesh=mesh, return_spans=True, device=dev))
        for i, x in enumerate(res):
            out[f"spans_{tag}_{i}"] = x.cpu().numpy()
        res = timed(f"sdtw_{tag}", lambda: engine.sdtw(
            qe, re_, mesh=mesh, top_k=3, return_spans=True, device=dev))
        for i, x in enumerate(res):
            out[f"sdtw_{tag}_{i}"] = x.cpu().numpy()
        for nm in sweep:
            res = timed(f"sdtw_{tag}_n_micro{nm}", lambda: engine.sdtw(
                qe, re_, mesh=mesh, n_micro=nm, top_k=3, return_spans=True,
                device=dev))
            for i, x in enumerate(res):
                out[f"sdtw_{tag}_n_micro{nm}_{i}"] = x.cpu().numpy()
        res = timed(f"search_{tag}", lambda: search_topk(
            qe, re_, k=3, mesh=mesh, prune=False, device=dev))
        for i, x in enumerate(result_heap(res)):
            out[f"search_{tag}_{i}"] = x.cpu().numpy()
        heap, heap2, at = timed(f"stream_{tag}", lambda: sharded_stream(
            engine, mesh, qe, ref, 100_000, 8,
            lambda snap: ShardedStreamSession.restore(snap, mesh=mesh,
                                                      device=dev), dev))
        meta[f"stream_{tag}_restored_at"] = at
        for i, (x, y) in enumerate(zip(heap, heap2)):
            out[f"stream_{tag}_{i}"] = x
            out[f"stream_{tag}_restored_{i}"] = y
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    dist.destroy_process_group()


def phase_sharded(torch, np, ops, kpkg, human, ecg, dev, root):
    """Phase 18: the sharded engine and sharded stream sessions on
    ``torch.distributed``. One card holds one NCCL rank only, so: Human at
    full width through one NCCL rank (the pipeline degenerates to one
    stage), and a sharded ECG-cut stream at world 1 restored through
    ``restore(mesh=)``; then ECG-cut over 4 gloo ranks sharing the card
    (carries staged through the host), on meshes (1, 4) and (2, 2). A
    protocol check on one card: it shows the answers, not scaling.
    Returns the launches of each path (summed over the ranks)."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.core import engine
    from repro_torch.core.matsa_api import matsa
    from repro_torch.distributed import get_mesh, init_multi_host
    from repro_torch.stream import ShardedStreamSession
    (queries, reference, d_human, human_s) = human
    q_e, ref_e, want_e, ecg_s = ecg
    paths = {}
    t_phase = time.time()

    # One NCCL rank: the world is this process.
    init_multi_host(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = get_mesh()
        ops.reset_launches()
        t0 = time.time()
        with NoRowScan("sharded Human"):
            res = matsa(reference, queries, mode="query_filtering",
                        mesh=mesh)
            torch.cuda.synchronize()
        wall = time.time() - t0
        paths["sharded_human_nccl"] = dict(ops.LAUNCHES)
        if paths["sharded_human_nccl"]["rows_plain"] < 1:
            raise AssertionError(f"sharded Human missed the kernel: "
                                 f"{paths['sharded_human_nccl']}")
        if not torch.equal(res.distances, d_human):
            raise AssertionError("sharded Human != phase 4 matsa()")
        again_ms = cuda_ms(lambda: matsa(reference, queries, mesh=mesh),
                           reps=2)
        log(f"phase 18: matsa(query_filtering, mesh=get_mesh()) Human "
            f"{queries.shape[0]}x{queries.shape[1]} vs {len(reference)} on "
            f"one NCCL rank ({dist.get_backend()}, world "
            f"{dist.get_world_size()}): first call {wall:.3f} s (phase 4: "
            f"{human_s[0]:.3f} s), again {again_ms:.3f} ms (phase 4: "
            f"{human_s[1]:.3f} ms); == phase 4 bitwise; launches "
            f"{ {k: v for k, v in paths['sharded_human_nccl'].items() if v} }")

        qe = torch.as_tensor(q_e, device=dev)
        re_ = torch.as_tensor(ref_e, device=dev)
        ops.reset_launches()
        t0 = time.time()
        with NoRowScan("sharded spans, world 1"):
            spans = engine.sdtw(qe, re_, mesh=mesh, return_spans=True)
            torch.cuda.synchronize()
        wall = time.time() - t0
        paths["sharded_spans_world1"] = dict(ops.LAUNCHES)
        same_heap(np, "sharded spans, world 1",
                  [x.cpu().numpy() for x in spans],
                  [w[:, 0] for w in want_e])
        log(f"phase 18: engine.sdtw(mesh=get_mesh(), return_spans=True) "
            f"ECG-cut at world 1 (NCCL): {wall:.3f} s wall (phase 6: "
            f"{ecg_s:.3f} s); == phase 6 bitwise; launches "
            f"{ {k: v for k, v in paths['sharded_spans_world1'].items() if v} }")
        ops.reset_launches()
        t0 = time.time()
        with NoRowScan("sharded stream, world 1"):
            heap, heap2, at = sharded_stream(
                engine, mesh, qe, ref_e, 100_000, 8,
                lambda snap: ShardedStreamSession.restore(
                    snap, mesh=get_mesh()), dev)
            torch.cuda.synchronize()
        wall = time.time() - t0
        paths["sharded_stream_world1"] = dict(ops.LAUNCHES)
        same_heap(np, "sharded stream, world 1", heap, want_e)
        same_heap(np, "restored sharded stream, world 1", heap2, want_e)
        log(f"phase 18: sharded stream ECG-cut at world 1 (NCCL), 18 "
            f"pieces of 100,000, top-3 spans: {wall:.3f} s wall for the "
            f"run and its restored continuation (snapshot after piece 9, "
            f"{at} samples, restore(mesh=get_mesh())); both == phase 10 "
            f"bitwise; launches "
            f"{ {k: v for k, v in paths['sharded_stream_world1'].items() if v} }")
    finally:
        dist.destroy_process_group()

    # Four gloo ranks on the one card. The parent built the kernels
    # (phase 2); the ranks only load them.
    work = tempfile.mkdtemp(dir=root / "build")
    data_path = os.path.join(work, "data.npz")
    np.savez(data_path, ref=ref_e, queries=q_e)
    t0 = time.time()
    ctx = mp.start_processes(
        sharded_rank, args=(GLOO_WORLD, free_port(), data_path, work,
                            str(root / "src")),
        nprocs=GLOO_WORLD, start_method="spawn", join=False)
    deadline = time.time() + 600
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise AssertionError("phase 18: the gloo ranks did not "
                                     "finish within 600 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    spawn_s = time.time() - t0
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
             for r in range(GLOO_WORLD)]
    metas = [json.load(open(os.path.join(work, f"rank{r}.json")))
             for r in range(GLOO_WORLD)]
    for (shape, sweep) in GLOO_MESHES:
        tag = "x".join(map(str, shape))
        checks = [(f"sdtw_{tag}", f"sdtw_{tag}_{{}}"),
                  (f"search_{tag}", f"search_{tag}_{{}}"),
                  (f"stream_{tag}", f"stream_{tag}_{{}}"),
                  (f"stream_{tag}", f"stream_{tag}_restored_{{}}")]
        checks += [(f"sdtw_{tag}_n_micro{nm}", f"sdtw_{tag}_n_micro{nm}_{{}}")
                   for nm in sweep]
        for r, got in enumerate(ranks):
            for path, key in checks:
                same_heap(np, f"rank {r} {key.format('*')}",
                          [got[key.format(i)] for i in range(3)], want_e)
            same_heap(np, f"rank {r} spans_{tag}",
                      [got[f"spans_{tag}_{i}"] for i in range(3)],
                      [w[:, 0] for w in want_e])
        checks.append((f"spans_{tag}", None))
        for path in {p for p, _ in checks}:
            per_rank = [m["launches"][path] for m in metas]
            var = "span" if path.startswith("spans") else "lastrow"
            if any(not sum(v for k, v in lr.items() if k.endswith(var))
                   for lr in per_rank):
                raise AssertionError(f"{path}: a rank missed the kernel's "
                                     f"{var} variant: {per_rank}")
            paths[f"sharded_{path}"] = {
                k: sum(lr.get(k, 0) for lr in per_rank) for k in ops.LAUNCHES}
            walls = [m["wall_s"][path] for m in metas]
            kms = [m["kernel_ms"][path] for m in metas]
            log(f"phase 18: {path} on {GLOO_WORLD} gloo ranks, mesh "
                f"{shape}: {max(walls):.3f} s wall (protocol check on one "
                f"card), kernel ms by rank "
                f"{[round(k, 3) for k in kms]}; launches by rank "
                f"{per_rank}; every rank == phase "
                f"{6 if path.startswith('spans') else '6/9/10'} bitwise")
        log(f"phase 18: stream {tag} restored at world {GLOO_WORLD} from "
            f"its snapshot at {metas[0][f'stream_{tag}_restored_at']} "
            f"samples == phase 10 bitwise")
    log(f"phase 18: {GLOO_WORLD} gloo ranks spawned, ran and joined in "
        f"{spawn_s:.1f} s; phase 18 total {time.time() - t_phase:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# Phase 19: the LM serving path.
# ---------------------------------------------------------------------------

#: Served at full width and full depth: the fp32 master and its bf16
#: compute copy fit the card (4.7-19.4 GB).
LM_FULL_DEPTH = ("llama3.2-1b", "granite-moe-1b-a400m", "mamba2-780m",
                 "zamba2-2.7b", "internvl2-2b", "musicgen-large")
#: Served at full width with the depth cut to ``LM_CUT_LAYERS`` layers:
#: full depth needs 88-282 GB of fp32 master plus bf16 copy.
LM_CUT = ("phi3-medium-14b", "qwen3-moe-30b-a3b", "qwen1.5-32b",
          "granite-34b")
LM_CUT_LAYERS = 4
#: One arch a family for the card-against-CPU check at a 2-layer cut of
#: full width (the hybrid at one group of ``attn_every`` layers).
LM_FAMILIES = {"dense": "llama3.2-1b", "moe": "granite-moe-1b-a400m",
               "ssm": "mamba2-780m", "hybrid": "zamba2-2.7b"}
#: The served load: prompts × prompt tokens, then greedy decode steps.
LM_SERVE = dict(batch=8, prompt_len=512, gen=64)
#: fp32 tolerances on the card: against the CPU (logits; cache leaves as
#: a share of the leaf's largest magnitude) and prefill's last logits
#: against ``forward``'s on the card. Measured on an H100 (TF32 off): at
#: most 4.4e-5, 8.4e-6 and 2.2e-5, at logit scales of 3-5.
LM_CPU_ATOL, LM_CPU_CACHE_FRAC, LM_PREFILL_ATOL = 1e-3, 1e-3, 1e-4


def lm_cut(cfg, layers: int):
    """``cfg`` at ``layers`` layers (a hybrid keeps whole groups)."""
    import dataclasses
    layers = max(layers, cfg.attn_every)
    return dataclasses.replace(cfg, n_layers=layers - layers %
                               max(cfg.attn_every, 1))


def lm_prompts(torch, cfg, b: int, s: int, gen, dev):
    """Seeded prompts: token ids, or embeddings for a stub frontend."""
    if cfg.frontend == "stub":
        return {"embeddings": torch.randn((b, s, cfg.d_model), generator=gen,
                                          device=dev)}
    return {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                    device=dev, dtype=torch.int32)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def lm_card_vs_cpu(torch, tm, cfg, dev, seed: int):
    """The same weights (drawn on the card, copied to the CPU) serve 2
    prompts of 32 tokens and 4 decode steps of fixed tokens at fp32 on the
    card and on the CPU. Returns the largest logit difference, the logits'
    scale and the largest cache-leaf difference as a share of the leaf."""
    from repro_torch.models.layers import Init
    run = tm.RunConfig(compute_dtype=torch.float32,
                       cache_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    card = tm.init_lm(cfg, gen, dev)
    cpu = tm.LM(cfg, Init(torch.device("cpu")))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = {k: v.cpu() for k, v in lm_prompts(torch, cfg, 2, 32, gen,
                                                dev).items()}
    steps = torch.randint(0, cfg.vocab, (4, 2), generator=gen, device=dev,
                          dtype=torch.int32).cpu()
    out = {}
    for lm in (card, cpu):
        logits, cache = tm.prefill(cfg, lm, batch, 32 + 5, run)
        seen = [logits]
        for tok in steps:
            logits, cache = tm.decode_step(cfg, lm, tok, cache, run)
            seen.append(logits)
        out[lm.device.type] = (torch.stack(seen).cpu(),
                               {k: v.cpu() for k, v in _leaves(cache)})
    (lc, cc), (lp, cp) = out[dev.type], out["cpu"]
    err = float((lc - lp).abs().max())
    cache_frac = max(float((cc[k].float() - cp[k].float()).abs().max())
                     / max(float(cp[k].float().abs().max()), 1e-6)
                     for k in cp)
    if not torch.equal(cc["pos"], cp["pos"]):
        raise AssertionError(f"{cfg.name}: cache positions differ")
    return err, float(lp.abs().max()), cache_frac


def lm_bound_ms(cfg, lm, b: int, s: int, gen: int, experts):
    """Least times of prefill (b prompts of s) and of one decode step at
    the run's mean context (b × (s + gen/2)), in ms, and what bounds each.

    Prefill: 2 op a weight a token for the matmuls the tokens need (the
    unembedding for the last token only; a MoE token's top-k experts;
    the hybrid's shared block once a group) plus the causal attention
    products (4·H·Dh op a query-key pair), at the bf16 peak; against the
    bf16 weights read once. Decode: the bytes a step must move — every
    bf16 weight it uses read once (the untied input table only for the
    b rows it gathers; a MoE layer's experts only those ``experts``
    counts routed to in one step), the bf16 K/V of the context, the fp32
    SSM state read and written, the fp32 logits written — against its
    matmul operations."""
    d, v = cfg.d_model, cfg.vocab
    total = sum(p.numel() for p in lm.parameters())
    table = v * d
    expert = 3 * d * cfg.d_ff
    untied = 0 if cfg.tie_embeddings else table
    groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    shared = sum(p.numel() for p in lm.shared.parameters()) if groups else 0
    n_attn = groups if groups else (0 if cfg.has_ssm else cfg.n_layers)
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    # matmul weights a token uses, without the tables
    body = total - table - untied + shared * (groups - 1)
    if cfg.has_moe:
        body -= cfg.n_layers * (cfg.n_experts - cfg.topk) * expert
    read = total - untied                       # bf16 weights, read once
    pairs = b * s * (s + 1) // 2
    pre_ops = 2 * b * s * body + 2 * b * d * v + 4 * h * dh * pairs * n_attn
    pre_t = (pre_ops / h100("peak_flops"), 2 * read / h100("hbm_bw"))
    ctx = s + gen // 2
    if untied:
        read += b * d                           # the rows gathered
    if cfg.has_moe:
        read -= sum(cfg.n_experts - e for e in experts) * expert
    kv = 2 * n_attn * b * ctx * cfg.n_kv_heads * dh * 2
    ssm = (2 * cfg.n_layers * b * cfg.n_ssm_heads * cfg.ssm_head_dim
           * cfg.ssm_state * 4) if cfg.has_ssm else 0
    dec_bytes = 2 * read + kv + ssm + b * v * 4
    dec_ops = 2 * b * (body + d * v) + 4 * h * dh * b * ctx * n_attn
    dec_t = (dec_ops / h100("peak_flops"), dec_bytes / h100("hbm_bw"))

    def bound(t):
        return max(t) * 1e3, "operations" if t[0] > t[1] else "bytes"
    return bound(pre_t), bound(dec_t), dec_bytes


def phase_lm(torch, np, ops, dev, seed: int, serve=None):
    """Phase 19: the LM serving path on the card. Each family's 2-layer
    cut at full width against the CPU at fp32 (same weights); then every
    configuration at full width — full depth for ``LM_FULL_DEPTH``, cut to
    ``LM_CUT_LAYERS`` for ``LM_CUT`` — built from a seeded generator on
    the card: prefill's last logits against ``forward``'s at fp32 on 2
    prompts of 64, then ``serve`` (``LM_SERVE``: 8 prompts of 512, 64
    greedy decode steps) in bf16 compute and a bf16 cache, timed after a
    warm-up, with
    the host's time to enqueue a decode step (near the step's time: the
    host, not the card, bounds decode).
    llama3.2-1b's prompts come through ``TSAFilteredLM``, whose sDTW
    filter runs the kernel (its launches are the path ``lm_tsa_filter``).
    Returns ({path: launches}, {config: numbers})."""
    from repro_torch import models as tm
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TSAFilteredLM
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import make_serve_step

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: fp32 would not compare")
    cuda = dev.type == "cuda"
    serve = serve or LM_SERVE
    b, s, n_gen = serve["batch"], serve["prompt_len"], serve["gen"]
    check_len = min(64, s)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_phase = time.time()
    for fam, name in LM_FAMILIES.items():
        cfg = lm_cut(get_arch(name), 2)
        t0 = time.time()
        err, scale, frac = lm_card_vs_cpu(torch, tm, cfg, dev, seed)
        log(f"phase 19: {name} cut to {cfg.n_layers} layers, card vs CPU at "
            f"fp32 (2 prompts of 32, 4 decode steps): logits max |diff| "
            f"{err:.3e} (scale {scale:.3f}), cache leaves {frac:.2e} of "
            f"their largest, in {time.time() - t0:.1f} s")
        if err > LM_CPU_ATOL or frac > LM_CPU_CACHE_FRAC:
            raise AssertionError(f"phase 19: {name} card != CPU: {err}, "
                                 f"{frac}")
    run16 = tm.RunConfig()
    run32 = tm.RunConfig(compute_dtype=torch.float32,
                         cache_dtype=torch.float32)
    out, launches = {}, {}
    for i, name in enumerate(LM_FULL_DEPTH + LM_CUT):
        full = get_arch(name)
        cfg = full if name in LM_FULL_DEPTH else lm_cut(full, LM_CUT_LAYERS)
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        held = torch.cuda.memory_allocated() if cuda else 0
        t0 = time.time()
        lm = tm.init_lm(cfg, gen, dev)
        sync()
        init_s = time.time() - t0
        if name == "llama3.2-1b":
            ops.reset_launches()
            t0 = time.time()
            data = TSAFilteredLM(DataConfig(seq_len=s, global_batch=b,
                                            vocab=cfg.vocab), device=dev)
            batch = {"tokens": torch.as_tensor(data.batch_at(0)["tokens"],
                                               device=dev)}
            sync()
            filt_s = time.time() - t0
            launches["lm_tsa_filter"] = dict(ops.LAUNCHES)
            k1 = {k: n for k, n in ops.LAUNCHES.items() if n}
            if cuda and not any(k.endswith("_plain") for k in k1):
                raise AssertionError(f"phase 19: the filter launched no K1 "
                                     f"kernel: {k1}")
            log(f"phase 19: TSAFilteredLM(seq_len={s}, global_batch={b}) on "
                f"the card: {data.filter_stats} windows of {data.window} "
                f"kept in {filt_s:.3f} s, launches {k1}")
        else:
            batch = lm_prompts(torch, cfg, b, s, gen, dev)
        small = {k: v[:2, :check_len] for k, v in batch.items()}
        full_lg, _ = tm.forward(cfg, lm, small, run32)
        pre_lg, _ = tm.prefill(cfg, lm, small, check_len + 1, run32)
        check = float((pre_lg - full_lg[:, -1]).abs().max())
        if not check <= LM_PREFILL_ATOL:
            raise AssertionError(f"phase 19: {name} prefill != forward at "
                                 f"fp32: {check}")
        del full_lg, pre_lg
        step = make_serve_step(cfg, run16)
        max_len = s + n_gen + 1
        logits, cache = tm.prefill(cfg, lm, batch, max_len, run16)  # warm-up
        tok = torch.argmax(logits, -1).to(torch.int32)
        for _ in range(2):
            tok, _, cache = step(lm, tok, cache)
        del logits, cache
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        logits, cache = tm.prefill(cfg, lm, batch, max_len, run16)
        sync()
        prefill_s = time.perf_counter() - t0
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks, enqueue = [tok], []
        t0 = time.perf_counter()
        for _ in range(n_gen):
            t1 = time.perf_counter()
            tok, logits, cache = step(lm, tok, cache)
            enqueue.append(time.perf_counter() - t1)
            toks.append(tok)
        sync()
        decode_s = time.perf_counter() - t0
        # the serving run's peak above what the process held before
        peak = torch.cuda.max_memory_allocated() - held if cuda else 0
        toks = torch.stack(toks, 1)
        if not (bool(torch.isfinite(logits).all())
                and bool(((toks >= 0) & (toks < cfg.vocab)).all())
                and int(cache["pos"][0]) == s + n_gen):
            raise AssertionError(f"phase 19: {name}: non-finite logits, "
                                 f"tokens out of range or a wrong position")
        experts = []
        if cfg.has_moe:          # one more step, counting routed experts
            route = moe_mod._route

            def counting(x, *a):
                g, ids, aux = route(x, *a)
                experts.append(int(ids.unique().numel()))
                return g, ids, aux
            moe_mod._route = counting
            try:
                step(lm, tok, cache)
            finally:
                moe_mod._route = route
        (pre_b, pre_by), (dec_b, dec_by), dec_bytes = lm_bound_ms(
            cfg, lm, b, s, n_gen, experts)
        row = {"family": cfg.family, "layers": cfg.n_layers,
               "full_layers": full.n_layers,
               "params": sum(p.numel() for p in lm.parameters()),
               "init_s": init_s, "prefill_ms": prefill_s * 1e3,
               "decode_ms_per_token": decode_s * 1e3 / n_gen,
               "decode_enqueue_ms": statistics.median(enqueue) * 1e3,
               "tokens_per_s": b * n_gen / decode_s,
               "peak_mem_gb": peak / 1e9, "prefill_check_err": check,
               "prefill_bound_ms": pre_b, "prefill_bound_by": pre_by,
               "decode_bound_ms": dec_b, "decode_bound_by": dec_by,
               "decode_bytes": dec_bytes,
               "experts_a_layer": (min(experts), max(experts))
               if experts else None}
        out[name] = row
        log(f"phase 19: {name} ({cfg.family}, {cfg.n_layers}/"
            f"{full.n_layers} layers, {row['params'] / 1e9:.3f} B "
            f"parameters, built in {init_s:.2f} s): prefill {b}x{s} "
            f"{row['prefill_ms']:.3f} ms (bound {pre_b:.3f}, {pre_by}), "
            f"decode {row['decode_ms_per_token']:.3f} ms a step (bound "
            f"{dec_b:.3f} ms, {dec_by}: {dec_bytes / 1e9:.3f} GB; host "
            f"enqueue {row['decode_enqueue_ms']:.3f} ms a step), "
            f"{row['tokens_per_s']:.1f} tokens/s, peak "
            f"{row['peak_mem_gb']:.3f} GB; prefill == forward at fp32 "
            f"(max |diff| {check:.2e}); tokens {toks[0, :8].tolist()}")
        del lm, cache, logits, batch, small
        if cuda:
            torch.cuda.empty_cache()
    log(f"phase 19: total {time.time() - t_phase:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# Phase 20: the LM training path.
# ---------------------------------------------------------------------------

#: Card against CPU (one fp32 step) and the bitwise resume: 2-layer cuts
#: at full width.
TRAIN_CUTS = ("llama3.2-1b", "granite-moe-1b-a400m")
#: One timed step each, at full width and half depth (the script's time
#: limit; memory allowing).
TRAIN_OTHERS = ("granite-moe-1b-a400m", "mamba2-780m", "zamba2-2.7b",
                "internvl2-2b", "musicgen-large")
#: The trained load of (b) and (d), and the steps of (b).
TRAIN_LOAD = dict(batch=8, seq_len=512, timed=8)
#: Bytes a parameter the state holds in training: fp32 master, gradient,
#: m and v, and the bf16 compute copy. A config whose state would pass
#: ``TRAIN_MEM_SHARE`` of the card is cut in depth.
TRAIN_BYTES_A_PARAM, TRAIN_MEM_SHARE = 18, 0.85
#: fp32 tolerances of a train step on the card against the CPU: loss and
#: grad norm (relative), and each gradient leaf's largest difference as a
#: share of the leaf's largest magnitude (TF32 off: summation order only).
TRAIN_LOSS_RTOL, TRAIN_GRAD_FRAC = 1e-4, 1e-3


def train_batch(torch, cfg, b: int, s: int, gen, dev):
    """Seeded inputs (tokens or embeddings) and labels."""
    batch = lm_prompts(torch, cfg, b, s, gen, dev)
    batch["labels"] = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                    device=dev, dtype=torch.int32)
    return batch


def train_card_vs_cpu(torch, cfg, dev, seed: int):
    """One fp32 train step (remat full) from the same weights and batch on
    the card and on the CPU: (loss rel. diff, grad norm rel. diff, the
    largest gradient leaf difference as a share of the leaf, that leaf)."""
    from repro_torch import models as tm
    from repro_torch.models.layers import Init
    from repro_torch.optim import OptConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    run = tm.RunConfig(compute_dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=10))
    gen = torch.Generator(device=dev).manual_seed(seed)
    card = tm.init_lm(cfg, gen, dev)
    cpu = tm.LM(cfg, Init(torch.device("cpu")))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = train_batch(torch, cfg, 2, 32, gen, dev)
    out = {}
    for lm in (card, cpu):
        b = {k: v.to(lm.device) for k, v in batch.items()}
        state = init_train_state(cfg, lm, tcfg)
        names, leaves = zip(*lm.named_parameters())
        loss, _ = tm.loss_fn(cfg, lm, b, run)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grads = {n: g.cpu() for n, g in zip(names, grads)}
        _, met = make_train_step(cfg, run, tcfg)(state, b)
        out[lm.device.type] = (float(met["loss"]), float(met["grad_norm"]),
                               grads)
    (lc, nc, gc), (lp, np_, gp) = out[dev.type], out["cpu"]
    worst, at = 0.0, None
    for n, g in gp.items():
        frac = (float((gc[n] - g).abs().max())
                / max(float(g.abs().max()), 1e-30))
        if frac > worst:
            worst, at = frac, n
    return abs(lc - lp) / abs(lp), abs(nc - np_) / abs(np_), worst, at


def train_state_tensors(state):
    """{path: tensor} of a train state, parameters by name."""
    out = {}
    for k, v in state.items():
        if hasattr(v, "named_parameters"):
            v = dict(v.named_parameters())
        if isinstance(v, dict):
            out.update({f"{k}/{p}": t
                        for p, t in train_state_tensors(v).items()})
        else:
            out[k] = v
    return out


def train_resume(torch, cfg, dev, seed: int, root: str):
    """A ``TrainingRunner`` that fails at step 2 (after the checkpoint of
    step 1) against one that does not, 3 steps of 2 × 64 tokens in bf16
    with remat: (bitwise equal, restarts, save seconds, restore seconds,
    checkpoint bytes)."""
    import os
    from repro_torch import models as tm
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.ft import FailureInjector, RunnerConfig, TrainingRunner
    from repro_torch.optim import OptConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    class Timed(TrainingRunner):
        def _save(self, step):
            t0 = time.perf_counter()
            super()._save(step)
            self.io.append(("save", time.perf_counter() - t0))

        def _restore(self):
            t0 = time.perf_counter()
            step = super()._restore()
            self.io.append(("restore", time.perf_counter() - t0))
            return step

    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=3))
    dcfg = DataConfig(seed=seed, seq_len=64, global_batch=2, vocab=cfg.vocab,
                      embeddings_dim=cfg.d_model if cfg.frontend == "stub"
                      else 0)
    outs, io, nbytes = [], [], 0
    for i, fail in enumerate(((), (2,))):
        lm = tm.init_lm(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
        d = os.path.join(root, f"{cfg.name}_{i}")
        r = Timed(make_train_step(cfg, tm.RunConfig(), tcfg),
                  SyntheticLM(dcfg), init_train_state(cfg, lm, tcfg), d,
                  RunnerConfig(total_steps=3, ckpt_every=2),
                  injector=FailureInjector(fail))
        r.io = io
        out = r.run()
        outs.append(({k: v.cpu() for k, v in
                      train_state_tensors(out["state"]).items()},
                     out["restarts"]))
        last = os.path.join(d, "step_00000002")
        nbytes = sum(os.path.getsize(os.path.join(last, f))
                     for f in os.listdir(last))
        del out, r, lm
    (a, _), (b, restarts) = outs
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    return (same, restarts, [t for kind, t in io if kind == "save"],
            [t for kind, t in io if kind == "restore"], nbytes)


def train_profile(torch, fn, sync, top: int = 10):
    """One run of ``fn`` under ``torch.profiler`` (CPU and CUDA activity):
    its wall ms, the device time of its kernels, the device's busy share
    of the wall, the kernel count and the ``top`` ops by device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3

    def dev_us(e):          # an op's own kernels, not its children's
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    ranked = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CPU),
                    key=dev_us, reverse=True)[:top]
    return {"wall_ms": wall, "device_ms": device,
            "busy": device / wall if wall else 0.0,
            "launches": len(kernels),
            "top": [(e.key, dev_us(e) / 1e3) for e in ranked]}


def train_bound_ms(n_params: int, tokens: int):
    """A train step's least time: 8·N·T operations (forward, the remat's
    second forward, backward) at the bf16 peak, in ms."""
    return 8 * n_params * tokens / h100("peak_flops") * 1e3


def mfu(cfg, b: int, s: int, ms: float) -> float:
    """``launch.roofline.model_flops`` of a train step of ``b`` × ``s``
    tokens over ``ms`` at the bf16 peak."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.roofline import model_flops
    return model_flops(cfg, ShapeSpec("train", s, b, "train")) / (
        ms / 1e3 * h100("peak_flops"))


def phase_train(torch, np, ops, dev, seed: int, load=None, root=None):
    """Phase 20: the LM training path on the card (module docstring, item
    20). Returns ({path: launches}, {part: numbers})."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import models as tm
    from repro_torch.configs import get_arch
    from repro_torch.device import as_tensor
    from repro_torch.launch.train import build
    from repro_torch.optim import OptConfig, adamw_update
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    cuda = dev.type == "cuda"
    load = load or TRAIN_LOAD
    b, s, timed = load["batch"], load["seq_len"], load["timed"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def free():
        if cuda:
            torch.cuda.empty_cache()

    t_phase = time.time()
    out, launches = {"card_vs_cpu": {}, "resume": {}, "others": {}}, {}
    # (a) Card against CPU.
    for name in TRAIN_CUTS:
        cfg = lm_cut(get_arch(name), 2)
        t0 = time.time()
        dl, dn, frac, at = train_card_vs_cpu(torch, cfg, dev, seed)
        out["card_vs_cpu"][name] = {"loss_rel": dl, "grad_norm_rel": dn,
                                    "grad_leaf_frac": frac, "leaf": at}
        log(f"phase 20: {name} cut to {cfg.n_layers} layers, one fp32 train "
            f"step card vs CPU: loss {dl:.2e} relative, grad norm {dn:.2e}, "
            f"worst gradient leaf {frac:.2e} of its largest ({at}), in "
            f"{time.time() - t0:.1f} s")
        if not (dl <= TRAIN_LOSS_RTOL and dn <= TRAIN_LOSS_RTOL
                and frac <= TRAIN_GRAD_FRAC):
            raise AssertionError(f"phase 20: {name} card != CPU: {dl}, {dn}, "
                                 f"{frac} ({at})")
        free()

    # (b) llama3.2-1b at full width and depth, fed by the sDTW filter.
    held = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.time()
    cfg, data, state, step = build(
        "llama3.2-1b", "full", "1x1", seq_len=s, global_batch=b, lr=3e-4,
        steps=timed + 1, microbatches=1, compression=None, data_kind="tsa",
        seed=seed, device=dev)
    sync()
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    ops.reset_launches()
    losses, step_ms, filter_ms = [], [], []
    for i in range(timed + 1):
        t0 = time.perf_counter()
        batch = {k: as_tensor(v, dev) for k, v in data.batch_at(i).items()}
        sync()
        t1 = time.perf_counter()
        state, met = step(state, batch)
        sync()
        t2 = time.perf_counter()
        losses.append(float(met["loss"]))
        if i == 0:                     # the warm-up step
            if cuda:
                torch.cuda.reset_peak_memory_stats()
        else:
            filter_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() - held if cuda else 0
    launches["lm_train_tsa_filter"] = dict(ops.LAUNCHES)
    k1 = {k: n for k, n in ops.LAUNCHES.items() if n}
    if cuda and not any(k.endswith("_plain") for k in k1):
        raise AssertionError(f"phase 20: the filter launched no K1 kernel: "
                             f"{k1}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"phase 20: non-finite loss {losses}")
    med = statistics.median(step_ms)
    tokens = b * s
    bound = train_bound_ms(n_params, tokens)
    prof = train_profile(torch, lambda: step(state, batch), sync)
    # Phase 22 (b): one more step under FlopCounterMode, the peak reset.
    from torch.utils.flop_counter import FlopCounterMode
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with counter:
        state, met = step(state, batch)
    sync()
    counted = {"flops": counter.get_total_flops(),
               "peak_bytes": (torch.cuda.max_memory_allocated() - held
                              if cuda else 0)}
    # The AdamW update alone, on the trained state (gradients of its
    # shape), beside its bytes: p, g, m, v read, p, m, v written.
    grads = {n: torch.randn_like(p) for n, p in
             state["params"].named_parameters()}
    opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)

    def adamw():
        adamw_update(opt, state["params"], grads, state["opt"])
    adamw_ms = cuda_ms(adamw) if cuda else float("nan")
    adamw_bound = 28 * n_params / h100("hbm_bw") * 1e3
    out["full"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "tokens_a_step": tokens, "build_s": build_s,
        "step_ms": med, "step_ms_all": step_ms, "tokens_per_s":
        tokens / (med / 1e3), "bound_ms": bound, "bound_share": bound / med,
        "mfu": mfu(cfg, b, s, med), "counted_step": counted,
        "batch": b, "seq_len": s,
        "adamw_ms": adamw_ms, "adamw_bound_ms": adamw_bound,
        "peak_gb": peak / 1e9, "first_loss": losses[0],
        "last_loss": losses[-1], "filter_ms": statistics.median(filter_ms),
        "filter": dict(data.filter_stats), "filter_launches": k1,
        "profile": prof}
    log(f"phase 20: llama3.2-1b full width and depth ({cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters, built in {build_s:.2f} s), "
        f"bf16 remat=full, {b}x{s} tokens fed by TSAFilteredLM: step "
        f"{med:.3f} ms median of {timed} (bound {bound:.3f} ms: 8·N·T at "
        f"989 TFLOP/s; {bound / med:.3f} of it; mfu "
        f"{out['full']['mfu']:.4f}), {tokens / (med / 1e3):.1f} "
        f"tokens/s, AdamW {adamw_ms:.3f} ms (bound {adamw_bound:.3f} ms: "
        f"28 B a parameter at 3.35 TB/s), peak {peak / 1e9:.3f} GB, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; filter "
        f"{out['full']['filter_ms']:.3f} ms a batch, {data.filter_stats}, "
        f"launches {k1}")
    log(f"phase 20: one more step under torch.profiler: {prof['wall_ms']:.3f}"
        f" ms wall, {prof['device_ms']:.3f} ms of device time (busy "
        f"{prof['busy']:.3f}), {prof['launches']} kernel launches; device ms "
        f"by op: " + ", ".join(f"{k} {v:.3f}" for k, v in prof['top']))
    del state, step, data, grads, batch, met
    free()

    # (c) Bitwise resume on the card.
    root = root or tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for name in TRAIN_CUTS:
            cfg = lm_cut(get_arch(name), 2)
            t0 = time.time()
            same, restarts, saves, restores, nbytes = train_resume(
                torch, cfg, dev, seed, root)
            out["resume"][name] = {"bitwise": same, "restarts": restarts,
                                   "save_s": saves, "restore_s": restores,
                                   "bytes": nbytes}
            log(f"phase 20: {name} cut to {cfg.n_layers} layers, a runner "
                f"failing at step 2 against one that does not: bitwise "
                f"{same}, {restarts} restart; checkpoint {nbytes / 1e9:.3f} "
                f"GB, saves {', '.join(f'{t:.2f}' for t in saves)} s, "
                f"restore {', '.join(f'{t:.2f}' for t in restores)} s; in "
                f"{time.time() - t0:.1f} s")
            if not same or restarts != 1:
                raise AssertionError(f"phase 20: {name} resumed run != "
                                     f"uninterrupted ({restarts} restarts)")
            free()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (d) One timed step of each other config.
    total = torch.cuda.get_device_properties(dev).total_memory if cuda \
        else None
    for i, name in enumerate(TRAIN_OTHERS):
        full = get_arch(name)
        cfg = lm_cut(full, max(2, full.n_layers // 2))
        cut = "time"
        while total and cfg.n_layers > 2 and (
                TRAIN_BYTES_A_PARAM * cfg.param_count()
                > TRAIN_MEM_SHARE * total):
            cfg = lm_cut(cfg, cfg.n_layers // 2)
            cut = "time and memory"
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        held = torch.cuda.memory_allocated() if cuda else 0
        # as ``build`` makes a "full" preset: bf16, remat="full"
        tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=2))
        state = init_train_state(cfg, tm.init_lm(cfg, gen, dev), tcfg)
        step = make_train_step(cfg, tm.RunConfig(), tcfg)
        batch = train_batch(torch, cfg, b, s, gen, dev)
        state, met = step(state, batch)                  # warm-up
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - held if cuda else 0
        loss = float(met["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"phase 20: {name}: non-finite loss")
        n_mm = cfg.active_param_count() - (
            0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
        bound = train_bound_ms(n_mm, b * s)
        out["others"][name] = {
            "family": cfg.family, "layers": cfg.n_layers,
            "full_layers": full.n_layers, "cut_for": cut,
            "params": sum(p.numel() for p in state["params"].parameters()),
            "step_ms": ms, "tokens_per_s": b * s / (ms / 1e3),
            "bound_ms": bound, "bound_share": bound / ms,
            "mfu": mfu(cfg, b, s, ms), "peak_gb": peak / 1e9, "loss": loss}
        log(f"phase 20: {name} ({cfg.family}, {cfg.n_layers}/{full.n_layers} "
            f"layers, cut for {cut}): one step "
            f"{ms:.3f} ms (bound {bound:.3f} ms: 8·N·T, N the "
            f"{n_mm / 1e9:.3f} B active matmul parameters; "
            f"{bound / ms:.3f} of it; mfu "
            f"{out['others'][name]['mfu']:.4f}), "
            f"{b * s / (ms / 1e3):.1f} tokens/s, peak {peak / 1e9:.3f} GB, "
            f"loss {loss:.4f}")
        del state, step, batch, met
        free()
    out["seconds"] = time.time() - t_phase
    log(f"phase 20: total {out['seconds']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# Phase 21: the sharded LM.
# ---------------------------------------------------------------------------

#: (b)'s load on the gloo ranks: fp32, 2 × 64 tokens, 2 layers at full
#: width; and the timed steps of (a).
SHARD_LM_LOAD = dict(batch=2, seq_len=64, timed=3)
#: (b)'s tolerances: losses (relative), the MoE paths and GPipe (absolute).
SHARD_LM_RTOL, SHARD_LM_MOE_ATOL, SHARD_LM_PP_ATOL = 2e-5, 2e-5, 1e-5


def stage_gloo_all_gather(torch, dist):
    """In this process, route the functional all-gather of CUDA tensors
    (the op DTensor gathers shards with) through the host and the plain
    ``dist.all_gather_into_tensor`` on its gloo group. torch 2.11's gloo
    crashes the process on the functional all-gather of CUDA tensors
    (ranks sharing one card), while its other collectives and the plain
    c10d all-gather work. Only for phase 21 (b)'s gloo ranks: every group
    there is a gloo group, and any other raises."""
    from torch._C._distributed_c10d import _resolve_process_group

    def all_gather(x, group_size, group_name):
        pg = _resolve_process_group(group_name)
        if dist.get_backend(pg) != "gloo":
            raise RuntimeError("stage_gloo_all_gather serves gloo groups "
                               "only")
        host = x.new_empty((group_size * x.shape[0], *x.shape[1:]),
                           device="cpu")
        dist.all_gather_into_tensor(host, x.contiguous().cpu(), group=pg)
        return host.to(x.device)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    return lib        # the kernel lasts as long as the library object


def sharded_lm_rank(rank, world, port, out_dir, src, seed, device,
                    reduced=False):
    """Phase 21 (b) on one of the gloo ranks (all on the one card): each
    check at full width, 2 layers (``reduced``: the reduced configs, for a
    rehearsal on the CPU); writes the answers and seconds to
    ``out_dir/rank<r>.json``."""
    sys.path.insert(0, src)
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch import models as tm
    from repro_torch.configs import get_arch
    from repro_torch.distributed import Axes, init_multi_host
    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.distributed.pipeline import pipeline_apply, split_stages
    from repro_torch.distributed.sharding import full
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import device_put, tree_shardings
    from repro_torch.models.model import cast_params
    from repro_torch.models.moe import moe_mlp
    from repro_torch.optim import OptConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    init_multi_host(f"localhost:{port}", world, rank, backend="gloo")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    staged = stage_gloo_all_gather(torch, dist) if cuda else None
    run = tm.RunConfig(compute_dtype=torch.float32, remat="none")
    b, s = SHARD_LM_LOAD["batch"], SHARD_LM_LOAD["seq_len"]
    out = {"s": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def free():
        if cuda:
            torch.cuda.empty_cache()

    def timed(name, fn):
        dist.barrier()
        sync()
        t0 = time.time()
        res = fn()
        sync()
        out["s"][name] = time.time() - t0
        return res

    def arch(name):
        return (get_arch(name).reduced() if reduced
                else lm_cut(get_arch(name), 2))

    def loss_of(cfg, params, batch, r=run, axes=None):
        with torch.no_grad():
            return float(full(tm.loss_fn(cfg, params, batch, r, axes)[0]))

    mesh22 = make_mesh((2, 2), ("data", "model"))
    axes22 = Axes.from_mesh(mesh22)
    # llama3.2-1b's loss on (2, 2).
    cfg = arch("llama3.2-1b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    lm = tm.init_lm(cfg, gen, dev)
    batch = train_batch(torch, cfg, b, s, gen, dev)
    want = loss_of(cfg, lm, batch)
    st = device_put({"params": lm}, tree_shardings({"params": lm}, axes22,
                                                   "train"))
    del lm
    got = timed("llama_loss_2x2", lambda: loss_of(cfg, st["params"], batch,
                                                  axes=axes22))
    out["llama"] = {"loss": got, "unsharded": want}
    del st
    free()

    # granite-moe-1b-a400m at capacity_factor 4.0 (no drops): the a2a and
    # replicated MoE paths against the local one; then its train state on
    # (2, 2), a step (the a2a's backward), a checkpoint, and its elastic
    # restore onto (4, 1) with one more step.
    mcfg = dataclasses.replace(arch("granite-moe-1b-a400m"),
                               capacity_factor=4.0)
    mlm = tm.init_lm(mcfg, gen, dev)
    x = torch.randn((2, 8, mcfg.d_model), generator=gen, device=dev)
    xs = {"a2a": x, "replicated": x[:, :1]}
    moe = cast_params(mlm, torch.float32).blocks[0].moe
    with torch.no_grad():
        local = {name: moe_mlp(moe, mcfg, xx)[0] for name, xx in xs.items()}
    del moe
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=10))
    state = init_train_state(mcfg, mlm, tcfg)
    state = device_put(state, tree_shardings(state, axes22, "train"))
    del mlm
    # the model's sharded parameters, the tokens over the data axis
    moe = cast_params(state["params"], torch.float32).blocks[0].moe
    errs = {}
    for name, xx in xs.items():
        with torch.no_grad():
            sharded, _ = timed(f"moe_{name}", lambda: moe_mlp(
                moe, mcfg, axes22.place(xx, "dp", None, None), axes22))
            errs[name] = float((full(sharded) - local[name]).abs().max())
    out["moe"] = errs
    del moe, local
    mbatch = train_batch(torch, mcfg, b, s, gen, dev)
    step = make_train_step(mcfg, run, tcfg, axes22)
    state, met = timed("moe_step_2x2", lambda: step(state, mbatch))
    root = os.path.join(out_dir, "ckpt")
    timed("save_2x2", lambda: ckpt.save(root, 1, state, extra={"step": 1}))
    axes41 = Axes.from_mesh(make_mesh((4, 1), ("data", "model")))
    restored, _, _ = timed("restore_4x1", lambda: ckpt.restore(
        root, state, shardings=tree_shardings(state, axes41, "train")))
    del state, step
    step41 = make_train_step(mcfg, run, tcfg, axes41)
    _, met = timed("moe_step_4x1", lambda: step41(restored, mbatch))
    out["elastic"] = {"loss": float(met["loss"]), "placements": str(
        restored["params"].blocks[0].attn.wq.placements)}
    del restored, step41
    free()

    # phi3-medium-14b (10 KV heads) with pad_heads on (1, 4).
    pcfg = arch("phi3-medium-14b")
    plm = tm.init_lm(pcfg, gen, dev)
    pbatch = train_batch(torch, pcfg, b, s, gen, dev)
    want = loss_of(pcfg, plm, pbatch)
    axes14 = Axes.from_mesh(make_mesh((1, 4), ("data", "model")))
    pst = device_put({"params": plm},
                     tree_shardings({"params": plm}, axes14, "train"))
    del plm
    free()
    got = timed("phi3_pad_loss_1x4", lambda: loss_of(
        pcfg, pst["params"], pbatch,
        dataclasses.replace(run, pad_heads=True), axes14))
    out["phi3"] = {"loss": got, "unsharded": want}
    del pst
    free()

    # compressed_psum against the numpy two-phase formula.
    vals = np.random.default_rng(seed).normal(size=(world, 4096)).astype(
        np.float32)
    flat = make_mesh((world,), ("d",))
    got = timed("compressed_psum", lambda: compressed_psum(
        torch.as_tensor(vals[rank], device=dev), flat.group("d"))).cpu()
    scale = np.maximum(np.abs(vals).max(), np.float32(1e-12)) / \
        np.float32(127)
    q = np.clip(np.rint(vals / scale), -127, 127).astype(np.int32)
    want = q.sum(0).astype(np.float32) * scale / np.float32(world)
    out["psum_bitwise"] = bool(np.array_equal(got.numpy(), want))

    # GPipe over 4 stages against the sequential run.
    pp = make_mesh((world,), ("stage",))
    rng = np.random.default_rng(seed + 1)
    w = torch.as_tensor((rng.normal(size=(8, 256, 256)) / 16).astype(
        np.float32), device=dev)
    xm = torch.as_tensor(rng.normal(size=(6, 4, 256)).astype(np.float32),
                         device=dev)
    got = timed("pipeline", lambda: pipeline_apply(
        lambda lp, h: torch.tanh(h @ lp["w"]), split_stages({"w": w}, world),
        xm, pp, "stage"))
    seq = xm
    for i in range(8):
        seq = torch.tanh(seq @ w[i])
    out["pipeline_err"] = float((got - seq).abs().max())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    del staged


def phase_sharded_lm(torch, np, ops, dev, seed, root, load=None,
                     reduced=False):
    """Phase 21: the sharded LM (module docstring, item 21). Returns
    ({path: launches}, {part: numbers}). ``reduced`` runs (b) on the
    reduced configs (a rehearsal on the CPU)."""
    import torch.distributed as dist

    from repro_torch import models as tm
    from repro_torch.checkpoint.checkpoint import _rebuild, _walk
    from repro_torch.device import as_tensor
    from repro_torch.distributed import Axes, init_multi_host
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import device_put, tree_shardings
    from repro_torch.launch.train import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, make_train_step

    load = load or TRAIN_LOAD
    b, s, timed = load["batch"], load["seq_len"], SHARD_LM_LOAD["timed"]
    cuda = dev.type == "cuda"
    t_phase = time.time()
    out, launches = {}, {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def free():
        if cuda:
            torch.cuda.empty_cache()

    # (a) One NCCL rank: llama3.2-1b at full width and depth through the
    # sharded code path on a (1, 1) mesh, against the unsharded step.
    init_multi_host(f"localhost:{free_port()}", 1, 0,
                    backend="nccl" if cuda else "gloo")
    try:
        held = torch.cuda.memory_allocated() if cuda else 0
        cfg, data, state, step = build(
            "llama3.2-1b", "full", "1x1", seq_len=s, global_batch=b,
            lr=3e-4, steps=timed + 1, microbatches=1, compression=None,
            data_kind="tsa", seed=seed, device=dev)
        ops.reset_launches()
        batches = [{k: as_tensor(v, dev) for k, v in data.batch_at(i).items()}
                   for i in range(timed + 1)]
        sync()
        launches["lm_train_sharded_filter"] = dict(ops.LAUNCHES)
        if cuda and not any(n for k, n in ops.LAUNCHES.items()
                            if k.endswith("_plain")):
            raise AssertionError(f"phase 21: the filter launched no K1 "
                                 f"kernel: {ops.LAUNCHES}")
        n_params = sum(p.numel() for p in state["params"].parameters())
        axes = Axes.from_mesh(make_mesh((1, 1), ("data", "model")))
        # the same state, placed on the mesh (a copy: both take a step)
        twin = _rebuild(state, iter([t.detach().clone()
                                     for _, t in _walk(state)]))
        twin = device_put(twin, tree_shardings(twin, axes, "train"))
        # as ``build`` makes a "full" preset: bf16, remat="full"
        tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=timed + 1))
        sstep = make_train_step(cfg, tm.RunConfig(remat="full",
                                                  attn_mode="dense"), tcfg,
                                axes)
        state, met_u = step(state, batches[0])
        twin, met_s = sstep(twin, batches[0])
        sync()
        loss_u, loss_s = met_u["loss"].cpu(), met_s["loss"].cpu()
        differ, worst = [], 0.0
        for (n, p), (_, q) in zip(state["params"].named_parameters(),
                                  twin["params"].named_parameters()):
            q = q.to_local()
            if not torch.equal(p, q):
                differ.append(n)
                worst = max(worst, float(((p - q).abs()
                                          / p.abs().clamp(min=1e-30)).max()))
        bitwise = bool(torch.equal(loss_u, loss_s)) and not differ
        log(f"phase 21: llama3.2-1b ({cfg.n_layers} layers) first step at "
            f"world 1 (NCCL) on a (1, 1) mesh through Axes.from_mesh against "
            f"the unsharded step from the same state and batch: loss "
            f"{float(loss_s):.6f} vs {float(loss_u):.6f}, masters "
            f"{'bitwise' if not differ else f'{len(differ)} leaves differ, worst {worst:.2e} relative'}")
        if not (bitwise or (float(abs(loss_s - loss_u) / abs(loss_u)) <= 1e-6
                            and worst <= 1e-6)):
            raise AssertionError(f"phase 21: sharded world-1 step != "
                                 f"unsharded: {differ[:5]}, {worst}")
        del state, step
        free()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        host_ms, step_ms, losses = [], [], [float(loss_s)]
        for i in range(1, timed + 1):
            t0 = time.perf_counter()
            twin, met = sstep(twin, batches[i])
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            host_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t0) * 1e3)
            losses.append(float(met["loss"]))
        peak = torch.cuda.max_memory_allocated() - held if cuda else 0
        if not all(np.isfinite(losses)):
            raise AssertionError(f"phase 21: non-finite loss {losses}")
        bound = train_bound_ms(n_params, b * s)
        med = statistics.median(step_ms)
        out["world1"] = {
            "bitwise": bitwise, "differ": differ[:8], "worst_rel": worst,
            "step_ms": med, "step_ms_all": step_ms,
            "host_ms": statistics.median(host_ms), "host_ms_all": host_ms,
            "peak_gb": peak / 1e9, "bound_ms": bound, "bound_share":
            bound / med, "mfu": mfu(cfg, b, s, med), "losses": losses}
        log(f"phase 21: llama3.2-1b sharded (1, 1) NCCL step, bf16 remat "
            f"full, {b}x{s} tokens from TSAFilteredLM: {med:.3f} ms median "
            f"of {timed} (bound {bound:.3f} ms; {bound / med:.3f} of it; "
            f"mfu {out['world1']['mfu']:.4f}), "
            f"host {statistics.median(host_ms):.3f} ms a step to enqueue, "
            f"peak {peak / 1e9:.3f} GB (after the unsharded state is freed),"
            f" losses {[round(x, 4) for x in losses]}")
        del twin, sstep, data, batches
        free()
    finally:
        dist.destroy_process_group()

    out["gloo"] = sharded_lm_gloo(np, dev, seed, root, reduced)
    out["seconds"] = time.time() - t_phase
    log(f"phase 21: total {out['seconds']:.1f} s")
    return launches, out


def sharded_lm_gloo(np, dev, seed, root, reduced=False):
    """Phase 21 (b): the checks on ``GLOO_WORLD`` gloo ranks sharing the
    card (``sharded_lm_rank``); raises on any that fails."""
    import torch.multiprocessing as mp
    work = tempfile.mkdtemp(dir=root / "build")
    t0 = time.time()
    ctx = mp.start_processes(
        sharded_lm_rank, args=(GLOO_WORLD, free_port(), work,
                               str(root / "src"), seed, dev.type, reduced),
        nprocs=GLOO_WORLD, start_method="spawn", join=False)
    deadline = time.time() + 400
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise AssertionError("phase 21: the gloo ranks did not "
                                     "finish within 400 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
    spawn_s = time.time() - t0
    ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
             for r in range(GLOO_WORLD)]
    for r, got in enumerate(ranks):
        for key in ("llama", "phi3"):
            rel = abs(got[key]["loss"] - got[key]["unsharded"]) / abs(
                got[key]["unsharded"])
            if not rel <= SHARD_LM_RTOL:
                raise AssertionError(f"phase 21: rank {r} {key} loss "
                                     f"{got[key]} ({rel:.2e})")
        if not max(got["moe"].values()) <= SHARD_LM_MOE_ATOL:
            raise AssertionError(f"phase 21: rank {r} MoE {got['moe']}")
        if not got["psum_bitwise"]:
            raise AssertionError(f"phase 21: rank {r} compressed_psum != "
                                 f"the two-phase formula")
        if not got["pipeline_err"] <= SHARD_LM_PP_ATOL:
            raise AssertionError(f"phase 21: rank {r} GPipe "
                                 f"{got['pipeline_err']}")
        if not np.isfinite(got["elastic"]["loss"]):
            raise AssertionError(f"phase 21: rank {r} elastic step "
                                 f"{got['elastic']}")
    r0 = ranks[0]
    secs = {k: max(g["s"][k] for g in ranks) for k in r0["s"]}
    log(f"phase 21: {GLOO_WORLD} gloo ranks on the card (fp32, 2 layers at "
        f"full width, {SHARD_LM_LOAD['batch']}x{SHARD_LM_LOAD['seq_len']} "
        f"tokens): llama3.2-1b (2, 2) loss {r0['llama']['loss']:.6f} vs "
        f"unsharded {r0['llama']['unsharded']:.6f}; granite-moe a2a and "
        f"replicated within {r0['moe']} of the local path (cf 4.0); phi3 "
        f"pad_heads (1, 4) loss {r0['phi3']['loss']:.6f} vs "
        f"{r0['phi3']['unsharded']:.6f}; compressed_psum bitwise the "
        f"two-phase formula; GPipe 4 stages within "
        f"{r0['pipeline_err']:.2e} of sequential; granite-moe's (2, 2) "
        f"checkpoint restored onto (4, 1) ({r0['elastic']['placements']}) "
        f"and stepped, loss "
        f"{r0['elastic']['loss']:.4f}; seconds (slowest rank) "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f"; spawned, ran and joined in {spawn_s:.1f} s")
    return {"ranks": GLOO_WORLD, "spawn_s": spawn_s, "seconds": secs,
            "llama": r0["llama"], "phi3": r0["phi3"], "moe_err": r0["moe"],
            "pipeline_err": r0["pipeline_err"], "elastic": r0["elastic"]}


# ---------------------------------------------------------------------------
# Phase 22: the dry run.
# ---------------------------------------------------------------------------

#: (b)'s measured peak against (a)'s predicted live bytes (relative).
DRYRUN_MEM_RTOL = 0.2


def dryrun_cmd(root, out_dir, *flags):
    """``python -m repro_torch.launch.dryrun`` on ``flags`` (a process of
    its own: a fake world is a process's default group), started."""
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(root) / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(out_dir), *flags], env=env, cwd=str(root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryrun_record(proc, out_dir, name: str, timeout: float = 300):
    """The record ``name`` of a finished dry run; raises if it failed."""
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"phase 22: dry run failed ({proc.returncode})"
                             f": {text[-3000:]}")
    rec = json.loads((pathlib.Path(out_dir) / name).read_text())
    if rec["status"] != "ok":
        raise AssertionError(f"phase 22: {name}: {rec}")
    return rec


def phase_dryrun(root, train_out, device=None):
    """Phase 22: the dry run (module docstring, item 22) against phase
    20's measured step. ``device`` is the fake tensors' device type
    (None: the CLI's default, CUDA). Returns {part: numbers}."""
    t_phase = time.time()
    full = train_out["full"]
    b, s = full["batch"], full["seq_len"]
    dev = ["--device", device] if device else []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        # (a) and (d) at once: both run on the host.
        pred = dryrun_cmd(root, tmp, "--arch", "llama3.2-1b", "--shape",
                          "train_4k", "--mesh", "1x1", "--global-batch",
                          str(b), "--seq-len", str(s), "--attn-mode",
                          "dense", "--remat", "full", *dev)
        cli = dryrun_cmd(root, pathlib.Path(tmp) / "cli", "--arch",
                         "llama3.2-1b", "--shape", "train_4k", "--acct",
                         "extrapolated", *dev)
        a = dryrun_record(pred, tmp, "1x1__llama3.2-1b__train_4k.json")
        d = dryrun_record(cli, pathlib.Path(tmp) / "cli",
                          "16x16__llama3.2-1b__train_4k.json")
    live = a["memory_analysis_scanned"]["live_bytes"]
    counted = full["counted_step"]
    flops_a, flops_b = a["cost_analysis"]["flops"], counted["flops"]
    peak = counted["peak_bytes"]
    rel = abs(peak - live) / peak if peak else float("nan")
    out = {"predicted": {"flops": flops_a, "live_bytes": live,
                         "bytes_accessed": a["cost_analysis"][
                             "bytes accessed"], "run_s": a["compile_s"]},
           "measured": {"flops": flops_b, "peak_bytes": peak},
           "peak_vs_live_rel": rel,
           "mfu": full["mfu"], "bound_share": full["bound_share"],
           "model_flops": a["roofline"]["model_flops"]}
    log(f"phase 22 (a)-(b): llama3.2-1b {b}x{s}, 16 layers, bf16 remat full "
        f"on a fake (1, 1) world: {flops_a:.6e} flops, "
        f"{live / 1e9:.3f} GB live (counted in {a['compile_s']} s); the "
        f"real step on the card under FlopCounterMode: {flops_b:.6e} flops, "
        f"peak {peak / 1e9:.3f} GB ({rel:.3f} apart)")
    log(f"phase 22 (c): mfu {full['mfu']:.4f} (model_flops "
        f"{out['model_flops']:.4e} in {full['step_ms']:.3f} ms at 989 "
        f"TFLOP/s) beside the 8·N·T bound's share {full['bound_share']:.4f}")
    log("phase 22 (d): " + json.dumps(d))
    out["cli"] = {"live_bytes": d["memory_analysis_scanned"]["live_bytes"],
                  "fits": d["memory_analysis_scanned"]["fits_80gb_hbm"],
                  "dominant": d["roofline"]["dominant"],
                  "useful": d["roofline"]["useful_flops_ratio"],
                  "run_s": d["compile_s"]}
    if flops_a != flops_b:
        raise AssertionError(f"phase 22: predicted flops {flops_a} != "
                             f"counted {flops_b}")
    if not rel <= DRYRUN_MEM_RTOL:
        raise AssertionError(f"phase 22: peak {peak} vs predicted live "
                             f"{live}: {rel:.3f} apart")
    out["seconds"] = time.time() - t_phase
    log(f"phase 22: total {out['seconds']:.1f} s")
    return out


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
            short = re.search(r"sdtw_(rows|chain|wavefront)_kernel\w+?EE",
                              k)
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
    t0 = time.time()
    n_checks = phase_chain(h, np, rng)
    log(f"phase 3: {n_checks} chain-kernel-vs-plain checks (several warps a "
        f"query) passed in {time.time() - t0:.1f} s (int32 and "
        f"integer-valued float32 bitwise)")

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
    if ecg_launches["chain_span"] < 1:
        raise AssertionError(f"ECG path missed the kernel: {ecg_launches}")
    raw_p = h.plain_raw(qe[:4], re_, track=True)
    h.record("chain_span", h.compare("ECG 4 queries vs plain",
                                    (de[:4], ee[:4], se[:4]), raw_p[:3]))
    if not bool(((de >= 0) & (de < 2**29)).all()):
        raise AssertionError("ECG distances outside [0, INT_BIG)")
    ecg_ms = cuda_ms(lambda: engine.sdtw(qe, re_, return_spans=True), reps=2)
    log(f"phase 6: engine.sdtw(spans) {ecg_ms:.3f} ms end to end, launches "
        f"{ecg_launches}; plain version agrees on 4 queries")

    # Phase 7: long queries, past the rows kernel, through "auto": N = 5000
    # on the chain kernel, N = 9000 (past CHAIN_MAX_N) on the wavefront.
    # One plain run (start lane and last row) holds all three variants.
    long_launches = {}
    for kern, nl, ml, bl in (("chain", 5000, 4000, 8),
                             ("wavefront", 9000, 3000, 4)):
        ref_l = synthetic_timeseries(rng, ml)
        q_l = synthetic_timeseries(rng, bl * nl).reshape(bl, nl)
        ql, rl = (torch.as_tensor(q_l, device=dev),
                  torch.as_tensor(ref_l, device=dev))
        got = {}

        def counted(var):
            torch.cuda.synchronize()
            key = f"{kern}_{var}"
            long_launches[key] = _only(ops, key, f"N={nl} {var}")[key]
        ops.reset_launches()
        got["plain"] = (matsa(ref_l, q_l).distances,)
        counted("plain")
        ops.reset_launches()
        dls, sls, els = engine.sdtw(ql, rl, return_spans=True)
        got["span"] = (dls, els, sls)
        counted("span")
        ops.reset_launches()
        _, lrow, lstart = ops.sdtw_cuda(ql, rl, return_spans=True,
                                        return_lastrow=True, device=dev)
        heap = topk_fold_lastrow(topk_init(bl, k, torch.int32, dev), lrow,
                                 lstart, 0, k, default_excl_zone(torch.full(
                                     (bl,), nl, dtype=torch.int32,
                                     device=dev)))
        counted("lastrow")
        got["lastrow"] = (lrow, lstart)
        raw_p = h.plain_raw(ql, rl, track=True, lastrow=True)
        for var, want in (("plain", raw_p[:1]), ("span", raw_p[:3]),
                          ("lastrow", raw_p[5:])):
            h.record(f"{kern}_{var}", h.compare(
                f"long queries N={nl} {var} vs plain", got[var], want))
        del heap, lrow, lstart, got, raw_p
        log(f"phase 7: N={nl}, {bl} queries against {ml}: matsa, spans and "
            f"top-{k} via the last row on the {kern} kernel == plain")
    log(f"phase 7: launches {long_launches}")

    # Phase 8: every variant of the three kernels at both shapes; the
    # plain version once per variant and shape (the kernels share it), on
    # one batch of the queries (its time grows with the batch).
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
                    **reps_for(kernel, 2 if shape == "ECG-cut" else 3))
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
                **reps_for(kernel, 2))
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
        for kernel in ("chain", "wavefront"):
            h.compare(f"{var} with bans at ECG-cut: rows vs {kernel}",
                      outs["rows"], outs[kernel])
        for kernel, out in outs.items():
            h.record(ops.variant(track, lastrow, kernel, True), h.compare(
                f"{kernel} {var} with bans at ECG-cut, 32 queries vs plain",
                [None if x is None else x[:32] for x in out], pout[0]))
        del outs, pout
        log(f"timing plain version {var} with bans at ECG-cut: {p_ms:.3f} ms "
            f"for one batch of 32 of the {bq_e} queries; the kernels equal "
            f"on all {bq_e} and the plain version on those 32")

    # The other Table V shapes, cut to 4,224 queries (32 warps on each of
    # 132 SMs) and a reference of at most 8e10 cells (at least 20 N
    # samples, and at most 6.4e8 last-row entries): which kernel is the
    # faster in each variant (``choose_kernel``); the three agree bitwise.
    for shape in ("Song", "Penguin", "Seismology", "Power"):
        b_, n_, m_ = table_v_cut(load_real_workload_shapes()[shape])
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
                ms[kernel] = cuda_ms(run, **reps_for(kernel, 2))
            for kernel in ("chain", "wavefront"):
                h.compare(f"{shape} {var} rows vs {kernel}", out["rows"],
                          out[kernel])
            del out
            log(f"timing {var} at {shape} cut ({b_}x{n_} vs {m_}, R="
                f"{ops.resolve_rows(b_, n_, sms=n_sm)[1]}, chain "
                f"{ops.resolve_chain(b_, n_, sms=n_sm)}): rows "
                f"{ms['rows']:.3f} ms, chain {ms['chain']:.3f} ms, wavefront "
                f"{ms['wavefront']:.3f} ms; rows/chain "
                f"{ms['rows'] / ms['chain']:.3f}")
        del qq, rr
    sweep = chain_sweep(torch, np, ops, ref_e, (qe, re_), n_sm, dev)

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
    path_by["stream_ecg"], stream_res = phase_stream(
        torch, np, ops, kpkg, (qe, re_, (de, se, ee)), ls8, dev)
    path_by["align"] = phase_align(torch, np, ops, kpkg,
                                   (queries[:64], reference),
                                   (q_e[:4], ref_e), dev)

    # Phases 12-14: the self-join at ECG's length through the ban.
    sj_paths, _ = phase_self_join(torch, np, ops, kpkg, h, ref_e,
                                   int32_rate, dev)
    path_by.update(sj_paths)
    path_by.update(phase_self_join_direct(torch, np, ops, h, reference, n,
                                          dev))
    path_by.update(phase_self_join_long(torch, np, ops, h, ref_e[:100_000],
                                        1600, "chain", dev))
    path_by.update(phase_self_join_long(torch, np, ops, h, ref_e[:40_000],
                                        9000, "wavefront", dev))
    path_by["profile_pruned"] = phase_profile_pruned(torch, np, ops, kpkg,
                                                     ls_ref, dev)
    path_by["stream_profile"] = phase_stream_profile(torch, np, ops, kpkg,
                                                     ref_e, dev)
    long_paths, long_out = phase_long_windows(torch, np, ops, kpkg, h, ref_e,
                                              int32_rate, dev)
    path_by.update(long_paths)

    # Phases 16-17: the autotuner and the serving tier.
    from repro_torch.core.sdtw import self_join_exclusion
    tune_shapes = {"Human": (qt, rt, "plain", None),
                   "ECG-cut": (qe, re_, "span", None)}
    for w in (512, 2048):
        s_w = np.arange(256) * w
        lo_w, hi_w = self_join_exclusion(s_w, w)
        tune_shapes[f"self-join {w} batch"] = (
            torch.as_tensor(ref_e[s_w[:, None] + np.arange(w)], device=dev),
            re_[:8192], "lastrow", (torch.as_tensor(lo_w, device=dev),
                                    torch.as_tensor(hi_w, device=dev)))
    s64 = np.random.default_rng(4096).choice(me - 4096, 64, replace=False)
    tune_shapes["64 x 4096"] = (
        torch.as_tensor(ref_e[s64[:, None] + np.arange(4096)], device=dev),
        re_, "span", None)
    for shape, variants_ in (("Song", ("plain", "span", "lastrow")),
                             ("Penguin", ("plain",)),
                             ("Seismology", ("plain",)),
                             ("Power", ("plain", "span", "lastrow"))):
        b_, n_, m_ = table_v_cut(load_real_workload_shapes()[shape])
        qq = torch.as_tensor(synthetic_timeseries(rng, b_ * n_).reshape(
            b_, n_), device=dev)
        rr = torch.as_tensor(synthetic_timeseries(rng, m_), device=dev)
        for var in variants_:
            tune_shapes[f"{shape} cut {var}"] = (qq, rr, var, None)
    tune_out = phase_tune(torch, np, ops, tune_shapes, n_sm, dev)
    del tune_shapes
    path_by["serve_human"], serve_out = phase_serve(
        torch, np, ops, (queries, reference), (q_e, ref_e), dev)

    # Phase 18: the sharded engine and stream sessions on torch.distributed.
    path_by.update(phase_sharded(
        torch, np, ops, kpkg,
        (queries, reference, d, (e2e_first_s, matsa_ms)),
        (q_e, ref_e, (stream_res.distances, stream_res.starts,
                      stream_res.positions), ecg_ms / 1e3), dev,
        pathlib.Path(__file__).resolve().parent))

    # Phase 19: the LM serving path, its llama3.2-1b prompts through the
    # sDTW filter.
    lm_paths, lm_out = phase_lm(torch, np, ops, dev, args.seed)
    path_by.update(lm_paths)

    # Phase 20: the LM training path, llama3.2-1b fed by the sDTW filter.
    train_paths, train_out = phase_train(torch, np, ops, dev, args.seed)
    path_by.update(train_paths)

    # Phase 21: the sharded LM, world 1 on NCCL and 4 gloo ranks.
    shard_paths, shard_out = phase_sharded_lm(
        torch, np, ops, dev, args.seed, pathlib.Path(__file__).resolve()
        .parent)
    path_by.update(shard_paths)

    # Phase 22: the dry run against phase 20's step.
    dry_out = phase_dryrun(pathlib.Path(__file__).resolve().parent,
                           train_out)
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
        t_bytes, t_ops = byts / h100("hbm_bw"), ops_ / int32_rate
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes > t_ops else "operations")

    dims = {"Human": (nq, n, m), "ECG-cut": (bq_e, ne, me)}
    for (var, track, lastrow) in variants:
        for shape, ban in (("Human", False), ("ECG-cut", False),
                           ("ECG-cut", True)):
            suffix = "_ban" if ban else ""
            b_ms, b_by = bound(*dims[shape], track, lastrow,
                               banned_cols if ban else 0)
            t = {kern: times[f"{kern}_{var}{suffix}", shape]
                 for kern in ops.KERNELS}
            log(f"bound {var}{suffix} at {shape}: {b_ms:.3f} ms ({b_by}); "
                + ", ".join(f"{kern} {ms / b_ms:.2f}x"
                            for kern, ms in t.items())
                + f"; wavefront/chain {t['wavefront'] / t['chain']:.2f}")
    for case, ms in sweep.items():
        log(f"chain policy {case}: " + ", ".join(
            f"{c} {t:.3f} ms" for c, t in ms.items()))
    for name, res in tune_out.items():
        log(f"tune {name}: " + "; ".join(
            f"{mode} {label} ({src}) {ms:.3f} ms"
            for mode, (label, src, ms) in res.items()))
    log("serve summary: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                      serve_out.items()))
    batch, spans = long_out["batch_ms"], long_out["spans_ms"]
    log(f"phase 15 summary: self-join window 2048 "
        f"{long_out['self_join_s']:.3f} s wall (kernel "
        f"{long_out['self_join_kernel_ms']:.3f} ms; in batches of 256 "
        f"{long_out['self_join_256_s']:.3f} s, kernel "
        f"{long_out['self_join_256_kernel_ms']:.3f} ms); first batch chain "
        f"{batch['chain']:.3f} ms, wavefront {batch['wavefront']:.3f} ms "
        f"({batch['wavefront'] / batch['chain']:.2f}x); 4,096 spans chain "
        f"{spans['chain']:.3f} ms, wavefront {spans['wavefront']:.3f} ms "
        f"({spans['wavefront'] / spans['chain']:.2f}x), K2 bound "
        f"{long_out['spans_bound_ms']:.3f} ms")
    log("lm serving (phase 19): " + json.dumps(lm_out))
    log("lm training (phase 20): " + json.dumps(train_out))
    log("sharded lm (phase 21): " + json.dumps(shard_out))
    log("dry run (phase 22): " + json.dumps(dry_out))
    rows = []
    src = {"rows": "src/repro_torch/kernels/sdtw/csrc/sdtw_rows.cu",
           "chain": "src/repro_torch/kernels/sdtw/csrc/sdtw_chain.cu",
           "wavefront": "src/repro_torch/kernels/sdtw/csrc/sdtw.cu"}
    # Launches summed over the paths that ran (each read from counts set
    # to 0 just before it; ``launches_by_path``); times at the Table V
    # shape of the path that runs the variant at full width, the ban
    # variants at ECG-cut with self-join zones (phase 8).
    path_launches = {key: sum(c.get(key, 0) for c in path_by.values())
                     for key in ops.LAUNCHES}
    missed = [key for key, v in path_launches.items() if not v]
    if missed:
        raise AssertionError(f"no path launched {missed}")
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
