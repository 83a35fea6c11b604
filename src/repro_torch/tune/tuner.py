"""The two-stage autotuner and the oracle the engine consults.

Counterpart of ``repro.tune.tuner``. Stage 1 (``mode='model'``, the
default): the analytical ``KernelCostModel`` ranks candidate
configurations for the request's (backend, metric, dtype, pow-2 shape
bucket[, launch variant]); a shipped or recorded ``TuningTable`` entry
overlays the prediction when one exists. Stage 2 (``mode='measure'``):
the top model candidates — on the card always with the hand-set
``tune='off'`` launch among them — are timed on the device (median of
``reps`` runs after one untimed warm-up run, which also takes the
``nvcc`` build at first use; CUDA events on the card) and the winner is
persisted into the process table (and the LRU), so the measurement runs
once per bucket per process. ``mode='off'`` never reaches this module.

Backends (``canonical_backend``): a CUDA device tunes the hand-written
kernels' launch (``'h100'``: kernel, R, warps, queries a block, tile); the
CPU (``'interpret'``) ranks the in-core schedules and the chunk size with
the reference's constants, so it decides as the JAX package decides.

Resolution precedence, everywhere: explicit caller kwargs > measured
table entry > model-source table entry > cost-model prediction.

``python -m repro_torch.tune.tuner --backend h100 --out
src/repro_torch/tune/tables/h100.json --rows-out
src/repro_torch/tune/tables/h100_rows.json`` re-records the card's
shipped table and the kernel times its model is validated against.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Optional

import numpy as np

from .cache import cached
from .cost import (TunedConfig, _pow2_bucket, bucket_key, get_cost_model,
                   launch_label, tuned_n_micro)
from .table import TuningTable, default_table

#: Measured-search bound on the request path: buckets of more DP cells
#: than this keep the model or table decision (recording large buckets is
#: a deliberate offline act: ``record_table``).
MEASURE_CAP_CELLS = 1 << 24
#: Timed repeats per candidate (median taken) after one warm-up run.
MEASURE_REPS = 3


def canonical_backend(backend=None) -> str:
    """The tuning backend of a device: ``'h100'`` for a CUDA device (the
    port's default, ``None``), ``'interpret'`` for every other device.
    Takes a ``torch.device``, a device type string (``'cuda'``,
    ``'cpu'``) or a backend name."""
    if backend is None:
        return "h100"
    name = getattr(backend, "type", backend)
    if name in ("h100", "cuda"):
        return "h100"
    return "interpret"


@dataclasses.dataclass(frozen=True)
class Resolution:
    """One resolved tuning decision for a bucket: the merged winning
    config, the model's ranking (for ``explain=``) and where the winner
    came from (``'model'``, ``'table:model'``, ``'table:measured'``,
    ``'measured'``)."""
    config: TunedConfig
    candidates: tuple
    source: str


def _overlay(base: TunedConfig, entry: TunedConfig) -> TunedConfig:
    """Table entry fields (non-None) win over the model prediction."""
    updates = {k: v for k, v in dataclasses.asdict(entry).items()
               if v is not None and k != "source"}
    return dataclasses.replace(base, **updates)


def _model_config(backend: str, nq: int, n: int, m: int, variant,
                  ban: bool):
    """The cost model's pick and ranking at a bucket shape."""
    model = get_cost_model(backend)
    if backend == "h100":
        ranked = model.cuda_candidates(nq, n, m, variant, ban)
        best, us = ranked[0]
        off = model.cuda_policy(nq, n, m, variant)
        off_us = next(u for c, u in ranked if c == off)
        if us >= MODEL_MARGIN * off_us:
            best, us = off, off_us
        cfg = TunedConfig(impl="pallas", score_us=us, source="model",
                          **best)
        return cfg, tuple((launch_label(c), u) for c, u in ranked)
    ranked = tuple(model.rank_impls(nq, n, m))
    return (TunedConfig(impl=ranked[0][0], chunk=model.best_chunk(nq, n, m),
                        score_us=ranked[0][1], source="model"), ranked)


def resolve(nq: int, n: int, m: int, *, backend=None,
            metric: str = "abs_diff", dtype: str = "int32",
            mode: str = "model", span: bool = False,
            variant: Optional[str] = None, ban: bool = False) -> Resolution:
    """The oracle: LRU -> table -> cost model (-> measured search under
    ``mode='measure'``). Costs are evaluated at the bucket's pow-2 shape
    so every shape in a bucket shares one decision. On the card the
    decision is per launch ``variant`` (``'plain'``, ``'span'`` — the
    default with ``span`` — or ``'lastrow'``); ``ban`` says the launch
    bans columns (the measured search then times the banned
    instantiation)."""
    backend = canonical_backend(backend)
    if backend == "h100":
        variant = variant or ("span" if span else "plain")
    else:
        variant = None
    key = bucket_key(backend, metric, dtype, nq, n, m, variant)

    def compute() -> Resolution:
        nb, nn, nm = (_pow2_bucket(max(1, x)) for x in (nq, n, m))
        cfg, ranked = _model_config(backend, nb, nn, nm, variant, ban)
        source = "model"
        entry = default_table(backend).get(key)
        if entry is not None:
            cfg = _overlay(cfg, entry)
            source = f"table:{entry.source}"
        if mode == "measure" and (entry is None
                                  or entry.source != "measured"):
            measured = measured_search(nb, nn, nm, backend=backend,
                                       metric=metric, dtype=dtype, span=span,
                                       variant=variant, ban=ban,
                                       seed_config=cfg)
            if measured is not None:
                cfg = measured
                default_table(backend).put(key, cfg)
                source = "measured"
        return Resolution(dataclasses.replace(cfg, source=source), ranked,
                          source)

    return cached((key, span, ban, mode), compute)


# ---------------------------------------------------------------------------
# Engine-facing oracle entry points
# ---------------------------------------------------------------------------

def tuned_chunk(nq: int, n: int, m: int, *, backend=None,
                metric: str = "abs_diff", dtype: str = "int32",
                mode: str = "model") -> Optional[int]:
    """Reference tile size for the chunked streaming path; ``None`` on
    the card, whose model prices the kernels only (the chunked route keeps
    ``engine.DEFAULT_CHUNK`` there)."""
    return resolve(nq, n, m, backend=backend, metric=metric, dtype=dtype,
                   mode=mode).config.chunk


def rank_incore(nq: int, n: int, m: int, *, backend=None,
                metric: str = "abs_diff", dtype: str = "int32",
                mode: str = "model") -> Resolution:
    """In-core impl choice (rowscan vs wavefront) for ``choose_impl``."""
    return resolve(nq, n, m, backend=backend, metric=metric, dtype=dtype,
                   mode=mode)


def resolve_n_micro(nq: int, n_dp: int, n_mp: int, *, n: int, m: int,
                    backend=None, metric: str = "abs_diff",
                    dtype: str = "int32", mode: str = "model") -> int:
    """Microbatch count for the sharded systolic schedule: a table entry
    wins (clamped to the schedule's validity envelope), else the
    pipeline-fill default."""
    fill = tuned_n_micro(nq, n_dp, n_mp)
    if mode == "off":
        return fill
    entry = resolve(nq, n, m, backend=backend, metric=metric, dtype=dtype,
                    mode=mode).config.n_micro
    if entry is None:
        return fill
    return max(1, min(int(entry), n_mp, max(1, nq) // max(1, n_dp) or 1))


# ---------------------------------------------------------------------------
# Stage 2: the measured search
# ---------------------------------------------------------------------------

def _bench_data(nq: int, n: int, m: int, dtype: str, device):
    import torch
    rng = np.random.default_rng(1234 + nq + n + m)
    if dtype.startswith("int"):
        q = rng.integers(-100, 100, (nq, n)).astype(np.int32)
        r = rng.integers(-100, 100, (m,)).astype(np.int32)
    else:
        q = rng.standard_normal((nq, n)).astype(np.float32)
        r = rng.standard_normal((m,)).astype(np.float32)
    return (torch.from_numpy(q).to(device), torch.from_numpy(r).to(device))


def _bench_bans(nq: int, n: int, m: int, device):
    """Self-join-like bans: query i loses the 2·n columns around its own
    window, the windows spread over the reference."""
    import torch
    lo = np.linspace(0, max(0, m - n), nq).astype(np.int64) - n // 2
    return (torch.as_tensor(np.maximum(lo, 0), dtype=torch.int32,
                            device=device),
            torch.as_tensor(lo + 2 * n, dtype=torch.int32, device=device))


def _time_median_us(fn, reps: int = MEASURE_REPS, *, cuda: bool) -> float:
    """Median time of ``fn()`` in microseconds after one untimed warm-up
    call (the first call of a CUDA kernel also builds it): CUDA events on
    the card, the host clock on the CPU."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def time_launches(configs, nq: int, n: int, m: int, *,
                  metric: str = "abs_diff", dtype: str = "int32",
                  variant: str = "plain", ban: bool = False,
                  reps: int = MEASURE_REPS) -> list:
    """Time CUDA launch ``configs`` (dicts of ``kernel``, ``rows``,
    ``block_q``, ``block_m``) on the current CUDA device at (nq, n, m) on
    seeded data. Returns ``[(config, us), ...]`` in ``configs``' order."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels.sdtw import _build, ops
    dev = resolve_device(None)
    _build.build()
    q, r = _bench_data(nq, n, m, dtype, dev)
    lo, hi = _bench_bans(nq, n, m, dev) if ban else (None, None)
    out = []
    for cfg in configs:
        def run(cfg=cfg):
            ops.sdtw_cuda(q, r, metric=metric,
                          return_spans=variant != "plain",
                          return_lastrow=variant == "lastrow", device=dev,
                          kernel=cfg["kernel"],
                          rows=(None if cfg["kernel"] == "wavefront"
                                else cfg["rows"]),
                          block_q=cfg["block_q"], block_m=cfg["block_m"],
                          excl_lo=lo, excl_hi=hi)
        out.append((cfg, _time_median_us(run, reps, cuda=True)))
    return out


def cuda_search_configs(nq: int, n: int, m: int, variant: str,
                        ban: bool = False, top: int = 3) -> list:
    """The launches a measured search times: the model's ``top`` best and
    the hand-set ``tune='off'`` launch on the current card."""
    from repro_torch.kernels.sdtw import ops
    ranked = get_cost_model("h100").cuda_candidates(nq, n, m, variant, ban)
    configs = [c for c, _ in ranked[:top]]
    off = ops.launch_config(nq, n, m, sms=ops.sm_count(),
                            span=variant != "plain")
    return configs if off in configs else configs + [off]


def measured_search(nq: int, n: int, m: int, *, backend: str,
                    metric: str = "abs_diff", dtype: str = "int32",
                    span: bool = False, variant: Optional[str] = None,
                    ban: bool = False,
                    seed_config: Optional[TunedConfig] = None,
                    reps: int = MEASURE_REPS, top: int = 3,
                    cap: Optional[int] = MEASURE_CAP_CELLS):
    """Refine the model's top candidates on the device.

    On the card (``'h100'``): time the ``top`` model launches and the
    ``tune='off'`` launch and return the fastest as a
    ``TunedConfig(source='measured')``, or ``None`` when the bucket has
    more than ``cap`` cells (``cap=None``: no bound). On the CPU, as the
    reference: the in-core impl ranking and the top chunk sizes, each
    aspect skipped past its cell bound."""
    seed = seed_config or TunedConfig()
    cells = nq * n * m
    if backend == "h100":
        if cap is not None and cells > cap:
            return None
        timed = time_launches(
            cuda_search_configs(nq, n, m, variant or "plain", ban, top),
            nq, n, m, metric=metric, dtype=dtype, variant=variant or "plain",
            ban=ban, reps=reps)
        best, us = min(timed, key=lambda t: t[1])
        return dataclasses.replace(seed, impl="pallas", score_us=us,
                                   source="measured", **best)
    import functools

    from repro_torch.core.sdtw import sdtw_batch, sdtw_chunked
    model = get_cost_model(backend)
    q, r = _bench_data(nq, n, m, dtype, "cpu")
    best_impl, impl_us = seed.impl, seed.score_us
    if cells <= MEASURE_CAP_CELLS:
        timed = [(impl, _time_median_us(functools.partial(
            sdtw_batch, q, r, None, metric, impl), reps, cuda=False))
            for impl, _ in model.rank_impls(nq, n, m)]
        best_impl, impl_us = min(timed, key=lambda t: t[1])
    best_chunk = seed.chunk
    if m > 4096 and cells <= MEASURE_CAP_CELLS * 4:
        timed = [(c, _time_median_us(functools.partial(
            sdtw_chunked, q, r, None, metric, c), reps, cuda=False))
            for c, _ in model.chunk_candidates(nq, n, m)[:top]]
        best_chunk = min(timed, key=lambda t: t[1])[0]
    return dataclasses.replace(seed, impl=best_impl, chunk=best_chunk,
                               score_us=impl_us, source="measured")


# ---------------------------------------------------------------------------
# Serve-tier pre-tuning (Router.warmup)
# ---------------------------------------------------------------------------

def _torch_dtype(dtype):
    """A tensor's or numpy array's dtype as a torch dtype."""
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _dtype_of(x):
    return x.dtype if hasattr(x, "dtype") else np.asarray(x).dtype


def pretune_request(request) -> int:
    """Resolve the tuning decision of every pow-2 bucket a request's query
    set will dispatch as, on the request's device, priming the LRU (and,
    under ``request.tune='measure'``, the process table) so that the serve
    request path never ranks or measures. Returns the buckets primed."""
    import functools

    import torch

    from repro_torch.core.distances import accum_dtype
    from repro_torch.core.engine import bucketize
    from repro_torch.device import resolve_device
    mode = getattr(request, "tune", "model")
    if mode == "off":
        return 0
    backend = canonical_backend(resolve_device(request.device))
    qs, ref = request.queries, request.reference
    m = tuple(getattr(ref, "shape", np.shape(ref)))[-1]
    ragged = isinstance(qs, (list, tuple))
    dtypes = {_dtype_of(x) for x in (qs if ragged else [qs])}
    dtype = functools.reduce(torch.promote_types, [
        _torch_dtype(d) for d in (*dtypes, _dtype_of(ref))])
    if backend == "h100":
        dtype = accum_dtype(dtype)      # the kernels key on it
    dtype = str(dtype).removeprefix("torch.")
    if ragged:
        buckets = bucketize([len(x) for x in qs])
        shapes = [(len(idxs), blen) for blen, idxs in buckets.items()]
    else:
        shape = tuple(getattr(qs, "shape", np.shape(qs)))
        shapes = [(1, shape[0]) if len(shape) == 1 else shape]
    for nq, n in shapes:
        resolve(nq, n, m, backend=backend, metric=request.metric,
                dtype=dtype, mode=mode, span=bool(request.return_spans))
    return len(shapes)


# ---------------------------------------------------------------------------
# Table recording CLI
# ---------------------------------------------------------------------------

#: The CPU table's shapes: the reference's committed bench shapes.
DEFAULT_RECORD_SHAPES = ((2, 16, 256), (4, 32, 1024), (8, 64, 4096),
                         (4, 32, 16384), (8, 16, 4096), (4, 32, 262144))

#: The card's table: the launches of ``chip_smoke.py``'s main paths
#: ``(nq, n, m, variant, ban)`` — Table V "Human" (131,072 × 120 against
#: 7,997), ECG-cut (256 × 512 against 1.8·10⁶), the self-join's batches
#: of 256 windows of 512 and of 2,048 against a slice of 8,192 columns
#: (banned), 64 × 4,096 spans against 1.8·10⁶, and the other Table V
#: shapes cut to 4,224 queries (phase 8).
H100_RECORD_SHAPES = tuple(
    [(131072, 120, 7997, v, False) for v in ("plain", "span", "lastrow")]
    + [(256, 512, 1_800_000, v, False) for v in ("plain", "span",
                                                  "lastrow")]
    + [(256, 512, 8192, "lastrow", True), (256, 2048, 8192, "lastrow", True),
       (64, 4096, 1_800_000, "span", False)]
    + [(4224, n, m, v, False) for n, m in ((200, 20234), (800, 23674),
                                           (64, 151515), (1536, 30720))
       for v in ("plain", "span", "lastrow")])

#: Launches ``record_table`` times a card shape: the model's best few,
#: every launch it predicts within this factor of its best, and each
#: kernel's best (so every kernel and variant has measured rows to fit).
RECORD_TOP, RECORD_WITHIN = 4, 2.0
#: On the card the model leaves the hand-set launch only for one it
#: predicts at least this much faster: its fit's median error over the
#: recorded rows is ~8 % (PERF.md §6), so a smaller predicted gain is not
#: one.
MODEL_MARGIN = 0.9


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def record_table(backend: str, shapes=None, *, reps: int = MEASURE_REPS,
                 provenance: str = ""):
    """Measure every shape bucket; returns ``(TuningTable, rows)`` where
    ``rows`` lists every timed CUDA launch (``validate``'s input; empty
    on the CPU). Past ``MEASURE_CAP_CELLS``: this is the offline act."""
    table = TuningTable(backend, provenance=provenance)
    rows = []
    if backend != "h100":
        for nq, n, m in shapes or DEFAULT_RECORD_SHAPES:
            nb, nn, nm = (_pow2_bucket(x) for x in (nq, n, m))
            seed, _ = _model_config(backend, nb, nn, nm, None, False)
            cfg = measured_search(nb, nn, nm, backend=backend,
                                  seed_config=seed, reps=reps)
            key = bucket_key(backend, "abs_diff", "int32", nq, n, m)
            table.put(key, cfg)
            print(f"recorded {key}: {cfg.to_json()}", flush=True)
        return table, rows
    from repro_torch.kernels.sdtw import ops
    model = get_cost_model("h100")
    for nq, n, m, variant, ban in shapes or H100_RECORD_SHAPES:
        ranked = model.cuda_candidates(nq, n, m, variant, ban)
        configs = [c for i, (c, us) in enumerate(ranked)
                   if i < RECORD_TOP or us <= RECORD_WITHIN * ranked[0][1]]
        off = ops.launch_config(nq, n, m, sms=ops.sm_count(),
                                span=variant != "plain")
        for extra in [off] + [next(c for c, _ in ranked if c["kernel"] == k)
                              for k in {c["kernel"] for c, _ in ranked}]:
            configs += [] if extra in configs else [extra]
        timed = time_launches(configs, nq, n, m, variant=variant, ban=ban,
                              reps=reps)
        for cfg, us in timed:
            rows.append({**cfg, "variant": variant, "ban": ban, "nq": nq,
                         "n": n, "m": m, "us": us, "off": cfg == off})
        best, us = min(timed, key=lambda t: t[1])
        key = bucket_key("h100", "abs_diff", "int32", nq, n, m, variant)
        table.put(key, TunedConfig(impl="pallas", score_us=us,
                                   source="measured", **best))
        off_us = next(u for c, u in timed if c == off)
        print(f"recorded {key}: {launch_label(best)} {us:.1f} us; off "
              f"{launch_label(off)} {off_us:.1f} us; {len(timed)} timed",
              flush=True)
    return table, rows


def _parse_shape(text: str, backend: str) -> tuple:
    """``nq,n,m`` (CPU) or ``nq,n,m[,variant[,ban]]`` (card; ban 0/1)."""
    parts = text.split(",")
    shape = tuple(int(x) for x in parts[:3])
    if backend != "h100":
        return shape
    variant = parts[3] if len(parts) > 3 else "plain"
    return shape + (variant, len(parts) > 4 and parts[4] == "1")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default=None,
                    help="'h100' (the card) or 'interpret' (the CPU); "
                         "default: the card")
    ap.add_argument("--out", required=True, help="table JSON path")
    ap.add_argument("--rows-out", default=None,
                    help="also write every timed CUDA launch here "
                         "(the rows validate reads)")
    ap.add_argument("--shapes", default=None,
                    help="semicolon-separated nq,n,m triples (CPU) or "
                         "nq,n,m,variant,ban tuples (card)")
    ap.add_argument("--reps", type=int, default=MEASURE_REPS)
    args = ap.parse_args(argv)
    backend = canonical_backend(args.backend)
    shapes = None
    if args.shapes:
        shapes = tuple(_parse_shape(s, backend)
                       for s in args.shapes.split(";"))
    if backend == "h100":
        import torch
        provenance = (f"median-of-{args.reps} CUDA-event kernel times on "
                      f"{card_name()} ({torch.cuda.get_device_name(0)}, "
                      f"torch {torch.__version__}, CUDA "
                      f"{torch.version.cuda})")
    else:
        import platform
        provenance = (f"median-of-{args.reps} measured on "
                      f"{platform.machine()} ({backend})")
    table, rows = record_table(backend, shapes, reps=args.reps,
                               provenance=provenance)
    table.save(args.out)
    print(f"wrote {len(table)} entries to {args.out}")
    if args.rows_out:
        with open(args.rows_out, "w") as f:
            json.dump({"provenance": provenance, "rows": rows}, f, indent=1)
            f.write("\n")
        print(f"wrote {len(rows)} timed launches to {args.rows_out}")


if __name__ == "__main__":
    main()
