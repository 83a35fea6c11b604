"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``, printed as one JSON line.

Everything a cell needs is found by name from its entry in
BENCHMARK.json: the configuration's file, the traffic mix's file
(``perfbench/traffic/<traffic>.json``), the front door that mix names
(``perfbench/doors/<door>.py``) and one reader a metric
(``perfbench/metrics/<metric>.py``; a name split by a dot, such as
``gcups.human``, is the same quantity under a bound of its own).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import pathlib
import subprocess
import sys
import time


ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Top-level modules a run must never load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a run produced, for the metric readers."""
    answer: str            # what a call returns: "distance" or "span"
    calls: int = 0
    cells: int = 0         # DP cells of the completed calls
    launches: int = 0      # sDTW kernel launches in the window
    setup_s: float = 0.0   # from the process's start to the window's
    window_s: float = 0.0  # from the first call's issue to the last's end
    latencies: list = dataclasses.field(default_factory=list)  # s a call
    trace: object = None   # profiling.Trace of a traced run


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str):
    """The cell's entry, its configuration and its traffic mix."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((ROOT / "perfbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def reported(metrics: list, workload: str) -> list:
    """The metrics of a list that this cell reports."""
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def program():
    """The system under test: the port's front doors and its counter."""
    from types import SimpleNamespace

    from repro_torch.core.matsa_api import matsa
    from repro_torch.kernels.sdtw import ops
    return SimpleNamespace(matsa=matsa,
                           launches=lambda: sum(ops.LAUNCHES.values()))


def reader(metric: str):
    """The reader of a metric: ``perfbench/metrics/<base>.py``, where the
    base is the name before its first dot (``gcups.human`` is ``gcups``
    read in the cells that report that name)."""
    return importlib.import_module(
        f"perfbench.metrics.{metric.split('.')[0]}")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload, seed, seconds, trace, *, device, bench=None,
             overrides=None, t_start=None, control=False):
    """Set up, measure and check one cell. Returns the result dict (the
    ``device`` entry without the card's fields) and the checks, with
    ``control`` also the control's checks on the same answers.
    ``overrides`` updates the configuration and the mix (tests)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark() if bench is None else bench
    cell, cfg, mix = cell_files(bench, workload)
    for part, upd in (overrides or {}).items():
        {"config": cfg, "mix": mix}[part].update(upd)
    prog = program()
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t_data = time.perf_counter()
    door = importlib.import_module(
        f"perfbench.doors.{mix['door']}").make(prog, cfg, mix, seed, dev)
    sync()
    t_warm = time.perf_counter()
    door.warm_up()
    sync()
    print(f"setup: {t_data - t_start:.2f} s to start, {t_warm - t_data:.2f}"
          f" s of data, {time.perf_counter() - t_warm:.2f} s of warm-up",
          file=sys.stderr)

    run = Run(answer=door.answer)
    records, failed, error = [], 0, None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        window_span = record_function("perfbench.window")
        window_span.__enter__()
    launches0 = prog.launches()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    while True:
        ts = time.perf_counter()
        try:
            if trace:
                with record_function("perfbench.call"):
                    rec, cells = door.call(run.calls)
            else:
                rec, cells = door.call(run.calls)
        except Exception as exc:       # a call that fails ends the window
            failed, error = 1, exc
            break
        te = time.perf_counter()
        run.calls += 1
        run.cells += cells
        records.append(rec)
        run.latencies.append(te - ts)
        if te - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.launches = prog.launches() - launches0
    if trace:
        window_span.__exit__(None, None, None)
        t_read = time.perf_counter()
        prof.__exit__(None, None, None)
        from perfbench import profiling
        run.trace = profiling.read(prof) if dev.type == "cuda" else None
        if run.trace is not None:
            print(f"trace: {len(run.trace.device)} device and "
                  f"{len(run.trace.host)} host events, read in "
                  f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if error is not None:
        print(f"a call failed: {error!r}", file=sys.stderr)

    metrics = {}
    for m in reported(bench["per_layer" if trace else "end_to_end"],
                      workload):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": False, "attempted": run.calls + failed,
              "failed": failed, "metrics": metrics,
              "device": {"memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        from perfbench import profiling
        lo, hi = run.trace.window
        result["device"].update(busy_s=run.trace.busy() / 1e9,
                                window_s=(hi - lo) / 1e9)
        result["breakdown"] = profiling.breakdown(run.trace)
    prof = run.trace = None
    checks = door.check(records, seed) if records else {}
    result["correct"] = passes(checks) and failed == 0
    if control:
        return result, checks, door.check(records, seed, lanes=16)
    return result, checks


def passes(checks) -> bool:
    """Whether every number compared is within its limit."""
    return bool(checks) and all(v <= lim for v, lim in checks.values())


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv, t_start) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    bench = load_benchmark()
    cell, _, _ = cell_files(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              args.trace, device="cuda", bench=bench,
                              t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"], **result["device"],
                        "power_limit": _power_limit()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
