"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``): run every
(arch × shape × mesh) cell once on the production mesh, as one rank of
a fake world, and record per-rank flops, bytes, collectives and live
memory for the roofline and the fit check.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --acct extrapolated [--device cpu]

The reference compiles each cell for 512 placeholder XLA host devices.
Here the process joins a ``fake`` process group of 256 ranks (512 with
the multi-pod mesh) as rank 0, builds the port's ``make_production_mesh``
over it, and runs ``launch.specs.build_cell``'s step once under
``FakeTensorMode``: tensors carry shapes, dtypes and devices but no
storage, and collectives complete without a message. Rank 0's view
stands for every rank's (the step is SPMD and every sharded dim divides
evenly). Tensors are fake ``cuda`` tensors unless ``--device`` names
another type (``cpu`` in the tests); no card is used either way.

Accounting (``roofline.LocalCounter``, per rank): the flops, bytes and
collective result bytes of the rank's local ops; live bytes are the
peak of live storage over the step — the placed arguments (the state's
shards, the batch, the cache), the outputs and the temporaries, with
in-place updates of the arguments counted once (the port's steps update
their state in place, as a JAX step with donated buffers does). The
train step's AdamW ``Workspace`` (its four fp32 buffers, kept by the
step) is among the temporaries. ``fits_80gb_hbm`` compares the live
bytes with ``H100["hbm_bytes"]``. The counts come from fake tensors and
are priced at the H100's datasheet rates: nothing is timed.

``--acct unrolled`` runs the cell at full depth; ``--acct extrapolated``
runs it at one and two layer units (one hybrid group, else one layer)
and extrapolates every count linearly to full depth (the reference's
two-point rule, applied here to live bytes too; a decode cut keeps the
full-depth cell's cache dtype, which the reference's cut does not: a
cut of one or two layers does not pass the fp8 cache's budget). The
production
attention mode is counted as it is: eager PyTorch hides no loop body
from the counter, so the reference's switch to "dense" for accounting is
not made. ``scan_layers`` changes nothing here.

Each record has the reference's form; an exception makes the cell
``status: "error"`` (the CLI then exits 1), and a quadratic
architecture's ``long_500k`` cell is ``skipped``. One process holds one
default process group, so a dry run lives in a process of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import SHAPES, all_archs, get_arch
from ..distributed.sharding import Axes
from .mesh import make_mesh, make_production_mesh
from .roofline import H100, LocalCounter, model_flops, roofline
from .specs import _maybe_fp8_cache, build_cell, run_config_for

#: Keys of a memory record that scale with depth.
_MEM_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
             "live_bytes")


def init_fake_world(world: int):
    """Join a ``fake`` process group of ``world`` ranks as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@contextlib.contextmanager
def _fake_dtensor(counter: LocalCounter):
    """DTensor under ``FakeTensorMode``: its sharding propagation and the
    index arithmetic of a strided shard run with fake tensors turned off
    (they compute offsets with small index tensors and read them back,
    which a fake tensor cannot), and the counter counts nothing of the
    propagation's own ops on global shapes."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types

    def planned(fn):
        def wrapped(*args, **kwargs):
            with counter.planning(), unset_fake_temporarily():
                return fn(*args, **kwargs)
        return wrapped

    prop = DTensor._op_dispatcher.sharding_propagator
    saved = []
    for name in ("propagate", "propagate_op_sharding",
                 "propagate_op_sharding_non_cached"):
        if hasattr(prop, name):
            had = name in vars(prop)
            saved.append((prop, name, vars(prop).get(name), had))
            setattr(prop, name, planned(getattr(prop, name)))
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and hasattr(strided,
                                       "local_shard_size_and_offset"):
        saved.append((strided, "local_shard_size_and_offset",
                      strided.__dict__["local_shard_size_and_offset"], True))
        orig = strided.local_shard_size_and_offset

        def offsets(*args, **kwargs):
            with unset_fake_temporarily():
                return orig(*args, **kwargs)
        strided.local_shard_size_and_offset = offsets
    try:
        yield
    finally:
        for obj, name, old, had in reversed(saved):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)


def fake_step(cfg, shape, axes, overrides=None, tcfg=None,
              serve_param_mode="train", kv_layout="dh",
              device="cuda") -> dict:
    """One fake run of the cell's step on this rank → its counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models import layers
    dev = torch.device(device)
    if axes.mesh is not None:
        axes.mesh.device_mesh(dev.type)   # made outside the fake mode
    counter = LocalCounter()
    layers._rope_frequencies_on.cache_clear()
    try:
        with _fake_dtensor(counter), \
                FakeTensorMode(allow_non_fake_inputs=True):
            cell = build_cell(cfg, shape, axes, overrides, tcfg=tcfg,
                              serve_param_mode=serve_param_mode,
                              kv_layout=kv_layout, device=dev)
            placed = cell.place(*cell.args)
            cell.args = None
            with counter:
                args = counter.track(placed)
                out = cell.step(*placed)
            a_keys = counter.storages(placed)
            o_keys = counter.storages(out)
    finally:
        layers._rope_frequencies_on.cache_clear()
    outs = sum(o_keys.values())
    alias = sum(n for k, n in o_keys.items() if k in a_keys)
    peak = counter.peak_bytes
    mem = {"argument_bytes": args, "output_bytes": outs,
           "temp_bytes": peak - (args + outs - alias),
           "alias_bytes": alias, "live_bytes": peak}
    run = {k: str(v)[6:] if isinstance(v, torch.dtype) else v
           for k, v in dataclasses.asdict(cell.run).items()}
    return {"flops": float(counter.flops),
            "bytes": float(counter.bytes_accessed),
            "collectives": counter.collectives(), "memory": mem,
            "description": cell.description, "run_config": run}


def _extrapolate(cfg, run_one) -> dict:
    """Two-point extrapolated accounting: run at ``unit`` and ``2·unit``
    layers (unit = one hybrid group, else one layer); with U_a = out +
    body and U_b = out + 2·body, the full-depth total is out + s·body =
    (2−s)·U_a + (s−1)·U_b, s = n_layers/unit. Applies to flops, bytes,
    per-kind collective bytes and counts, and the memory record."""
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    scale = cfg.n_layers // unit
    a = run_one(dataclasses.replace(cfg, n_layers=unit))
    b = run_one(dataclasses.replace(cfg, n_layers=2 * unit))

    def extra(x, y):
        return max(0.0, (2 - scale) * x + (scale - 1) * y)
    coll = {"bytes": {k: int(extra(a["collectives"]["bytes"][k],
                                   b["collectives"]["bytes"][k]))
                      for k in a["collectives"]["bytes"]},
            "counts": {k: int(extra(a["collectives"]["counts"][k],
                                    b["collectives"]["counts"][k]))
                       for k in a["collectives"]["counts"]}}
    coll["total_bytes"] = sum(coll["bytes"].values())
    return {"flops": extra(a["flops"], b["flops"]),
            "bytes": extra(a["bytes"], b["bytes"]), "collectives": coll,
            "run_config": a["run_config"],
            "memory": {k: int(extra(a["memory"][k], b["memory"][k]))
                       for k in _MEM_KEYS}}


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def dry_run_cell(arch_name: str, shape_name: str, multi_pod: bool,
                 run_overrides=None, mesh=None,
                 serve_param_mode: str = "train", kv_layout: str = "dh",
                 acct: str = "unrolled", microbatches: int = 1,
                 device="cuda", shape=None) -> dict:
    """The record of one cell (``shape`` replaces ``SHAPES[shape_name]``,
    e.g. with another batch or length)."""
    cfg = get_arch(arch_name)
    shape = shape or SHAPES[shape_name]
    rec = {"arch": arch_name, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "status": "skipped", "reason": None}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        rec["reason"] = ("full-attention arch: no sub-quadratic path at 500k "
                         "context (DESIGN.md §Arch-applicability)")
        return rec
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec["mesh"] = _mesh_name(mesh)
    if shape is not SHAPES.get(shape_name):
        rec.update(seq_len=shape.seq_len, global_batch=shape.global_batch)
    axes = Axes.from_mesh(mesh)
    n_chips = mesh.size
    tcfg = None
    if microbatches > 1:
        from ..train import TrainConfig
        tcfg = TrainConfig(microbatches=microbatches)
        rec["microbatches"] = microbatches
    try:
        t0 = time.time()
        # the cache dtype of the full-depth cell: a cut of one or two
        # layers would not pass _maybe_fp8_cache's budget on its own
        full_run = _maybe_fp8_cache(cfg, shape, axes,
                                    run_config_for(shape, run_overrides))
        if shape.kind == "decode":
            run_overrides = dict(run_overrides or {},
                                 cache_dtype=full_run.cache_dtype)

        def run_one(c):
            return fake_step(c, shape, axes, run_overrides, tcfg,
                             serve_param_mode, kv_layout, device)
        if acct == "extrapolated":
            got = _extrapolate(cfg, run_one)
            mem_rec = {"note": "two-point extrapolation over 1 and 2 "
                               "layer units: memory_analysis_scanned"}
            description = f"{shape.kind}_step {cfg.name} {shape.name}"
        else:
            got = run_one(cfg)
            mem_rec = dict(got["memory"])
            description = got["description"]
        mem = dict(got["memory"])
        mem["fits_80gb_hbm"] = bool(mem["live_bytes"] <= H100["hbm_bytes"])
        if shape.kind == "train":
            mem["note"] = ("temporaries include the AdamW Workspace the "
                           "step keeps")
        mf = model_flops(cfg, shape)
        terms = roofline(got["flops"], got["bytes"],
                         got["collectives"]["total_bytes"], mf, n_chips)
        rec.update(
            status="ok",
            accounting=acct,
            description=description,
            run_config=got["run_config"],
            compile_s=round(time.time() - t0, 2),
            cost_analysis={"flops": got["flops"],
                           "bytes accessed": got["bytes"]},
            memory_analysis=mem_rec,
            memory_analysis_scanned=mem,
            collectives=got["collectives"],
            roofline=terms.to_dict(),
            device=str(torch.device(device)),
            counts="per rank, from fake tensors; priced at H100 "
                   "datasheet rates")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    return rec


def _parse_mesh(text: str):
    dims = tuple(int(x) for x in text.split("x"))
    return dims, ("pod", "data", "model")[-len(dims):]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="another mesh, e.g. 1x1 or 4x4 (axes (pod,) "
                         "data, model); default the production mesh")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="replace the shape's global batch")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="replace the shape's sequence length")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--attn-mode", default=None,
                    help="override attention mode (dense|chunked|triangular)")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--pad-heads", action="store_true")
    ap.add_argument("--serve-params", default="train",
                    choices=["train", "serve"],
                    help="decode/prefill param sharding: 2-D (train) or "
                         "TP-only (serve)")
    ap.add_argument("--kv-layout", default="dh", choices=["dh", "seq"],
                    help="model-axis placement for indivisible-kv caches")
    ap.add_argument("--acct", default="unrolled",
                    choices=["unrolled", "extrapolated"],
                    help="flop/collective accounting: the full-depth fake "
                         "run or 2-point layer extrapolation (fast)")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (default cuda; "
                         "no card is used)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.attn_mode:
        overrides["attn_mode"] = args.attn_mode
    if args.remat:
        overrides["remat"] = args.remat
    if args.pad_heads:
        overrides["pad_heads"] = True

    if args.all:
        cells = [(a, s) for a in all_archs() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    if args.mesh:
        dims, names = _parse_mesh(args.mesh)
        meshes = [(len(dims) == 3, dims, names)]
    else:
        pods = [False, True] if args.both_meshes else [args.multi_pod]
        meshes = [(mp, (2, 16, 16) if mp else (16, 16),
                   ("pod", "data", "model") if mp else ("data", "model"))
                  for mp in pods]
    init_fake_world(max(math.prod(dims) for _, dims, _ in meshes))

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_err = n_skip = 0
    for multi_pod, dims, names in meshes:
        mesh = make_mesh(dims, names)
        mesh_name = _mesh_name(mesh)
        for a, s in cells:
            shape = SHAPES[s]
            if args.global_batch or args.seq_len:
                shape = dataclasses.replace(
                    shape, global_batch=args.global_batch or
                    shape.global_batch, seq_len=args.seq_len or
                    shape.seq_len)
            rec = dry_run_cell(a, s, multi_pod, overrides or None,
                               mesh=mesh, serve_param_mode=args.serve_params,
                               kv_layout=args.kv_layout, acct=args.acct,
                               microbatches=args.microbatches or 1,
                               device=args.device, shape=shape)
            fn = os.path.join(args.out, f"{mesh_name}__{a}__{s}.json")
            with open(fn, "w") as f:
                json.dump(rec, f, indent=1)
            tag = rec["status"].upper()
            n_ok += tag == "OK"
            n_err += tag == "ERROR"
            n_skip += tag == "SKIPPED"
            extra = ""
            if rec["status"] == "ok":
                r = rec["roofline"]
                m = rec["memory_analysis_scanned"]
                extra = (f"run={rec['compile_s']}s "
                         f"dom={r['dominant']} "
                         f"terms(c/m/x)={r['compute_s']:.2e}/"
                         f"{r['memory_s']:.2e}/{r['collective_s']:.2e}s "
                         f"useful={r['useful_flops_ratio']:.2f} "
                         f"live={m['live_bytes'] / 1e9:.2f}GB "
                         f"fits={m['fits_80gb_hbm']}")
            elif rec["status"] == "error":
                extra = rec["error"][:160]
            print(f"[{tag:7s}] {mesh_name} {a:24s} {s:12s} {extra}",
                  flush=True)
    print(f"done: ok={n_ok} err={n_err} skipped={n_skip}", flush=True)
    dist.destroy_process_group()
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
