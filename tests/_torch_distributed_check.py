"""Rank bodies for the multi-rank tests of the port's sharded sDTW engine
(``tests/test_torch_distributed.py``); pytest does not collect this file.

    python tests/_torch_distributed_check.py CASE.npz OUT_DIR --world 8 \\
        --mesh 2,4 [--axes dp,mp] [--kernel-route] [--device cuda]

starts ``--world`` gloo ranks on the CPU (``torch.multiprocessing``,
spawn), which meet through a file in ``OUT_DIR``. Every rank runs
``check_sdtw`` on the mesh — the body of ``tests/_distributed_check.py``'s
``check_sdtw`` (batch, top-K in both exclusion modes, positions, spans,
the sharded stream in both modes with snapshot and restore) and its
section 12 schedule sweep over ``CASE['sweep']`` — on the inputs in
``CASE.npz`` and writes what it got, and the kernel launches it made, to
``OUT_DIR/rank<r>.npz``. The tests hold every rank's answers against the
JAX package's (on the CPU) or the port's CPU answers (on the card).
``--kernel-route`` scores each rank's segment through the kernel's chunk
carry (its plain version on CPU tensors) instead of the row scan;
``--device cuda`` puts every rank on the card (the CUDA kernels, carries
staged through the host by gloo). Imports no JAX.
"""
import argparse
import os
import sys
import traceback

import numpy as np


def make_case(sweep=(1, 2, 4, 8)):
    """The inputs of ``tests/_distributed_check.py::check_sdtw`` and its
    section 12, drawn as it draws them, and the ``n_micro`` sweep."""
    rng8 = np.random.default_rng(42)
    case = {}
    for dt in ("int32", "float32"):
        case[f"q8_{dt}"] = rng8.integers(-40, 40, (8, 6)).astype(dt)
        case[f"r8_{dt}"] = rng8.integers(-40, 40, 97).astype(dt)
    for name, lo, shape in (("9", 40, (8, 6)), ("10", 8, (8, 6)),
                            ("11", 8, (8, 6)), ("12", 40, (17, 6))):
        case[f"q{name}"] = rng8.integers(-lo, lo, shape).astype(np.int32)
        case[f"r{name}"] = rng8.integers(-lo, lo, 97).astype(np.int32)
    case["sweep"] = np.asarray(sweep)
    return case


def run_ranks(case, out_dir, world, shape, *, axes=None, kernel=False,
              device="cpu", timeout=300):
    """Run this file on ``case`` with ``world`` ranks on mesh ``shape``
    in a subprocess; returns every rank's answers (raises with the ranks'
    tracebacks when one fails)."""
    import pathlib
    import subprocess
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "case.npz"
    np.savez(path, **case)
    root = pathlib.Path(__file__).resolve().parents[1]
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), str(path),
           str(out_dir), "--world", str(world),
           "--mesh", ",".join(map(str, shape)), "--device", device]
    if axes:
        cmd += ["--axes", ",".join(axes)]
    if kernel:
        cmd.append("--kernel-route")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(root / "src")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    errs = "".join(p.read_text() for p in sorted(out_dir.glob("*.err")))
    if res.returncode != 0:
        raise AssertionError(res.stdout + res.stderr + errs)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def check_sdtw(mesh, case, device="cpu"):
    """Every answer of the check body on ``mesh``, by name (numpy)."""
    from repro_torch.core import sdtw
    from repro_torch.core import stream as open_stream
    from repro_torch.kernels.sdtw import ops
    from repro_torch.stream import ShardedStreamSession

    def run(*a, **kw):
        return sdtw(*a, mesh=mesh, device=device, **kw)

    def stream(*a, **kw):
        return open_stream(*a, device=device, **kw)

    ops.reset_launches()

    out = {}
    for dt in ("int32", "float32"):
        out[f"batch_{dt}"] = run(case[f"q8_{dt}"], case[f"r8_{dt}"],
                                 chunk=8)
    q9, r9 = case["q9"], case["r9"]
    out["topk_d"], out["topk_p"] = run(q9, r9, chunk=8, top_k=3,
                                       excl_zone=4)
    out["pos_d"], out["pos_p"] = run(q9, r9, chunk=8, return_positions=True)
    q10, r10 = case["q10"], case["r10"]
    for name, x in zip(("d", "s", "e"),
                       run(q10, r10, chunk=8, return_spans=True)):
        out[f"spans_{name}"] = x
    for mode in ("end", "span"):
        for name, x in zip(("d", "s", "e"),
                           run(q10, r10, chunk=8, top_k=3, excl_zone=4,
                               excl_mode=mode, return_spans=True)):
            out[f"topk_spans_{mode}_{name}"] = x

    q11, r11 = case["q11"], case["r11"]
    sh = stream(q11, mesh=mesh, chunk=4)
    for off in range(0, len(r11), 17):
        sh.feed(r11[off:off + 17])
    out["stream_plain"] = sh.results().distances
    for mode in ("end", "span"):
        sh = stream(q11, mesh=mesh, chunk=4, top_k=3, excl_zone=4,
                    excl_mode=mode, return_spans=True)
        for off in range(0, len(r11), 13):
            sh.feed(r11[off:off + 13])
        res = sh.results()
        for f in ("distances", "starts", "positions"):
            out[f"stream_{mode}_{f}"] = getattr(res, f)
    # Snapshot mid-stream, restore, keep feeding: the same tail.
    sh = stream(q11, mesh=mesh, chunk=4, top_k=3, return_spans=True)
    sh.feed(r11[:64])
    snap = sh.snapshot()
    sh2 = ShardedStreamSession.restore(snap, mesh=mesh, device=device)
    sh.feed(r11[64:])
    sh2.feed(r11[64:])
    for tag, s in (("live", sh), ("restored", sh2)):
        res = s.results()
        for f in ("distances", "starts", "positions"):
            out[f"snap_{tag}_{f}"] = getattr(res, f)
    for key, val in snap.items():
        out[f"snapshot_{key}"] = val

    q12, r12 = case["q12"], case["r12"]
    for nm in case["sweep"].tolist():
        for name, x in zip(("d", "s", "e"),
                           run(q12, r12, chunk=8, n_micro=nm, top_k=3,
                               excl_zone=4, return_spans=True)):
            out[f"sweep{nm}_{name}"] = x
    out["launch_keys"] = np.array(sorted(ops.LAUNCHES))
    out["launch_counts"] = np.array([ops.LAUNCHES[k]
                                     for k in sorted(ops.LAUNCHES)])
    return {k: v.cpu().numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in out.items()}


def rank_main(rank, world, out_dir, case_path, mesh_shape, axes, kernel,
              device):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        from repro_torch.distributed import get_mesh, init_multi_host
        init_multi_host(f"file://{os.path.join(out_dir, 'rdzv')}", world,
                        rank, backend="gloo")
        if kernel:
            import repro_torch.distributed.sdtw_sharded as shmod
            shmod._kernel_route = lambda device: True
        case = dict(np.load(case_path))
        mesh = get_mesh(mesh_shape, axes)
        got = check_sdtw(mesh, case, device)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("case")
    ap.add_argument("out_dir")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--axes", default=None)
    ap.add_argument("--kernel-route", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp
    shape = tuple(int(x) for x in args.mesh.split(","))
    axes = None if args.axes is None else tuple(args.axes.split(","))
    ctx = mp.start_processes(
        rank_main, args=(args.world, args.out_dir, args.case, shape, axes,
                         args.kernel_route, args.device),
        nprocs=args.world, start_method="spawn", join=False)
    while not ctx.join():
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
