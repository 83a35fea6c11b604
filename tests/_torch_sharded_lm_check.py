"""Rank bodies for the multi-rank tests of the port's sharded LM
(``tests/test_torch_sharded_lm.py``); pytest does not collect this file.

    python tests/_torch_sharded_lm_check.py CASE.npz OUT_DIR --world 8
    python tests/_torch_sharded_lm_check.py CASE.npz OUT_DIR --world 4 \\
        --launch -- <repro_torch.launch.train flags>
    python tests/_torch_sharded_lm_check.py CASE.npz OUT_DIR --world 2 \\
        --runner

starts ``--world`` gloo ranks on the CPU (``torch.multiprocessing``,
spawn), which meet through a file in ``OUT_DIR``. With 8 ranks every
rank runs the sections of ``tests/_distributed_check.py`` (1-7) on the
inputs and weights in ``CASE.npz`` — the JAX package's, carried across
with ``models.lm_from_jax`` / ``train_state_from_jax`` — and writes what
it got to ``OUT_DIR/rank<r>.npz``; the tests hold those answers against
the JAX package's mesh-free ones. A section on a mesh smaller than the
world runs on its first ranks (as ``jax.make_mesh`` takes the first
devices); the others only join the mesh's groups. With ``--launch`` each
rank runs ``repro_torch.launch.train.main`` on the flags after ``--``,
starting from the weights in ``CASE.npz`` and computing in fp32, and
rank 0 writes its JSON line to ``OUT_DIR/launch.json``. With
``--runner`` two ranks run ``ft.TrainingRunner`` on a (1, 2)-sharded
state in which rank 1 alone fails (``check_runner``). Imports no JAX.
"""
import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import traceback

import numpy as np

#: The RunConfig of the reference's checks: fp32, no remat, dense.
RUN = dict(remat="none", attn_mode="dense")


def nest(flat: dict, prefix: str) -> dict:
    """The tree under ``prefix`` of a dict keyed by '/'-joined paths."""
    out = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def flatten(tree, prefix: str) -> dict:
    """The inverse of ``nest``: a tree of arrays as '/'-joined paths."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def run_ranks(case, out_dir, world, launch_argv=None, timeout=600,
              runner=False):
    """Run this file on ``case`` with ``world`` ranks in a subprocess;
    returns every rank's answers (raises with the ranks' tracebacks when
    one fails)."""
    import pathlib
    import subprocess
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "case.npz"
    np.savez(path, **case)
    root = pathlib.Path(__file__).resolve().parents[1]
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), str(path),
           str(out_dir), "--world", str(world)]
    if runner:
        cmd += ["--runner"]
    if launch_argv is not None:
        cmd += ["--launch", "--", *launch_argv]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(root / "src")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    errs = "".join(p.read_text() for p in sorted(out_dir.glob("*.err")))
    if res.returncode != 0:
        raise AssertionError(res.stdout[-4000:] + res.stderr[-4000:] + errs)
    if launch_argv is not None:
        return json.loads((out_dir / "launch.json").read_text())
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def _np(x):
    """A copy of the whole tensor (a step updates the state in place)."""
    from repro_torch.distributed.sharding import full
    return full(x).detach().cpu().numpy().copy()


def _state_arrays(state) -> dict:
    """{path: array} of a port train state, parameters by name."""
    from repro_torch.checkpoint.checkpoint import _walk
    return {"/".join(p): _np(t) for p, t in _walk(state)}


def check_lm(case, out_dir):
    """Sections 1-7 of ``tests/_distributed_check.py`` on this rank, and
    greedy generation on (2, 2)."""
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import models as tm
    from repro_torch.configs import get_arch
    from repro_torch.distributed import Axes
    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.distributed.pipeline import pipeline_apply, split_stages
    from repro_torch.distributed.sharding import this_rank
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import device_put, tree_shardings
    from repro_torch.models.model import cast_params
    from repro_torch.models.moe import moe_mlp
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, generate, make_train_step

    rank = this_rank()
    run = tm.RunConfig(compute_dtype=torch.float32, **RUN)
    cfg = get_arch("llama3.2-1b").reduced()
    params = nest(case, "params")
    batch = {k: case[f"batch/{k}"] for k in ("tokens", "labels")}
    out = {}

    def member(mesh):
        return rank in mesh.ranks.flatten().tolist()

    # 1. sharded loss == mesh-free (llama reduced, mesh 2x2)
    mesh22 = make_mesh((2, 2), ("data", "model"))
    axes22 = Axes.from_mesh(mesh22)
    if member(mesh22):
        lm = tm.lm_from_jax(cfg, params, "cpu")
        st = device_put({"params": lm}, tree_shardings({"params": lm}, axes22,
                                                       "train"))
        out["loss_2x2"] = _np(tm.loss_fn(cfg, st["params"], batch, run,
                                         axes22)[0])

        hcfg = get_arch("zamba2-2.7b").reduced()
        hlm = tm.lm_from_jax(hcfg, nest(case, "hybrid_params"), "cpu")
        hst = device_put({"params": hlm}, tree_shardings(
            {"params": hlm}, axes22, "train"))
        out["loss_hybrid"] = _np(tm.loss_fn(hcfg, hst["params"], batch, run,
                                            axes22)[0])

        # serving: 4 greedy tokens through the sharded prefill and decode
        # (the MoE's a2a and replicated paths; cf 4.0: no drops)
        gen_run = dataclasses.replace(run, cache_dtype=torch.float32)
        prompt = torch.as_tensor(case["gen_prompt"])
        for tag, gcfg, tree in (
                ("llama", cfg, params),
                ("moe", dataclasses.replace(
                    get_arch("qwen3-moe-30b-a3b").reduced(), n_experts=4,
                    topk=2, capacity_factor=4.0), nest(case, "moe_params"))):
            glm = tm.lm_from_jax(gcfg, tree, "cpu")
            gst = device_put({"params": glm}, tree_shardings(
                {"params": glm}, axes22, "serve"))
            out[f"generate_{tag}"] = _np(generate(
                gcfg, gst["params"], prompt, 4, gen_run, axes=axes22))

    # 2/3. MoE EP paths (a2a: S = 8; replicated: S = 1), no drops, on the
    # model's sharded parameters
    if member(mesh22):
        mcfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(),
                                   n_experts=4, topk=2, capacity_factor=4.0)
        mlm = tm.lm_from_jax(mcfg, nest(case, "moe_params"), "cpu")
        mst = device_put({"params": mlm}, tree_shardings(
            {"params": mlm}, axes22, "train"))
        moe = cast_params(mst["params"], torch.float32).blocks[0].moe

        def placed(a):
            return axes22.place(torch.as_tensor(a), "dp", None, None)
        x = case["moe_x"]
        o, a = moe_mlp(moe, mcfg, placed(x), axes22)
        out["moe_a2a"], out["moe_a2a_aux"] = _np(o), _np(a)
        o, _ = moe_mlp(moe, mcfg, placed(x[:, :1]), axes22)
        out["moe_rep"] = _np(o)
        out["moe_ref_aux"] = _np(moe_mlp(moe, mcfg, placed(case["moe_x_ref"]),
                                         axes22)[1])

    # 4. compressed psum over 8 ranks
    flat = make_mesh((8,), ("d",))
    vals = torch.as_tensor(case["psum_vals"])
    out["psum"] = _np(compressed_psum(vals[rank], flat.group("d")))

    # 4b. pad_heads (kv = 2 heads on a 4-way model axis)
    mesh24 = make_mesh((2, 4), ("data", "model"))
    axes24 = Axes.from_mesh(mesh24)
    lm = tm.lm_from_jax(cfg, params, "cpu")
    st = device_put({"params": lm}, tree_shardings({"params": lm}, axes24,
                                                   "train"))
    run_pad = dataclasses.replace(run, pad_heads=True)
    out["loss_pad"] = _np(tm.loss_fn(cfg, st["params"], batch, run_pad,
                                     axes24)[0])

    # 5. multi-pod mesh train step
    pod = make_mesh((2, 2, 2), ("pod", "data", "model"))
    pod_axes = Axes.from_mesh(pod)
    assert pod_axes.dp == ("pod", "data")
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
    state = tm.train_state_from_jax(cfg, {"params": params,
                                          "opt": nest(case, "opt")}, "cpu")
    state = device_put(state, tree_shardings(state, pod_axes, "train"))
    state2, met = make_train_step(cfg, run, tcfg, pod_axes)(state, batch)
    out["pod_loss"] = _np(met["loss"])
    out["pod_grad_norm"] = _np(met["grad_norm"])
    for k, v in _state_arrays(state2).items():
        out[f"pod_state/{k}"] = v

    # 6. elastic restore of the (2,2,2) state onto a (4,2) mesh
    tmp = os.path.join(out_dir, "ckpt")
    ckpt.save(tmp, 0, state2, extra={"step": 0})
    new_axes = Axes.from_mesh(make_mesh((4, 2), ("data", "model")))
    like = tm.train_state_from_jax(cfg, {"params": params,
                                         "opt": nest(case, "opt")}, "cpu")
    restored, extra, _ = ckpt.restore(tmp, like, shardings=tree_shardings(
        like, new_axes, "train"))
    out["elastic_placements"] = np.array(str(
        restored["params"].blocks[0].attn.wq.placements))
    for k, v in _state_arrays(restored).items():
        out[f"restored/{k}"] = v
    _, met3 = make_train_step(cfg, run, tcfg, new_axes)(restored, batch)
    out["elastic_loss"] = _np(met3["loss"])

    # 7. GPipe over 4 stages == sequential
    pp = make_mesh((4,), ("stage",))
    if member(pp):
        staged = split_stages({"w": torch.as_tensor(case["pp_w"])}, 4)
        got = pipeline_apply(lambda lp, x: torch.tanh(x @ lp["w"]), staged,
                             torch.as_tensor(case["pp_x"]), pp, "stage")
        out["pipeline"] = _np(got)
    return out


def check_runner(out_dir):
    """``ft.TrainingRunner`` on a (1, 2)-sharded reduced llama, 4 steps, in
    which rank 1 alone fails at step 2, at its update's workspace (before
    its first write) while rank 0 finishes the step: "clean" (no
    failure), "ckpt" (a checkpoint every step), "none" (no checkpoint),
    and "both" (both ranks fail there, no checkpoint)."""
    import torch
    import torch.distributed as dist
    from repro_torch import models as tm
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import Axes
    from repro_torch.distributed.sharding import this_rank
    from repro_torch.ft import RunnerConfig, TrainingRunner
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import device_put, tree_shardings
    from repro_torch.optim import OptConfig, adamw
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    rank = this_rank()
    cfg = get_arch("llama3.2-1b").reduced()
    run = tm.RunConfig(compute_dtype=torch.float32, **RUN)
    axes = Axes.from_mesh(make_mesh((1, 2), ("data", "model")))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=50))
    data = SyntheticLM(DataConfig(seed=7, seq_len=16, global_batch=4,
                                  vocab=cfg.vocab))
    get = adamw.Workspace.get
    out = {}
    for tag, ckpt_every, failing in (("clean", 100, ()), ("ckpt", 1, (1,)),
                                     ("none", 100, (1,)),
                                     ("both", 100, (0, 1))):
        calls = []

        def failing_get(ws, *a):
            calls.append(None)              # one call a step
            if rank in failing and len(calls) == 3:
                raise torch.OutOfMemoryError("injected at the workspace")
            return get(ws, *a)
        lm = tm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        state = init_train_state(cfg, lm, tcfg)
        state = device_put(state, tree_shardings(state, axes, "train"))
        runner = TrainingRunner(
            make_train_step(cfg, run, tcfg, axes), data, state,
            os.path.join(out_dir, tag),
            RunnerConfig(total_steps=4, ckpt_every=ckpt_every),
            group=dist.group.WORLD)
        adamw.Workspace.get = failing_get
        try:
            res = runner.run()
            out.update({f"{tag}/state/{k}": v
                        for k, v in _state_arrays(res["state"]).items()})
        except RuntimeError as e:
            out[f"{tag}/error"] = np.array(str(e))
            out[f"{tag}/cause"] = np.array(type(e.__cause__).__name__)
        finally:
            adamw.Workspace.get = get
        out[f"{tag}/restarts"] = np.array(runner.restarts)
        out[f"{tag}/steps"] = np.array([m["step"]
                                        for m in runner.metrics_log])
    return out


def launch_main(case, out_dir, argv):
    """``repro_torch.launch.train.main(argv)`` from the case's weights,
    computing in fp32."""
    import functools

    import torch
    import repro_torch.launch.train as lt
    from repro_torch import models as tm

    def init_lm(cfg, generator=None, device=None):
        return tm.lm_from_jax(cfg, nest(case, "params"), device)
    lt.init_lm = init_lm
    lt.RunConfig = functools.partial(lt.RunConfig,
                                     compute_dtype=torch.float32)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lt.main(argv)
    line = buf.getvalue().strip().splitlines()
    if line:
        with open(os.path.join(out_dir, "launch.json"), "w") as f:
            f.write(line[-1])


def rank_main(rank, world, out_dir, case_path, launch_argv, runner):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        from repro_torch.distributed import init_multi_host
        init_multi_host(f"file://{os.path.join(out_dir, 'rdzv')}", world,
                        rank, backend="gloo")
        case = dict(np.load(case_path))
        if launch_argv is not None:
            launch_main(case, out_dir, launch_argv)
        else:
            got = check_runner(out_dir) if runner else check_lm(case,
                                                                 out_dir)
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rest = None
    if "--" in argv:
        at = argv.index("--")
        argv, rest = argv[:at], argv[at + 1:]
    ap = argparse.ArgumentParser()
    ap.add_argument("case")
    ap.add_argument("out_dir")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--launch", action="store_true")
    ap.add_argument("--runner", action="store_true")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        rank_main, args=(args.world, args.out_dir, args.case,
                         rest if args.launch else None, args.runner),
        nprocs=args.world, start_method="spawn", join=False)
    while not ctx.join():
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
