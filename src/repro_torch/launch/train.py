"""LM training driver (the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --preset reduced --steps 50 --data tsa [--device cpu] [--ckpt DIR]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...

Runs on the CUDA device unless ``--device`` names another, with the
reference's flags: reduced configs without remat, full ones with
``remat="full"``; ``--data tsa`` feeds the model windows that the sDTW
filter (``TSAFilteredLM``, the port's ``matsa`` on the same device) keeps.
Fault tolerance (checkpoint/restart, stragglers) comes from
``repro_torch.ft.TrainingRunner``; the data pipeline is deterministic and
shard-aware, so restarts resume exactly. ``--mesh AxB[xC]`` shards the
state over a ``("pod", "data", "model")[-len]`` mesh of the world's
ranks (an initialised process group, else the one ``torchrun``'s
environment describes: NCCL with a CUDA device, else gloo); the world
must hold exactly the mesh, and its ranks agree on each step's outcome
(``TrainingRunner(group=)``). ``1x1`` is the unsharded path, as in the
reference. Rank 0 prints one JSON line with the reference's keys and the
device it ran on.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_arch
from ..data import DataConfig, SyntheticLM, TSAFilteredLM
from ..device import resolve_device
from ..distributed.sharding import Axes, init_multi_host
from ..ft import FailureInjector, RunnerConfig, TrainingRunner
from ..models import RunConfig, init_lm
from ..optim import OptConfig
from ..train import TrainConfig, init_train_state, make_train_step
from .mesh import make_mesh
from .specs import device_put, tree_shardings


def _join_world(dev, n: int):
    """Make sure this process is one of a world of exactly ``n`` ranks."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise ValueError(f"a mesh of {n} ranks needs a world of {n}: "
                             f"run under torchrun or initialise a process "
                             f"group first")
        init_multi_host("env://", int(os.environ["WORLD_SIZE"]),
                        int(os.environ["RANK"]),
                        backend="nccl" if dev.type == "cuda" else "gloo")
    if dist.get_world_size() != n:
        raise ValueError(f"the mesh holds {n} ranks, the world "
                         f"{dist.get_world_size()}")


def build(arch: str, preset: str, mesh_spec: str, *, seq_len: int,
          global_batch: int, lr: float, steps: int, microbatches: int,
          compression: str | None, data_kind: str, seed: int, device=None):
    """(cfg, data, state, step) for a run on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if preset == "reduced":
        cfg = cfg.reduced()
    mesh = None
    if mesh_spec and mesh_spec != "1x1":
        dims = tuple(int(x) for x in mesh_spec.split("x"))
        names = ("pod", "data", "model")[-len(dims):]
        _join_world(dev, math.prod(dims))
        mesh = make_mesh(dims, names)
    axes = Axes.from_mesh(mesh)
    run = RunConfig(remat="none" if preset == "reduced" else "full",
                    attn_mode="dense" if seq_len <= 2048 else "chunked")
    tcfg = TrainConfig(
        opt=OptConfig(lr=lr, warmup_steps=max(2, steps // 20),
                      total_steps=steps),
        microbatches=microbatches,
        grad_compression=compression)
    dcfg = DataConfig(seed=seed, seq_len=seq_len, global_batch=global_batch,
                      vocab=cfg.vocab,
                      embeddings_dim=cfg.d_model if cfg.frontend == "stub"
                      else 0)
    data = (TSAFilteredLM(dcfg, device=dev) if data_kind == "tsa"
            else SyntheticLM(dcfg))
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    state = init_train_state(cfg, params, tcfg)
    if mesh is not None:
        state = device_put(state, tree_shardings(state, axes, "train"))
    step = make_train_step(cfg, run, tcfg, axes)
    return cfg, data, state, step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1", help="e.g. 4x2 or 2x16x16")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None,
                    choices=[None, "int8_ef"])
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "tsa"])
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg, data, state, step = build(
        args.arch, args.preset, args.mesh, seq_len=args.seq_len,
        global_batch=args.global_batch, lr=args.lr, steps=args.steps,
        microbatches=args.microbatches, compression=args.compression,
        data_kind=args.data, seed=args.seed, device=args.device)
    dev = state["params"].device

    runner = TrainingRunner(
        step, data, state, args.ckpt,
        RunnerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every),
        injector=FailureInjector(tuple(args.fail_at)) if args.fail_at
        else None,
        group=dist.group.WORLD if args.mesh != "1x1" else None)
    out = runner.run()
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    first, last = out["metrics"][0], out["metrics"][-1]
    print(json.dumps({
        "arch": cfg.name, "steps": len(out["metrics"]),
        "restarts": out["restarts"], "stragglers": out["stragglers"],
        "first_loss": round(first["loss"], 4),
        "last_loss": round(last["loss"], 4),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }))


if __name__ == "__main__":
    main()
