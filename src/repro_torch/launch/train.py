"""LM training driver (the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --preset reduced --steps 50 --data tsa [--device cpu] [--ckpt DIR]

Runs on the CUDA device unless ``--device`` names another, with the
reference's flags: reduced configs without remat, full ones with
``remat="full"``; ``--data tsa`` feeds the model windows that the sDTW
filter (``TSAFilteredLM``, the port's ``matsa`` on the same device) keeps.
Fault tolerance (checkpoint/restart, stragglers) comes from
``repro_torch.ft.TrainingRunner``; the data pipeline is deterministic and
shard-aware, so restarts resume exactly. One device: ``--mesh`` other
than ``1x1`` raises until the distributed LM (ROADMAP item 14(b)). Prints
one JSON line with the reference's keys and the device it ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..configs import get_arch
from ..data import DataConfig, SyntheticLM, TSAFilteredLM
from ..device import resolve_device
from ..ft import FailureInjector, RunnerConfig, TrainingRunner
from ..models import RunConfig, init_lm
from ..optim import OptConfig
from ..train import TrainConfig, init_train_state, make_train_step


def build(arch: str, preset: str, mesh_spec: str, *, seq_len: int,
          global_batch: int, lr: float, steps: int, microbatches: int,
          compression: str | None, data_kind: str, seed: int, device=None):
    """(cfg, data, state, step) for a run on ``device`` (None: CUDA)."""
    if mesh_spec and mesh_spec != "1x1":
        raise NotImplementedError(
            f"--mesh {mesh_spec}: sharded training (make_mesh, Axes, "
            f"tree_shardings) comes with ROADMAP item 14(b); this port "
            f"trains on one device (--mesh 1x1)")
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if preset == "reduced":
        cfg = cfg.reduced()
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
    step = make_train_step(cfg, run, tcfg)
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
    ap.add_argument("--mesh", default="1x1",
                    help="1x1 only (sharded meshes: ROADMAP item 14(b))")
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
        else None)
    out = runner.run()
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
