"""Subprocess bodies for ``tests/test_torch_launch.py``; pytest does not
collect this file. A fake world is one process's default process group,
so each mode runs in a process of its own:

    python tests/_torch_launch_check.py specs OUT.json
    python tests/_torch_launch_check.py flops OUT.json
    python tests/_torch_launch_check.py gloo OUT_DIR

``specs``: on a fake world of 512 ranks, the production meshes (16, 16)
(its first 256 ranks) and (2, 16, 16); for every (arch × shape) cell at
full size the port's batch and cache spec trees, its ``_maybe_fp8_cache``
decision, its train-state specs (each layer's leaf under the reference's
stacked key; every layer must agree) and the bytes rank 0 holds of the
train state placed as DTensors of meta tensors (shapes, no storage).

``flops``: on a fake world of 1, a 2-layer reduced llama train step at
mesh (1, 1), counted by ``dryrun.fake_step``, and the same step run for
real on the CPU (no mesh) under ``FlopCounterMode``.

``gloo``: 4 gloo ranks on a (2, 2) mesh; each fills a cache placed by
every layout of ``cache_spec_tree`` (batch with heads, head_dim or
sequence over the model axis; the sequence over the data axis) through
``prefill(cache=)`` and three decode steps (fp32 compute; fp32 caches,
and fp8 ones for the attention-only arch), and holds the logits and the cache against the
unsharded run of the same weights; rank 0 writes the largest
differences; and the SSM stacks' loss and gradients (mamba2, zamba2 cut
to 2 layers, fp32) sharded against unsharded.
Imports no JAX.
"""
import json
import os
import sys

#: The gloo mode's cache layouts: (name, spec of k/v (L, B, S, Hkv, Dh),
#: spec of pos (B,)), on a ("data", "model") mesh.
LAYOUTS = [
    ("batch_heads", (None, ("data",), None, "model", None), (("data",),)),
    ("batch_dh", (None, ("data",), None, None, "model"), (("data",),)),
    ("batch_seq", (None, ("data",), "model", None, None), (("data",),)),
    ("seq_heads", (None, None, "data", "model", None), (None,)),
    ("seq_dh", (None, None, "data", None, "model"), (None,)),
]


def _jsonable(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def check_specs(out_path):
    import torch
    from repro_torch.checkpoint.checkpoint import _walk
    from repro_torch.configs import SHAPES, all_archs
    from repro_torch.distributed import Axes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import (_maybe_fp8_cache, batch_spec_tree,
                                          cache_spec_tree, device_put,
                                          run_config_for, tree_shardings,
                                          tree_specs)
    from repro_torch.models.layers import Init
    from repro_torch.models.model import LM, init_cache
    from repro_torch.train import TrainConfig, init_train_state

    dryrun.init_fake_world(512)
    out = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        axes = Axes.from_mesh(mesh)
        mesh.device_mesh("meta")
        tag = "2x16x16" if multi_pod else "16x16"
        for name, cfg in sorted(all_archs().items()):
            with torch.device("meta"):
                state = init_train_state(
                    cfg, LM(cfg, Init(torch.device("meta"))), TrainConfig())
            specs = {}
            for path, spec in tree_specs(state, axes, "train").items():
                if "blocks" in path:
                    at = path.index("blocks")
                    path = path[:at + 1] + path[at + 2:]
                    spec = (None,) + spec
                key = "/".join(path)
                assert specs.setdefault(key, spec) == spec, (name, key)
            placed = device_put(state, tree_shardings(state, axes, "train"))
            nbytes = sum(t.to_local().numel() * t.element_size()
                         for _, t in _walk(placed))
            del placed
            for sname, shape in SHAPES.items():
                run = run_config_for(shape)
                cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                                   run, "meta")
                cspec = {}
                for layout in ("dh", "seq"):
                    tree = cache_spec_tree(cfg, shape, axes, cache, layout)
                    cspec[layout] = {
                        k: ({kk: _jsonable(vv) for kk, vv in v.items()}
                            if isinstance(v, dict) else _jsonable(v))
                        for k, v in tree.items()}
                fp8 = _maybe_fp8_cache(cfg, shape, axes, run).cache_dtype
                out[f"{tag}/{name}/{sname}"] = {
                    "batch": {k: _jsonable(v) for k, v in
                              batch_spec_tree(cfg, shape, axes).items()},
                    "cache": cspec,
                    "fp8": fp8 == torch.float8_e4m3fn,
                    "state": {k: _jsonable(v) for k, v in specs.items()},
                    "state_bytes": nbytes}
    with open(out_path, "w") as f:
        json.dump(out, f)


def check_flops(out_path):
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.distributed import Axes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import build_cell, input_specs

    dryrun.init_fake_world(1)
    cfg = get_arch("llama3.2-1b").reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2,
                                seq_len=64)
    over = {"attn_chunk": 32}
    fake = dryrun.fake_step(cfg, shape, Axes.from_mesh(make_mesh(
        (1, 1), ("data", "model"))), over, device="cpu")
    cell = build_cell(cfg, shape, Axes(), over, device="cpu")
    state, _ = cell.args
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        for tree in (state["opt"]["m"], state["opt"]["v"]):
            for t in tree.values():
                t.zero_()
        state["opt"]["step"].zero_()
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen,
                              dtype=v.dtype)
             for k, v in input_specs(cfg, shape, cell.run, "cpu").items()}
    counter = FlopCounterMode(display=False)
    with counter:
        _, met = cell.fn(state, batch)
    with open(out_path, "w") as f:
        json.dump({"fake": fake["flops"], "real": counter.get_total_flops(),
                   "fake_bytes": fake["bytes"], "memory": fake["memory"],
                   "loss": float(met["loss"])}, f)


def _diff(got, want) -> float:
    """Largest absolute difference; inf where either holds a NaN."""
    import torch
    d = (got.float() - want.float()).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def _gloo_rank(rank, world, init, out_dir):
    import dataclasses

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from repro_torch import models as tm
        from repro_torch.configs import get_arch
        from repro_torch.distributed import Axes
        from repro_torch.distributed.sharding import (full, sharded_zeros,
                                                      tree_shardings)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.specs import device_put
        from repro_torch.launch.specs import tree_shardings as lm_shardings
        mesh = make_mesh((2, 2), ("data", "model"))
        axes = Axes.from_mesh(mesh)
        res = {}
        for arch, dh in (("llama3.2-1b", 16), ("zamba2-2.7b", 16)):
            cfg = dataclasses.replace(get_arch(arch).reduced(),
                                      n_kv_heads=2, n_heads=4, head_dim=dh)
            gen = torch.Generator().manual_seed(0)
            lm = tm.init_lm(cfg, gen, "cpu")
            b, s, max_len = 4, 8, 16
            prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen)
            toks = torch.randint(0, cfg.vocab, (3, b), generator=gen)
            # (an fp8 cache holds the SSM conv state too, which overflows
            # e4m3 here: the hybrid runs at fp32 only, as no production
            # cell gives it an fp8 cache)
            dtypes = (torch.float32,) if cfg.has_ssm else (
                torch.float32, torch.float8_e4m3fn)
            for cache_dtype in dtypes:
                run = tm.RunConfig(remat="none", attn_mode="dense",
                                   compute_dtype=torch.float32,
                                   cache_dtype=cache_dtype)
                want, cache = [], None
                logits, cache = tm.prefill(cfg, lm, {"tokens": prompt},
                                           max_len, run)
                want.append(logits)
                for t in toks:
                    logits, cache = tm.decode_step(cfg, lm, t, cache, run)
                    want.append(logits)
                want_cache = cache
                sharded = device_put(lm, lm_shardings(lm, axes, "train"))
                for name, kv, pos in LAYOUTS:
                    if cfg.family == "hybrid" and name != "batch_dh":
                        continue
                    blank = tm.init_cache(cfg, b, max_len, run, "meta")
                    specs = {k: kv if k in ("k", "v", "shared_k",
                                            "shared_v") else pos
                             for k in blank if k != "ssm"}
                    shard = tree_shardings(axes, specs, "cpu")
                    cache = {k: sharded_zeros(v.shape, v.dtype, "cpu",
                                              shard[k])
                             for k, v in blank.items() if k != "ssm"}
                    if "ssm" in blank:
                        cache["ssm"] = {
                            k: sharded_zeros(v.shape, v.dtype, "cpu",
                                             axes.sharding(
                                                 None, "dp",
                                                 *([None] * (v.ndim - 2)),
                                                 device="cpu"))
                            for k, v in blank["ssm"].items()}
                    got = [tm.prefill(cfg, sharded, {"tokens": prompt},
                                      max_len, run, axes, cache=cache)[0]]
                    for t in toks:
                        got.append(tm.decode_step(cfg, sharded, t, cache,
                                                  run, axes)[0])
                    dl = max(_diff(g, w) for g, w in zip(got, want))
                    dc, scale = {}, {}
                    for k, w in want_cache.items():
                        pairs = ([(cache[k][kk], ww) for kk, ww in w.items()]
                                 if isinstance(w, dict) else
                                 [(cache[k], w)])
                        for g, ww in pairs:
                            assert g.dtype == ww.dtype, (k, g.dtype)
                            # (gloo gathers no fp8)
                            dc[k] = max(dc.get(k, 0.0),
                                        _diff(full(g.float()), ww))
                            scale[k] = max(scale.get(k, 0.0),
                                           float(ww.float().abs().max()))
                    res[f"{arch}/{str(cache_dtype)[6:]}/{name}"] = {
                        "logits": dl, "cache": dc, "cache_scale": scale,
                        "logits_scale": float(max(w.abs().max()
                                                  for w in want))}
        res.update(_ssm_grads(axes))
        if rank == 0:
            with open(os.path.join(out_dir, "gloo.json"), "w") as f:
                json.dump(res, f)
    except BaseException:
        import traceback
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _ssm_grads(axes):
    """The SSM stack's loss and parameter gradients (mamba2, zamba2 cut
    to 2 layers; fp32, remat full) sharded on ``axes`` against the
    unsharded ones: the largest difference of each, and the gradients'
    largest magnitude."""
    import dataclasses

    import torch
    from repro_torch import models as tm
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import full
    from repro_torch.launch.specs import device_put
    from repro_torch.launch.specs import tree_shardings as lm_shardings
    out = {}
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        cfg = dataclasses.replace(get_arch(arch).reduced(), n_kv_heads=2,
                                  n_heads=4)
        lm = tm.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
        gen = torch.Generator().manual_seed(2)
        batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=gen)
                 for k in ("tokens", "labels")}
        run = tm.RunConfig(remat="full", attn_mode="dense",
                           compute_dtype=torch.float32)

        def grads(model, axes=None):
            model.requires_grad_(True)
            names, leaves = zip(*model.named_parameters())
            loss, _ = tm.loss_fn(cfg, model, batch, run, axes)
            g = torch.autograd.grad(loss, leaves)
            return full(loss).detach(), {n: full(x) for n, x in
                                         zip(names, g)}
        want_l, want_g = grads(lm)
        got_l, got_g = grads(device_put(lm, lm_shardings(lm, axes,
                                                         "train")), axes)
        out[f"{arch}/grads"] = {
            "loss": _diff(got_l, want_l),
            "grad": max(_diff(got_g[n], w) for n, w in want_g.items()),
            "grad_scale": max(float(w.abs().max())
                              for w in want_g.values())}
    return out


def check_gloo(out_dir):
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(os.path.abspath(out_dir), "rendezvous")
    mp.start_processes(_gloo_rank, args=(4, init, out_dir), nprocs=4,
                       start_method="spawn")


def main():
    mode, where = sys.argv[1], sys.argv[2]
    {"specs": check_specs, "flops": check_flops,
     "gloo": check_gloo}[mode](where)


if __name__ == "__main__":
    main()
