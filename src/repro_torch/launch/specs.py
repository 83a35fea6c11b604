"""The LM's parameter sharding rules (the sharding part of the JAX
package's ``launch/specs.py``, its lines 41-131).

Rules (the reference's DESIGN.md §6):
  * train params+optimizer: 2-D "fsdp × tp" sharding — contraction dims
    over the data-parallel axes (ZeRO-3 style), parallel dims over
    "model" (Megatron TP).
  * serve params: TP-only (no per-step weight gathers).

A tree here is the port's train state (``{"params": LM, "opt": {"m",
"v", "step"}, "feedback"}``) or any part of it, walked as the checkpoint
walks it: an ``LM`` by its parameter names, a name's dots as levels. A
level named by a layer number is the reference's stacked layer axis: the
port keeps each layer's tensor apart, and gives it the reference's spec
of the stacked leaf without its leading layer entry. ``tree_shardings``
turns the specs into ``(DeviceMesh, placements)`` pairs and
``device_put`` places a tree on them, each rank keeping its own part.

Cells (the rest of the reference's module): ``input_specs`` gives a
cell's inputs as meta tensors (no allocation); ``batch_spec_tree`` and
``cache_spec_tree`` the specs of its batch and serving cache;
``run_config_for`` and ``_maybe_fp8_cache`` its ``RunConfig``; and
``build_cell`` the cell itself: stand-ins for its arguments (meta
tensors, or fake ones when called under ``FakeTensorMode``) and the step
that places them by the spec trees and runs the port's train step,
prefill step or greedy serve step (``launch.dryrun`` runs it on a fake
world). The reference's ``state_specs`` exists only in its docstring
(its ``build_cell`` shapes the state inline); so here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..checkpoint.checkpoint import _rebuild, _walk
from ..configs import ArchConfig, ShapeSpec
from ..distributed.sharding import Axes, _ranges, sharded_zeros
from ..models import RunConfig
from ..models.layers import Init
from ..models.model import LM, init_cache, prefill
from ..optim import OptConfig
from ..train import (TrainConfig, init_train_state, make_serve_step,
                     make_train_step)


def _axis_size(axes: Axes, handle) -> int:
    if handle is None or axes.mesh is None:
        return 1
    names = handle if isinstance(handle, tuple) else (handle,)
    size = 1
    for n in names:
        size *= axes.mesh.shape[n]
    return size


def _leaf_spec(path_names, shape, axes: Axes, mode: str) -> tuple:
    """Spec dims for one parameter (or moment) tensor, by name + rank.

    Every dim is divisibility-guarded (the reference's jit argument
    shardings require even division: e.g. mamba2's 50280-token vocab
    does not divide a 16-way axis — such dims replicate)."""
    name = path_names[-1]
    fsdp = (axes.dp if axes.dp else None) if mode == "train" else None
    tp = axes.tp
    rank = len(shape)

    def spec(*dims):
        dims = tuple(d if (d is not None and
                           shape[i] % _axis_size(axes, d) == 0) else None
                     for i, d in enumerate(dims))
        assert len(dims) == len(shape), (path_names, shape, dims)
        return dims

    if name == "table":                         # [V, d]
        return spec(tp, fsdp)
    if name in ("wq", "wk", "wv"):              # [d, X]
        return spec(fsdp, tp)
    if name in ("bq", "bk", "bv"):              # [X]
        return spec(tp)
    if name == "wo":                            # [X, d]
        return spec(tp, fsdp)
    if name in ("w_gate", "w_up"):
        if rank == 3:                           # MoE [E, d, ff]
            return spec(tp, fsdp, None)
        return spec(fsdp, tp)                   # dense [d, ff]
    if name == "w_down":
        if rank == 3:                           # MoE [E, ff, d]
            return spec(tp, None, fsdp)
        return spec(tp, fsdp)                   # dense [ff, d]
    if name == "router":                        # [d, E]
        return spec(fsdp, None)
    if name == "in_proj":                       # [d, 2di+2n+h]
        return spec(tp, fsdp)
    if name == "out_proj":                      # [di, d]
        return spec(tp, fsdp)
    if name == "conv_x":                        # [w, di]
        return spec(None, tp)
    if name in ("conv_b", "conv_c"):            # [w, n]
        return spec(None, None)
    if name in ("dt_bias", "A_log", "D"):       # [h]
        return spec(tp)
    if name == "norm_w":                        # [di]
        return spec(tp)
    if name in ("ln", "ln1", "ln2", "final_norm"):
        return spec(None)
    if rank == 0:                               # scalars (opt step etc.)
        return ()
    # Fallback: replicate.
    return spec(*([None] * rank))


def _path_names(path) -> tuple:
    return tuple(str(k) for k in path)


def tree_specs(tree, axes: Axes, mode: str) -> dict:
    """``{path: spec tuple}`` of every tensor of ``tree`` (paths as the
    checkpoint walks them, e.g. ``("opt", "m", "blocks", "0", "attn",
    "wq")``)."""
    return {path: _leaf_spec(_path_names(path), tuple(leaf.shape), axes,
                             mode)
            for path, leaf in _walk(tree)}


def tree_shardings(tree, axes: Axes, mode: str):
    """``{path: (DeviceMesh, placements)}`` of every tensor of ``tree``,
    each for its tensor's device type (None without a mesh)."""
    if axes.mesh is None:
        return None
    specs = tree_specs(tree, axes, mode)
    return {path: (axes.mesh.device_mesh(leaf.device.type),
                   axes.placements(specs[path]))
            for path, leaf in _walk(tree)}


def device_put(tree, shardings):
    """``tree`` with every tensor placed by its entry of ``shardings``
    (``tree_shardings``' form): each rank keeps its part of the global
    tensor it holds, without a message; an ``LM`` becomes a new model
    whose parameters are DTensors."""
    from torch.distributed.tensor import DTensor

    def put(path, leaf):
        # this rank's block of the global tensor (``distribute_tensor``
        # with no source rank, without making every rank's chunk), in a
        # storage of its own where it is a part, so that the global
        # tensor is freed with its last reference
        dm, pl = shardings[path]
        with torch.no_grad():
            part = leaf.detach()[tuple(
                slice(lo, hi) for lo, hi in _ranges(leaf.shape, dm, pl))]
            if part.numel() < leaf.numel():
                part = part.clone(memory_format=torch.contiguous_format)
            out = DTensor.from_local(part, dm, pl, run_check=False,
                                     shape=leaf.shape, stride=leaf.stride())
        return out.requires_grad_(leaf.requires_grad)
    return _rebuild(tree, iter([put(path, leaf)
                                for path, leaf in _walk(tree)]))


def _placements(spec, axes: Axes) -> tuple:
    """DTensor placements of a spec tuple. An entry naming one axis of a
    merged DeviceMesh dim (("pod", "data") on the multi-pod mesh) splits
    over the merged dim: the long-context cache's sequence over "data"
    alone, replicated over "pod" in the reference, is split over both."""
    merged = [d for d in axes.mesh.dtensor_dims if isinstance(d, tuple)]

    def widen(entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        return next((d for d in merged if set(names) < set(d)), entry)
    return axes.placements(tuple(widen(e) for e in spec))


def _spec_shardings(tree, spec_tree, axes: Axes):
    """``device_put``'s shardings of ``tree`` from a tree of spec tuples
    of the same layout."""
    specs = dict(_walk(spec_tree))
    return {path: (axes.mesh.device_mesh(leaf.device.type),
                   _placements(specs[path], axes))
            for path, leaf in _walk(tree)}


# ---------------------------------------------------------------------------
# Input specs (meta tensors — no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeSpec, run: RunConfig = None,
                device="meta") -> dict:
    """Model inputs for a cell, as empty tensors on ``device`` (meta: no
    storage; ``run`` is accepted as in the reference)."""
    b, s = shape.global_batch, shape.seq_len

    def t(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)
    if shape.kind == "train" or shape.kind == "prefill":
        if cfg.frontend == "stub":
            batch = {"embeddings": t((b, s, cfg.d_model), torch.bfloat16),
                     "labels": t((b, s), torch.int32)}
        else:
            batch = {"tokens": t((b, s), torch.int32),
                     "labels": t((b, s), torch.int32)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    # decode: one new token against a full cache
    return {"tokens": t((b,), torch.int32)}


def batch_spec_tree(cfg, shape, axes: Axes) -> dict:
    """``{input name: spec}``: the batch over the data-parallel axes."""
    dp = axes.dp if axes.dp else None

    def one(name, leaf):
        if name == "embeddings":
            return (dp, None, None)
        if name in ("tokens", "labels"):
            return (dp, None) if leaf.ndim == 2 else (dp,)
        return (None,) * leaf.ndim
    return {name: one(name, leaf)
            for name, leaf in input_specs(cfg, shape).items()}


def _dp_size(axes: Axes) -> int:
    size = 1
    if axes.mesh is not None:
        for a in (axes.dp or ()):
            size *= axes.mesh.shape[a]
    return size


def _batch_shardable(shape, axes: Axes) -> bool:
    dp_size = _dp_size(axes)
    return shape.global_batch % max(dp_size, 1) == 0 and \
        shape.global_batch >= dp_size


def cache_spec_tree(cfg, shape, axes: Axes, cache_tree,
                    kv_layout: str = "dh") -> dict:
    """KV/SSM cache specs over ``init_cache``'s dict. Batch over dp when
    divisible, else SP over the sequence axis; kv-heads over tp when
    divisible, otherwise either the head_dim ("dh", default) or the
    sequence ("seq") carries the model axis — a perf lever: dh-sharding
    sums the whole scores row per layer over the model axis, seq-sharding
    only the softmax statistics and the values (flash-decode)."""
    dp = axes.dp if axes.dp else None
    tp = axes.tp
    batch_shardable = _batch_shardable(shape, axes)

    def one(name, leaf):
        rank = leaf.ndim
        if name in ("k", "v", "shared_k", "shared_v"):
            # [L_or_G, B, S, Hkv, Dh]: kv-heads the model axis does not
            # divide leave it to head_dim (always 128·k)
            tkv = axes.tp_if_divisible(cfg.n_kv_heads)
            tdh = axes.tp_if_divisible(cfg.resolved_head_dim)
            if batch_shardable:
                if tkv:
                    return (None, dp, None, tkv, None)
                if kv_layout == "seq":
                    return (None, dp, tp, None, None)
                return (None, dp, None, None, tdh)
            return (None, None, axes.sp, tkv,
                    None if tkv else tdh)            # sequence parallel
        if name == "h":                                # [L, B, H, P, N]
            th = axes.tp_if_divisible(cfg.n_ssm_heads)
            if batch_shardable:
                return (None, dp, th, None, None)
            return (None, None, th, None, None)
        if name == "conv":                             # [L, B, W-1, ch]
            if batch_shardable:
                return (None, dp, None, None)
            return (None,) * rank
        if name == "pos":
            return (dp,) if batch_shardable else (None,)
        return (None,) * rank

    def go(t):
        return {k: go(v) if isinstance(v, dict) else one(k, v)
                for k, v in t.items()}
    return go(cache_tree)


# ---------------------------------------------------------------------------
# Cell assembly
# ---------------------------------------------------------------------------

def run_config_for(shape: ShapeSpec, overrides: Optional[dict] = None
                   ) -> RunConfig:
    """The cell's ``RunConfig``; ``scan_layers`` is kept as the
    reference's (False) and changes nothing here."""
    base = dict(compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                scan_layers=False)
    if shape.kind == "train":
        base.update(remat="full", attn_mode="chunked", attn_chunk=2048)
    elif shape.kind == "prefill":
        base.update(remat="none", attn_mode="chunked", attn_chunk=1024)
    else:
        base.update(remat="none", attn_mode="dense")
    base.update(overrides or {})
    return RunConfig(**base)


def _maybe_fp8_cache(cfg, shape, axes: Axes, run: RunConfig) -> RunConfig:
    """fp8 KV cache when bf16 would blow the per-rank HBM budget
    (qwen1.5-32b decode_32k: 5.5 TB global KV in bf16)."""
    if not cfg.n_heads:
        return run
    n_chips = 1 if axes.mesh is None else axes.mesh.size
    n_attn = cfg.n_layers if cfg.family != "hybrid" \
        else cfg.n_layers // cfg.attn_every
    kv_bytes = (2 * n_attn * shape.global_batch * shape.seq_len
                * cfg.n_kv_heads * cfg.resolved_head_dim * 2) / n_chips
    if kv_bytes > 8e9:
        return dataclasses.replace(run, cache_dtype=torch.float8_e4m3fn)
    return run


@dataclasses.dataclass
class Cell:
    """An (arch × shape × mesh) unit: ``fn(*args)`` places the arguments
    (``place``) and runs the step on them (``step``)."""
    fn: Callable               # place, then step
    args: tuple                # meta (or fake) stand-ins, global shapes
    description: str
    place: Callable = None     # args → the rank's placed args
    step: Callable = None      # placed args → outputs
    run: Any = None            # the RunConfig the step runs with


def _model(cfg, device, dtype=torch.float32) -> LM:
    """An ``LM`` of uninitialised ``dtype`` storage on ``device``."""
    with torch.no_grad():
        return LM(cfg, Init(torch.device(device), None, dtype))


def _cell(place, step, args, description, run) -> Cell:
    def fn(*a):
        return step(*place(*a))
    return Cell(fn, args, description, place, step, run)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, axes: Axes,
               run_overrides: Optional[dict] = None,
               tcfg: Optional[TrainConfig] = None,
               serve_param_mode: str = "train",
               kv_layout: str = "dh", device="meta") -> Cell:
    """The cell's stand-ins on ``device`` and its step. serve_param_mode:
    "train" (2-D fsdp×tp — fits everything, gathers weights per step) or
    "serve" (TP-only — no gathers; for models whose TP-sharded bf16
    params fit beside the KV cache)."""
    run = run_config_for(shape, run_overrides)
    mesh = axes.mesh

    def put(tree, spec_tree):
        if mesh is None:
            return tree
        return device_put(tree, _spec_shardings(tree, spec_tree, axes))

    batch_spec = batch_spec_tree(cfg, shape, axes)
    if shape.kind == "train":
        tcfg = tcfg or TrainConfig(opt=OptConfig())
        state = init_train_state(cfg, _model(cfg, device), tcfg)
        batch = input_specs(cfg, shape, run, device)

        def place(state, batch):
            if mesh is None:
                return state, batch
            return (device_put(state, tree_shardings(state, axes, "train")),
                    put(batch, batch_spec))
        return _cell(place, make_train_step(cfg, run, tcfg, axes),
                     (state, batch), f"train_step {cfg.name} {shape.name}",
                     run)

    # Serving cells hold bf16 parameters (and no fp32 masters). Baseline
    # sharding is 2-D (fsdp × tp), as in training: the 32B-class archs do
    # not fit TP-only next to a 32k-context KV cache.
    params = _model(cfg, device, torch.bfloat16)

    def place_params(params):
        if mesh is None:
            return params
        return device_put(params, tree_shardings(params, axes,
                                                 serve_param_mode))

    if shape.kind == "prefill":
        batch = input_specs(cfg, shape, run, device)
        max_len = shape.seq_len
        cache_meta = init_cache(cfg, shape.global_batch, max_len, run,
                                "meta")
        cache_spec = cache_spec_tree(cfg, shape, axes, cache_meta,
                                     kv_layout)

        def place(params, batch):
            return place_params(params), put(batch, batch_spec)

        def prefill_step(params, batch):
            dev = params.device
            specs = dict(_walk(cache_spec))
            cache = _rebuild(cache_meta, iter([
                sharded_zeros(leaf.shape, leaf.dtype, dev,
                              None if mesh is None else
                              (mesh.device_mesh(dev.type),
                               _placements(specs[path], axes)))
                for path, leaf in _walk(cache_meta)]))
            return prefill(cfg, params, batch, max_len, run, axes,
                           cache=cache)
        return _cell(place, prefill_step, (params, batch),
                     f"prefill_step {cfg.name} {shape.name}", run)

    # decode
    run = _maybe_fp8_cache(cfg, shape, axes, run)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, run, "meta")
    if torch.device(device).type != "meta":
        cache = _rebuild(cache, iter([torch.empty_like(t, device=device)
                                      for _, t in _walk(cache)]))
    cache_spec = cache_spec_tree(cfg, shape, axes, cache, kv_layout)
    dp = axes.dp if axes.dp else None
    tok_spec = {"tokens": (dp,) if _batch_shardable(shape, axes)
                else (None,)}
    tokens = input_specs(cfg, shape, run, device)["tokens"]
    serve = make_serve_step(cfg, run, axes=axes)

    def place(params, tokens, cache):
        return (place_params(params), put({"tokens": tokens},
                                          tok_spec)["tokens"],
                put(cache, cache_spec))

    def serve_step(params, tokens, cache):
        tok, _, cache = serve(params, tokens, cache)
        return tok, cache
    return _cell(place, serve_step, (params, tokens, cache),
                 f"serve_step {cfg.name} {shape.name}", run)
