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

The input specs, the cell builder and the rest of the reference's module
(``input_specs``, ``state_specs``, ``build_cell``) are not ported yet.
"""
from __future__ import annotations

import torch

from ..checkpoint.checkpoint import _rebuild, _walk
from ..distributed.sharding import Axes


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
    from torch.distributed.tensor import distribute_tensor

    def put(path, leaf):
        dm, pl = shardings[path]
        with torch.no_grad():
            out = distribute_tensor(leaf.detach(), dm, pl,
                                    src_data_rank=None)
        return out.requires_grad_(leaf.requires_grad)
    return _rebuild(tree, iter([put(path, leaf)
                                for path, leaf in _walk(tree)]))
