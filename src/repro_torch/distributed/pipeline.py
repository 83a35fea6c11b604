"""GPipe-style pipeline parallelism over a mesh axis on
``torch.distributed`` (the JAX package's ``distributed/pipeline.py``).

The layer stack is split into S contiguous stages, one a rank along the
``stage`` axis; microbatches stream through with the classic GPipe
schedule (T = n_micro + S − 1 ticks; stage s processes microbatch t − s
at tick t). Activations move between stages with one hand-off a tick
(``collectives.hand_off``, the systolic hand-off of the sharded sDTW
engine), and the last stage's outputs are harvested onto every rank
(``collectives.psum_harvest``). SPMD: every rank calls with the same
arguments and gets the whole answer. The hand-off carries values, not a
graph: ``pipeline_apply`` is a forward pass (the reference's test holds
its forward against the sequential run).
"""
from __future__ import annotations

import torch

from .collectives import hand_off, psum_harvest


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def split_stages(stacked_params, n_stages: int):
    """Reshape [L, ...] stacked layer params (a dict tree of tensors)
    into [S, L/S, ...]."""
    def r(p):
        l = p.shape[0]
        assert l % n_stages == 0, f"{l} layers not divisible by {n_stages}"
        return p.reshape(n_stages, l // n_stages, *p.shape[1:])
    return _map(r, stacked_params)


def pipeline_apply(block_fn, stage_params, x_micro, mesh, axis: str = "stage"):
    """Run microbatches through pipeline stages.

    Args:
      block_fn: (layer_params, activation) → activation — one LAYER; each
        stage runs its local layers in order.
      stage_params: dict tree with leading [S, L/S, ...] dims
        (split_stages); each rank takes its own stage's part.
      x_micro: (n_micro, mb, ...) microbatched input activations.
      mesh: mesh containing ``axis`` of size S, this rank on it.
    Returns: (n_micro, mb, ...) outputs, the same on every rank.
    """
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    sid = mesh.coords()[axis]
    mine = _map(lambda p: p[sid], stage_params)
    n_local = next(_leaves(mine)).shape[0]
    dev = x_micro.device
    held = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(ticks):
        inp = x_micro[min(t, n_micro - 1)] if sid == 0 else held
        out = inp
        for l in range(n_local):
            out = block_fn(_map(lambda p: p[l], mine), out)
        got = hand_off(mesh, axis, (out,) if sid < n_stages - 1 else None,
                       sid > 0, (out,), dev)
        held = got[0] if got is not None else held
        outs.append(out)
    # The last stage emits microbatch m at tick m + S - 1; harvest its
    # window onto every stage.
    kept = ((torch.stack(outs[n_stages - 1:n_stages - 1 + n_micro]),)
            if sid == n_stages - 1 else None)
    return psum_harvest(kept, (x_micro[0],), mesh, axis, None, n_micro,
                        dev)[0]
