"""Carry a JAX-package parameter tree into the port's ``LM``.

The JAX package's ``init_lm`` returns a nested dict whose ``blocks``
leaves are stacked over a leading layer axis. As numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), ``lm_from_jax`` loads them
into an ``LM`` whose parameter ``blocks.<l>.<path>`` is layer l of the
tree's ``blocks/<path>``; every other leaf keeps its path. This is how
tests give both packages the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .layers import Init
from .model import LM


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def lm_from_jax(cfg, params_np, device=None) -> LM:
    """An ``LM`` holding ``params_np`` (the reference's tree as numpy),
    fp32 on ``device``. Raises if a leaf is missing, extra or misshapen."""
    dev = resolve_device(device)
    state = {}
    for path, arr in _flatten(params_np):
        if path[0] == "blocks":
            for l in range(arr.shape[0]):
                state[".".join(("blocks", str(l)) + path[1:])] = arr[l]
        else:
            state[".".join(path)] = arr
    with torch.no_grad():
        lm = LM(cfg, Init(dev))
        lm.load_state_dict({k: torch.tensor(np.ascontiguousarray(v))
                            for k, v in state.items()}, strict=True)
    return lm
