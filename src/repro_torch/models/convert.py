"""Carry a JAX-package parameter tree (and train state) into the port.

The JAX package's ``init_lm`` returns a nested dict whose ``blocks``
leaves are stacked over a leading layer axis. As numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), ``lm_from_jax`` loads them
into an ``LM`` whose parameter ``blocks.<l>.<path>`` is layer l of the
tree's ``blocks/<path>``; every other leaf keeps its path.
``train_state_from_jax`` does the same for the reference's
``init_train_state`` tree: the parameters, the AdamW moments and step,
and the int8 feedback buffers. This is how tests start both packages
from the same weights and the same state. ``stacked_leaves`` is the same
map the other way, for code that must act on the reference's leaves
(the checkpoint layout, per-tensor gradient quantisation).
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


def _by_name(tree_np) -> dict:
    """``{parameter name: array}`` of a reference parameter tree, the
    stacked ``blocks`` leaves split per layer."""
    out = {}
    for path, arr in _flatten(tree_np):
        if path[0] == "blocks":
            for l in range(arr.shape[0]):
                out[".".join(("blocks", str(l)) + path[1:])] = arr[l]
        else:
            out[".".join(path)] = arr
    return out


def stacked_leaves(paths) -> dict:
    """The reference's leaves for the port's ``paths`` (tuples of name
    parts, e.g. a parameter name split at its dots): a part that is a
    layer number is the reference's stacked layer axis, so
    ``("blocks", "3", "attn", "wq")`` is row 3 of the leaf
    ``("blocks", "attn", "wq")``. Returns {leaf: index of its path, or the
    indices of its rows by layer}, in the order leaves first appear;
    raises if a stacked leaf's layers are not 0..n-1."""
    leaves = {}
    for i, path in enumerate(paths):
        at = [j for j, part in enumerate(path) if part.isdigit()]
        if not at:
            leaves[tuple(path)] = i
            continue
        key = tuple(path[:at[0]]) + tuple(path[at[0] + 1:])
        leaves.setdefault(key, {})[int(path[at[0]])] = i
    for key, idx in leaves.items():
        if isinstance(idx, dict):
            if sorted(idx) != list(range(len(idx))):
                raise ValueError(f"layers of {'/'.join(key)}: {sorted(idx)}")
            leaves[key] = [idx[l] for l in range(len(idx))]
    return leaves


def _tensor(arr, dev):
    return torch.tensor(np.array(arr, order="C"), device=dev)


def lm_from_jax(cfg, params_np, device=None) -> LM:
    """An ``LM`` holding ``params_np`` (the reference's tree as numpy),
    fp32 on ``device``. Raises if a leaf is missing, extra or misshapen."""
    dev = resolve_device(device)
    with torch.no_grad():
        lm = LM(cfg, Init(dev))
        lm.load_state_dict({k: _tensor(v, "cpu")
                            for k, v in _by_name(params_np).items()},
                           strict=True)
    return lm


def train_state_from_jax(cfg, state_np, device=None) -> dict:
    """The port's train state (``train.init_train_state``'s layout) from
    the reference's ``init_train_state`` tree as numpy: ``params``,
    ``opt`` {``m``, ``v``, ``step``} and, under ``int8_ef``,
    ``feedback``, on ``device``. Raises if a leaf is missing or extra."""
    dev = resolve_device(device)
    lm = lm_from_jax(cfg, state_np["params"], dev).requires_grad_(True)
    names = [n for n, _ in lm.named_parameters()]

    def named(tree):
        arrays = _by_name(tree)
        if set(arrays) != set(names):
            raise ValueError(f"leaves {sorted(set(arrays) ^ set(names))} "
                             f"missing or extra")
        return {n: _tensor(arrays[n], dev) for n in names}

    opt = state_np["opt"]
    state = {"params": lm, "opt": {"m": named(opt["m"]), "v": named(opt["v"]),
                                   "step": _tensor(opt["step"], dev)}}
    if "feedback" in state_np:
        state["feedback"] = named(state_np["feedback"])
    return state
