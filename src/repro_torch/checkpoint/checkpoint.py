"""Atomic checkpointing in the JAX package's on-disk layout (no external
deps), so a checkpoint written by either package restores into the other.

Layout (the reference's ``checkpoint/checkpoint.py``):
    <dir>/step_000123/
        manifest.json       step, extra, and each leaf's path/file/shape/dtype
        arr_00000.npy ...   one file per leaf
    <dir>/LATEST            text file naming the newest complete step

Leaves are written as the reference's tree flattens: dict keys sorted at
every level (``opt/m/...``, ``opt/step``, ``opt/v/...``, ``params/...``),
with the reference's ``/``-joined path strings. The port's tree maps onto
it by names: an ``LM`` is its parameters by name, a dict keyed by
parameter names (the moments, the feedback) likewise, a name's dots are
levels, and a level named by a layer number is the stacked layer axis —
``blocks.<l>.attn.wq`` is row l of the leaf ``blocks/attn/wq``, as the
reference stacks ``blocks``. The reference's ``restore`` unflattens by
order, not by path, so this order is what makes the two interchangeable.

Properties, as in the reference:
  * atomicity — written to a tmp dir, fsync'd, then renamed; LATEST updated
    last. A crash mid-save never corrupts the previous checkpoint.
  * async save — a thread does the file I/O after the device→host copy
    (joined at once on one host, keeping the production code path).
  * retention — keep_last N checkpoints are retained, older ones pruned.
  * elasticity — a sharded tree (DTensor leaves) is saved as full
    tensors: every rank gathers each leaf, rank 0 writes, the others wait
    for its word that the checkpoint is complete. ``restore(shardings=)`` places the leaves onto whatever
    mesh the restarted job has, each rank keeping its part.
numpy has no bfloat16, so a bf16 leaf raises (the train state holds
none).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.convert import stacked_leaves
from ..models.layers import Init
from ..models.model import LM


def _walk(tree, prefix=()):
    """(path, leaf) of a port tree in its own order: a dict by its keys, a
    module by its named parameters; a name's dots split into levels."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + tuple(name.split(".")), p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + tuple(str(k).split(".")))
    else:
        yield prefix, tree


def _unzip(tree):
    pairs = list(_walk(tree))
    return [p for p, _ in pairs], [x for _, x in pairs]


def _layout(paths):
    """The reference's leaves for a port tree's ``paths``: [(path string,
    index of the port leaf, or the port leaves' indices by layer for a
    stacked leaf)] in the reference's flatten order (sorted keys)."""
    return [("/".join(key), idx)
            for key, idx in sorted(stacked_leaves(paths).items())]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: cast the leaf before "
                            "checkpointing it")
        if isinstance(x, DTensor):
            x = x.full_tensor()          # collective: every rank calls it
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write(path: str, arr: np.ndarray):
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         keep_last: int = 3, async_io: bool = True) -> str:
    """Checkpoint a tree (params/opt/data state). Returns the final path.

    Collective for a sharded tree (its mesh spanning the world): every
    rank calls it; rank 0 writes, and every rank returns once the
    checkpoint is complete (or raises if rank 0 failed to write it)."""
    paths, leaves = _unzip(tree)
    layout = _layout(paths)
    ref_paths = [p for p, _ in layout]
    host_leaves = [np.stack([_host(leaves[i]) for i in idx])
                   if isinstance(idx, list) else _host(leaves[idx])
                   for _, idx in layout]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if any(isinstance(x, DTensor) for x in leaves):
        failed = [None]
        if dist.get_rank() == 0:
            try:
                _save(ckpt_dir, step, final, ref_paths, host_leaves, extra,
                      keep_last, async_io)
            except Exception as e:                  # told to every rank
                failed = [f"{type(e).__name__}: {e}"]
        dist.broadcast_object_list(failed, src=0)
        if failed[0] is not None:
            raise OSError(f"rank 0 failed to write {final}: {failed[0]}")
        return final
    _save(ckpt_dir, step, final, ref_paths, host_leaves, extra, keep_last,
          async_io)
    return final


def _save(ckpt_dir, step, final, ref_paths, host_leaves, extra, keep_last,
          async_io):
    tmp = final + ".tmp"

    def write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (p, a) in enumerate(zip(ref_paths, host_leaves)):
            fn = f"arr_{i:05d}.npy"
            _write(os.path.join(tmp, fn), a)
            manifest["leaves"].append(
                {"path": p, "file": fn, "shape": list(a.shape),
                 "dtype": str(a.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
        _fsync_dir(ckpt_dir)
        _prune(ckpt_dir, keep_last)

    os.makedirs(ckpt_dir, exist_ok=True)
    if async_io:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        t.join()  # single-host: join immediately but keep the code path
        # identical to the overlapped production variant.
    else:
        write()


def _prune(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def _rebuild(like, new):
    """``like``'s structure holding the tensors of the iterator ``new``
    (in ``_walk`` order); an ``LM`` is rebuilt around them."""
    if isinstance(like, LM):
        lm = LM(like.cfg, Init(torch.device("meta")))
        lm.load_state_dict({n: next(new) for n, _ in like.named_parameters()},
                           strict=True, assign=True)
        for p, q in zip(lm.parameters(), like.parameters()):
            p.requires_grad_(q.requires_grad)
        return lm
    if isinstance(like, nn.Module):
        raise TypeError(f"cannot restore into a {type(like).__name__}")
    if isinstance(like, dict):
        return {k: _rebuild(v, new) for k, v in like.items()}
    return next(new)


def restore(ckpt_dir: str, like, step: Optional[int] = None, device=None,
            shardings=None):
    """Restore a tree structured like ``like`` → (tree, extra, step).

    Leaves are new tensors on ``device``, or each on its ``like`` leaf's
    device when None (the restarted job's); an ``LM`` is a new model.
    ``shardings`` (``launch.specs.tree_shardings``' form, ``{path:
    (DeviceMesh, placements)}``) places each leaf onto a mesh (the
    elastic restore); without it a leaf is placed as its ``like`` leaf
    is (sharded or not). Raises if the checkpoint's leaves do not match
    ``like``'s."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = _unzip(like)
    layout = _layout(paths)
    if len(layout) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"the tree {len(layout)}")
    new = [None] * len(leaves)
    for (path, idx), leaf in zip(layout, manifest["leaves"]):
        arr = np.load(os.path.join(d, leaf["file"]))
        parts = list(zip(idx, arr)) if isinstance(idx, list) else [(idx, arr)]
        if isinstance(idx, list) and arr.shape[0] != len(idx):
            raise ValueError(f"{path}: {arr.shape[0]} layers, the tree "
                             f"{len(idx)}")
        for i, a in parts:
            want = leaves[i]
            if tuple(a.shape) != tuple(np.shape(want)):
                raise ValueError(f"{path}: shape {a.shape}, the tree "
                                 f"{tuple(np.shape(want))}")
            dev = device if device is not None else (
                want.device if isinstance(want, torch.Tensor) else "cpu")
            new[i] = _place(torch.from_numpy(np.array(a, order="C")).to(dev),
                            want, None if shardings is None
                            else shardings[tuple(paths[i])])
    return _rebuild(like, iter(new)), manifest["extra"], step


def _place(t, want, sharding):
    """The full tensor ``t`` placed by ``sharding`` (``(DeviceMesh,
    placements)``), else as the ``like`` leaf ``want`` is."""
    if sharding is None and isinstance(want, DTensor):
        sharding = (want.device_mesh, want.placements)
    if sharding is None:
        return t
    return distribute_tensor(t, *sharding, src_data_rank=None)
