"""Training step in PyTorch (the JAX package's ``train/train_step.py``):
autograd through the model's remat, microbatch gradient accumulation and
optional int8 gradient compression with error feedback, on one device or
sharded over a mesh.

The train state is ``{"params": LM, "opt": {"m", "v", "step"}}`` (plus
``"feedback"`` under ``int8_ef``): ``m``, ``v`` and ``feedback`` are fp32
tensors named as the ``LM``'s parameters, ``step`` an int32 tensor. A
step consumes its state: the parameters and moments are updated in place
(as a JAX step with donated buffers), and the state it returns is the
one to use. Metrics stay tensors on the device; nothing in a step waits
for the host.

With ``axes`` (a mesh), the state is sharded (``launch.specs.
tree_shardings``, placed with ``device_put``): the batch — global, the
same on every rank — is placed over the data-parallel axes, the
gradients come back placed as their parameters (DTensor reduces them),
int8 compression shares each leaf's global largest magnitude, and the
norm is global. The metrics are plain tensors, the same on every rank.

The update is a transaction as far as memory goes (``optim.adamw``):
gradients and the int8 feedback are computed before it, and it allocates
everything before its first in-place write, in a ``Workspace`` that the
step keeps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import as_tensor
from ..distributed.collectives import compress_with_feedback, init_feedback
from ..distributed.sharding import full
from ..models import loss_fn
from ..optim import OptConfig, Workspace, adamw_update, init_opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    grad_compression: Optional[str] = None  # None | "int8_ef"


def init_train_state(cfg, params, tcfg: TrainConfig):
    """The train state around ``params`` (an ``LM``, whose parameters this
    turns trainable)."""
    params.requires_grad_(True)
    state = {"params": params, "opt": init_opt(params)}
    if tcfg.grad_compression == "int8_ef":
        state["feedback"] = init_feedback(params)
    return state


def _placed_as(g, p):
    """The gradient ``g`` placed as its parameter ``p`` is."""
    if hasattr(p, "placements") and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg, run, tcfg: TrainConfig, axes=None):
    """Returns train_step(state, batch) → (state, metrics)."""
    workspace = Workspace()

    def grads_of(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = loss_fn(cfg, params, batch, run, axes)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grads = [_placed_as(g, p) for g, p in zip(grads, leaves)]
        metrics = {k: full(v).detach() for k, v in metrics.items()}
        return dict(zip(names, grads)), dict(metrics,
                                             loss=full(loss).detach())

    def accumulate(params, batch):
        k = tcfg.microbatches
        batch = {key: as_tensor(v, params.device) for key, v in batch.items()}
        if k == 1:
            return grads_of(params, batch)
        split = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])
                 for key, v in batch.items()}
        grads = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in params.named_parameters()}
        zero = torch.zeros((), dtype=torch.float32, device=params.device)
        metrics = {"ce": zero, "aux": zero, "loss": zero}
        for i in range(k):
            g, m = grads_of(params, {key: v[i] for key, v in split.items()})
            for n, acc in grads.items():
                acc.add_(g[n].float())
            metrics = {key: a + m[key] for key, a in metrics.items()}
            del g
        for acc in grads.values():
            acc.div_(k)
        return grads, {key: m / k for key, m in metrics.items()}

    def train_step(state, batch):
        grads, metrics = accumulate(state["params"], batch)
        if tcfg.grad_compression == "int8_ef":
            grads, new_fb = compress_with_feedback(grads, state["feedback"])
        params, opt, stats = adamw_update(
            tcfg.opt, state["params"], grads, state["opt"], workspace)
        new_state = {"params": params, "opt": opt}
        if tcfg.grad_compression == "int8_ef":
            new_state["feedback"] = new_fb
        return new_state, dict(metrics, **stats)

    return train_step


def make_eval_step(cfg, run, axes=None):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(cfg, params, batch, run, axes)
        return {k: full(v) for k, v in dict(metrics, loss=loss).items()}
    return eval_step
