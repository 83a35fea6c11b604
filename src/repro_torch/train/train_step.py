"""Training step in PyTorch (the JAX package's ``train/train_step.py``):
autograd through the model's remat, microbatch gradient accumulation and
optional int8 gradient compression with error feedback, on one device.

The train state is ``{"params": LM, "opt": {"m", "v", "step"}}`` (plus
``"feedback"`` under ``int8_ef``): ``m``, ``v`` and ``feedback`` are fp32
tensors named as the ``LM``'s parameters, ``step`` an int32 tensor. A
step consumes its state: the parameters and moments are updated in place
(as a JAX step with donated buffers), and the state it returns is the
one to use. Metrics stay tensors on the device; nothing in a step waits
for the host. Sharded training (``axes``) comes with ROADMAP item 14(b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import as_tensor
from ..distributed.collectives import compress_with_feedback, init_feedback
from ..models import loss_fn
from ..optim import OptConfig, adamw_update, init_opt


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


def _no_axes(axes):
    if axes is not None:
        raise NotImplementedError(
            "sharded training (axes) comes with ROADMAP item 14(b)")


def make_train_step(cfg, run, tcfg: TrainConfig, axes=None):
    """Returns train_step(state, batch) → (state, metrics)."""
    _no_axes(axes)

    def grads_of(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = loss_fn(cfg, params, batch, run)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(zip(names, grads)), dict(metrics, loss=loss.detach())

    def accumulate(params, batch):
        k = tcfg.microbatches
        batch = {key: as_tensor(v, params.device) for key, v in batch.items()}
        if k == 1:
            return grads_of(params, batch)
        split = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])
                 for key, v in batch.items()}
        grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
            tcfg.opt, state["params"], grads, state["opt"])
        new_state = {"params": params, "opt": opt}
        if tcfg.grad_compression == "int8_ef":
            new_state["feedback"] = new_fb
        return new_state, dict(metrics, **stats)

    return train_step


def make_eval_step(cfg, run, axes=None):
    _no_axes(axes)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(cfg, params, batch, run)
        return dict(metrics, loss=loss)
    return eval_step
