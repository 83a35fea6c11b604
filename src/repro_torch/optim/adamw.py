"""AdamW + global-norm clipping + warmup-cosine schedule in PyTorch (the
JAX package's ``optim/adamw.py``).

Parameters are named tensors: an ``LM`` (its ``named_parameters``) or a
dict of tensors; gradients and the moments ``m``/``v`` are dicts under
the same names. Optimizer state is fp32 whatever the compute dtype.

The update is written out as the reference writes it,
``p32 - lr * (mhat / (sqrt(vhat) + eps) + wd * p32)`` (``torch.optim.AdamW``
places eps and the decay differently), one rounding per operation in the
reference's order. ``step`` is an int32 tensor on the parameters' device,
and the schedule and the bias corrections are float32 tensors computed
from it, as in JAX, so a step needs no host sync. The update runs in
place on the parameters and moments with ``torch._foreach_*`` ops over
groups of at most ``GROUP_ELEMENTS`` elements, which bounds the
temporaries to a few groups' size.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

#: Elements of one group of the in-place update (its temporaries hold a
#: few times this many floats; a larger tensor is a group of its own).
GROUP_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def named(params) -> dict:
    """``{name: tensor}`` of an ``nn.Module``'s parameters or of a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def schedule(cfg: OptConfig, step):
    """Linear warmup → cosine decay to min_lr_frac·lr (a float32 tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt(params) -> dict:
    p = named(params)
    dev = next(iter(p.values())).device

    def zeros():
        return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for n, t in p.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    leaves = list(named(tree).values())
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in leaves]).sum())


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.float() * scale for n, g in named(grads).items()}, norm


def _groups(tensors, cap: int = GROUP_ELEMENTS):
    """Consecutive index ranges of ``tensors`` holding at most ``cap``
    elements each (a larger tensor alone)."""
    start, size = 0, 0
    for i, t in enumerate(tensors):
        if i > start and size + t.numel() > cap:
            yield range(start, i)
            start, size = i, 0
        size += t.numel()
    if start < len(tensors):
        yield range(start, len(tensors))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, opt_state):
    """One AdamW step → (params, new_opt_state, stats).

    ``params`` (fp32 masters) and the moments are updated in place and
    returned; the new state's ``step`` is a new tensor."""
    p = named(params)
    names = list(p)
    ps = [p[n] for n in names]
    if any(t.dtype != torch.float32 for t in ps):
        raise ValueError("adamw_update updates fp32 master parameters")
    gs = [grads[n] for n in names]
    ms = [opt_state["m"][n] for n in names]
    vs = [opt_state["v"][n] for n in names]
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for idx in _groups(ps):
        p_, m_, v_ = ([x[i] for i in idx] for x in (ps, ms, vs))
        g = torch._foreach_mul([gs[i].float() for i in idx], scale)
        # m2 = b1 * m + (1 - b1) * g
        t = torch._foreach_mul(g, 1 - b1)
        torch._foreach_mul_(m_, b1)
        torch._foreach_add_(m_, t)
        # v2 = b2 * v + (1 - b2) * g * g
        t = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(t, g)
        del g
        torch._foreach_mul_(v_, b2)
        torch._foreach_add_(v_, t)
        del t
        # delta = mhat / (sqrt(vhat) + eps)
        den = torch._foreach_div(v_, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(m_, bc1)
        torch._foreach_div_(upd, den)
        del den
        # p2 = p32 - lr * (delta + wd * p32)
        torch._foreach_add_(upd, torch._foreach_mul(p_, cfg.weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(p_, upd)
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, \
        stats
