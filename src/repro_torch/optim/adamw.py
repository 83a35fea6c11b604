"""AdamW + global-norm clipping + warmup-cosine schedule in PyTorch (the
JAX package's ``optim/adamw.py``).

Parameters are named tensors: an ``LM`` (its ``named_parameters``) or a
dict of tensors; gradients and the moments ``m``/``v`` are dicts under
the same names. Optimizer state is fp32 whatever the compute dtype.
Sharded parameters are DTensors, their gradients and moments placed as
they are: the update is elementwise, so each rank updates its own part,
and the gradient norm is the global one.

The update is written out as the reference writes it,
``p32 - lr * (mhat / (sqrt(vhat) + eps) + wd * p32)`` (``torch.optim.AdamW``
places eps and the decay differently), one rounding per operation in the
reference's order. ``step`` is an int32 tensor on the parameters' device,
and the schedule and the bias corrections are float32 tensors computed
from it, as in JAX, so a step needs no host sync.

The update runs in place on the parameters and moments, over pieces of
at most ``GROUP_ELEMENTS`` elements (whole tensors grouped, a larger one
cut into flat slices), and it is a transaction as far as memory goes:
everything it needs — the norm, the scalars and a ``Workspace`` of four
piece-sized fp32 buffers, kept across steps by the train step — is
allocated before its first in-place write, and after that it allocates
nothing (per-tensor ``out=`` ops into the workspace, ``torch._foreach_*``
ops in place). A failure before the first write leaves the state as it
was; a failure after it raises ``TornStateError``: the state is half
updated and must not be continued (the JAX package's jitted step cannot
fail half way).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..distributed.sharding import like, local, partial_over

#: Elements of one piece of the in-place update (the workspace holds four
#: times this many floats; a larger tensor is cut into pieces).
GROUP_ELEMENTS = 1 << 26


class TornStateError(RuntimeError):
    """A step failed after its first in-place write to the train state:
    the parameters and moments are half updated."""


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
    """Zero moments named and placed as ``params``, and step 0."""
    p = named(params)
    dev = next(iter(p.values())).device

    def zeros():
        return {n: torch.zeros_like(t, dtype=torch.float32)
                for n, t in p.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a plain tensor. Sharded
    leaves' partial sums are reduced in one message for each placement
    they share."""
    leaves = list(named(tree).values())
    sums = [torch.sum(torch.square(local(g).float())) for g in leaves]
    by_placement = {}
    for i, g in enumerate(leaves):
        if isinstance(g, DTensor):
            by_placement.setdefault((g.device_mesh, g.placements),
                                    []).append(i)
    for (dm, pl), idx in by_placement.items():
        total = DTensor.from_local(
            torch.stack([sums[i] for i in idx]), dm,
            partial_over(leaves[idx[0]]), run_check=False).full_tensor()
        for j, i in enumerate(idx):
            sums[i] = total[j]
    return torch.sqrt(torch.stack(sums).sum())


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


def _pieces(tensor_lists, cap: int):
    """The update's pieces: for each group of ``_groups``, the lists'
    tensors at its indices; a group of one tensor larger than ``cap``
    (contiguous in every list) is cut into flat slices of ``cap``."""
    first = tensor_lists[0]
    for idx in _groups(first, cap):
        big = len(idx) == 1 and first[idx[0]].numel() > cap
        if big and all(ts[idx[0]].is_contiguous() for ts in tensor_lists):
            flat = [ts[idx[0]].view(-1) for ts in tensor_lists]
            for a in range(0, flat[0].numel(), cap):
                yield [[f[a:a + cap]] for f in flat]
        else:
            yield [[ts[i] for i in idx] for ts in tensor_lists]


class Workspace:
    """Four fp32 buffers that the update's temporaries live in, grown to
    the largest piece and then kept: one a train step, reused by each of
    its updates."""

    def __init__(self):
        self.buffers = None

    def get(self, n: int, device) -> list:
        """Four buffers of at least ``n`` elements on ``device``."""
        b = self.buffers
        if b is None or b[0].numel() < n or b[0].device != device:
            self.buffers = None                  # free the old ones first
            self.buffers = [torch.empty(n, dtype=torch.float32,
                                        device=device) for _ in range(4)]
        return self.buffers


def _views(buf, shapes):
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(buf[at:at + n].view(shape))
        at += n
    return out


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, opt_state,
                 workspace: Workspace = None):
    """One AdamW step → (params, new_opt_state, stats).

    ``params`` (fp32 masters) and the moments are updated in place and
    returned; the new state's ``step`` is a new tensor. ``workspace``
    holds the temporaries (a new one when None). Raises
    ``TornStateError`` when a failure comes after the first write."""
    p = named(params)
    names = list(p)
    if any(t.dtype != torch.float32 for t in p.values()):
        raise ValueError("adamw_update updates fp32 master parameters")
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = local(opt_state["step"]) + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    ps = [local(p[n]) for n in names]
    gs = [local(grads[n]).contiguous() for n in names]
    ms = [local(opt_state["m"][n]) for n in names]
    vs = [local(opt_state["v"][n]) for n in names]
    pieces = list(_pieces([ps, gs, ms, vs], GROUP_ELEMENTS))
    most = max((sum(t.numel() for t in piece[0]) for piece in pieces),
               default=0)
    ws = (workspace or Workspace()).get(most, step.device)
    written = False
    try:
        for p_, g_, m_, v_ in pieces:
            shapes = [t.shape for t in p_]
            w0, w1, w2, w3 = (_views(b, shapes) for b in ws)
            for g, w in zip(g_, w0):                 # g = clipped gradient
                torch.mul(g, scale, out=w)
            # m2 = b1 * m + (1 - b1) * g
            for g, w in zip(w0, w1):
                torch.mul(g, 1 - b1, out=w)
            written = True
            torch._foreach_mul_(m_, b1)
            torch._foreach_add_(m_, w1)
            # v2 = b2 * v + (1 - b2) * g * g
            for g, w in zip(w0, w1):
                torch.mul(g, 1 - b2, out=w)
            torch._foreach_mul_(w1, w0)
            torch._foreach_mul_(v_, b2)
            torch._foreach_add_(v_, w1)
            # delta = mhat / (sqrt(vhat) + eps)
            for v, w in zip(v_, w2):
                torch.div(v, bc2, out=w)
            torch._foreach_sqrt_(w2)
            torch._foreach_add_(w2, cfg.eps)
            for m, w in zip(m_, w3):
                torch.div(m, bc1, out=w)
            torch._foreach_div_(w3, w2)
            # p2 = p32 - lr * (delta + wd * p32)
            for q, w in zip(p_, w2):
                torch.mul(q, cfg.weight_decay, out=w)
            torch._foreach_add_(w3, w2)
            torch._foreach_mul_(w3, lr)
            torch._foreach_sub_(p_, w3)
    except Exception as e:
        if written:
            raise TornStateError(
                f"the AdamW update failed after its first in-place write "
                f"({type(e).__name__}: {e}): the train state is torn") from e
        raise
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": like(step, opt_state["step"])}, stats
