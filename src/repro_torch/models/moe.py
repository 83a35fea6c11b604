"""Token-choice top-k MoE with expert parallelism (EP) in PyTorch (the
JAX package's ``models/moe.py``).

Each token's k slots are scattered into per-expert capacity buckets
[E, c, d], the experts run as batched products, and the slots come back
weighted by their gates. Capacity c = ceil(T_local · k · cf / E);
overflow slots are dropped (Switch-style, no gate renormalisation after
the drop). Gates are top-k-normalised; the router runs in fp32 with the
Switch aux loss.

Under a mesh, two communication layouts over the TP ("model") axis, one
math — the reference's ``shard_map`` body, written on each rank's local
parts (``DTensor.to_local`` / ``from_local``):

  * "a2a" (train/prefill, S divisible by TP and > 1): tokens are sharded
    over (data × model); each rank routes its local tokens into buckets,
    an ``all_to_all`` over the model axis delivers each expert's buckets
    to the rank that owns it (experts are sharded over "model"), the
    experts run, and the inverse ``all_to_all`` returns the outputs.
  * "replicated" (decode): tokens are sharded over data only; each rank
    runs just its local experts on all its tokens and a sum over "model"
    combines them.

Capacity is per (source rank, expert), so the paths equal the mesh-free
one where nothing drops. ``aux`` is each rank's aux averaged over the
ranks (close to the global aux, not equal; ranks holding the same tokens
count once). A batch the data axes do not divide stays whole on every
rank. The collectives are autograd functions whose backward is the
transpose the reference's would be, given gradients that arrive
replicated over the model axis.

Ties and order follow the reference exactly:
  * top-k breaks ties toward the lower expert id (``lax.top_k``): a
    stable descending sort, first k (``torch.topk`` promises no tie order
    on CUDA);
  * the rank of a slot in its expert is its order in a stable argsort;
  * a token's k slots are summed over ``reshape(t, k, d)`` (slots are
    token-major), not with atomics, so the sum's order is fixed.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import contiguous_strides, local_part
from .layers import Init


class MoE(nn.Module):
    def __init__(self, init: Init, cfg):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = init.normal((d, e), d)
        self.w_gate = init.normal((e, d, ff), d)
        self.w_up = init.normal((e, d, ff), d)
        self.w_down = init.normal((e, ff, d), ff)


def _route(x, router_w, n_experts, topk):
    """Router: fp32 softmax → top-k (normalised gates) + aux loss."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :topk], ids[:, :topk]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # Switch aux loss: E * sum_e f_e * p_e  (f = fraction routed, p = mean prob)
    t = x.shape[0]
    ids = expert_ids.reshape(-1)
    counts = torch.zeros(n_experts, device=x.device).scatter_add_(
        0, ids, torch.ones(ids.shape, device=x.device))
    f = counts / max(t * topk, 1)
    aux = n_experts * torch.sum(f * probs.mean(dim=0))
    return gate_vals, expert_ids, aux


def _bucketize(x_flat, expert_ids, gate_vals, n_buckets, capacity,
               expert_offset=0):
    """Scatter token slots into per-expert capacity buckets.

    Returns (buckets [n_buckets, c, d], slot refs for the return trip).
    Overflow / out-of-range slots add zero (positions are unique per kept
    slot, so the accumulating put is exact)."""
    t, k = expert_ids.shape
    d = x_flat.shape[-1]
    dev = x_flat.device
    slot_expert = expert_ids.reshape(-1) - expert_offset       # (t*k,)
    slot_token = torch.arange(t * k, device=dev) // k
    in_range = (slot_expert >= 0) & (slot_expert < n_buckets)
    e_idx = torch.where(in_range, slot_expert, 0)
    # Rank of each slot within its expert group (stable, slot-index order).
    bucket = torch.where(in_range, e_idx, n_buckets)
    counts = torch.zeros(n_buckets + 1, dtype=torch.long, device=dev)
    counts = counts.scatter_add_(0, bucket, torch.ones_like(bucket))
    counts = counts[:n_buckets]
    order = torch.argsort(bucket, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=dev) - starts[e_idx[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = in_range & (pos < capacity)
    pos_c = torch.clamp(pos, max=capacity - 1)
    contrib = x_flat[slot_token] * keep[:, None].to(x_flat.dtype)
    buckets = torch.zeros((n_buckets, capacity, d), dtype=x_flat.dtype,
                          device=dev)
    buckets.index_put_((e_idx, pos_c), contrib, accumulate=True)
    return buckets, (e_idx, pos_c, keep, slot_token, gate_vals.reshape(-1))


def _unbucketize(buckets, slot_refs, t):
    e_idx, pos_c, keep, slot_token, slot_gate = slot_refs
    y_slots = buckets[e_idx, pos_c]                            # (t*k, d)
    w = (slot_gate * keep).to(y_slots.dtype)[:, None]
    return (y_slots * w).reshape(t, -1, y_slots.shape[-1]).sum(dim=1)


def _expert_ffn(xin, w_gate, w_up, w_down):
    """Batched-per-expert SwiGLU: xin (E, T_e, d)."""
    dt = xin.dtype
    h = F.silu(torch.einsum("etd,edf->etf", xin, w_gate.to(dt)))
    h = h * torch.einsum("etd,edf->etf", xin, w_up.to(dt))
    return torch.einsum("etf,efd->etd", h, w_down.to(dt))


def _capacity(t_local: int, topk: int, n_experts: int, cf: float) -> int:
    return max(1, math.ceil(t_local * topk * cf / n_experts))


def moe_mlp(params, cfg, x, axes=None):
    """MoE FF block. x: (B, S, d) → ((B, S, d), aux_loss).

    Under a mesh ``x`` and the parameters are DTensors (``Axes.place``,
    ``launch.specs.device_put``); the output is a DTensor with the batch
    over the data axes and ``aux`` a replicated one."""
    b, s, d = x.shape
    e, k, cf = cfg.n_experts, cfg.topk, cfg.capacity_factor

    if axes is None or axes.mesh is None or axes.tp is None:
        c = _capacity(b * s, k, e, cf)
        x_flat = x.reshape(-1, d)
        gates, ids, aux = _route(x_flat, params.router, e, k)
        buckets, refs = _bucketize(x_flat, ids, gates, e, c)
        y = _expert_ffn(buckets, params.w_gate, params.w_up, params.w_down)
        return _unbucketize(y, refs, b * s).reshape(b, s, d), aux

    mesh = axes.mesh
    tp_size = axes.tp_size
    if e % tp_size:
        raise ValueError(f"n_experts={e} must divide TP size {tp_size}")
    e_local = e // tp_size
    use_a2a = s % tp_size == 0 and s > 1
    n_dp = math.prod(mesh.shape[a] for a in axes.dp)
    # A batch the data axes do not divide stays whole on every rank (as
    # ``Axes.constrain`` leaves it).
    dp = "dp" if b % n_dp == 0 else None
    x_dims = (dp, "tp" if use_a2a else None, None)
    t_local = (b * s) // ((n_dp if dp else 1) * (tp_size if use_a2a else 1))
    c = _capacity(t_local, k, e, cf)
    dm = mesh.device_mesh(x.device.type)
    tp_dim = mesh.dtensor_dims.index(axes.tp)
    x_pl = axes.placements(axes.spec(*x_dims))
    # The mesh dims over which ranks hold different tokens.
    split = [isinstance(p, Shard) for p in x_pl]

    def part(t, dims, grad):
        """This rank's part of ``t`` placed by ``dims``; ``grad``: how the
        part's gradient combines, a placement a mesh dim."""
        if not isinstance(t, DTensor):
            raise TypeError("under a mesh moe_mlp takes DTensors: place x "
                            "with Axes.place and the weights with "
                            "launch.specs.device_put")
        return local_part(t.redistribute(dm, axes.placements(
            axes.spec(*dims))), grad)

    def param_grad(on_tp):
        """A parameter part's gradient: each rank's share of the sum over
        the dims that split the tokens, whole across the others."""
        return tuple(on_tp if i == tp_dim else
                     (Partial() if split[i] else Replicate())
                     for i in range(len(x_pl)))

    # Tokens: on the replicated path every model rank holds all of its
    # row's tokens and each contributes a share of their gradient.
    x_l = part(x, x_dims, x_pl if use_a2a else tuple(
        Partial() if i == tp_dim else p for i, p in enumerate(x_pl)))
    router = part(params.router, (), param_grad(Partial()))
    w = [part(params_w, ("tp", None, None), param_grad(Shard(0)))
         for params_w in (params.w_gate, params.w_up, params.w_down)]

    group = mesh.group(axes.tp)
    bl, sl, _ = x_l.shape
    t = bl * sl
    x_flat = x_l.reshape(t, d)
    gates, ids, aux = _route(x_flat, router, e, k)
    if use_a2a:
        buckets, refs = _bucketize(x_flat, ids, gates, e, c)
        recv = _AllToAll.apply(buckets, group)              # (tp*E_l, c, d)
        xin = (recv.reshape(tp_size, e_local, c, d).transpose(0, 1)
               .reshape(e_local, tp_size * c, d))
        y = _expert_ffn(xin, *w)
        y = (y.reshape(e_local, tp_size, c, d).transpose(0, 1)
             .reshape(tp_size * e_local, c, d))
        yback = _AllToAll.apply(y, group)                   # (E, c, d)
        out = _unbucketize(yback, refs, t)
    else:
        shard = mesh.coords()[axes.tp]
        buckets, refs = _bucketize(x_flat, ids, gates, e_local, c,
                                   expert_offset=shard * e_local)
        y = _expert_ffn(buckets, *w)
        out = _SumOver.apply(_unbucketize(y, refs, t), (group,))
    # The mean of the aux over the model axis and the dims that split the
    # tokens (ranks that hold the same tokens count once).
    over = [i for i in range(len(x_pl)) if i == tp_dim or split[i]]
    aux = _SumOver.apply(aux, tuple(mesh.group(mesh.dtensor_dims[i])
                                    for i in over))
    aux = aux / math.prod(dm.size(i) for i in over)
    out = DTensor.from_local(out.reshape(bl, sl, d), dm, x_pl,
                             run_check=False, shape=x.shape,
                             stride=contiguous_strides(x.shape))
    aux = DTensor.from_local(aux, dm, [Replicate()] * len(x_pl),
                             run_check=False)
    # back to the activations' layout (batch over the data axes) for the
    # residual add: torch 2.11's DTensor cannot flatten the sequence
    # sharded over "model" in the next layer's products
    return axes.constrain(out, "dp", None, None), aux


def _wire(x, group):
    """``x`` on the device a message to ``group`` travels on, and back."""
    from ..distributed.collectives import wire_device
    wire = wire_device(x.device, group)
    return x.to(wire), (lambda y: y.to(x.device))


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all over ``group`` along dim 0 (``lax.all_to_all``
    with split_axis = concat_axis = 0, tiled): its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    send, back = _wire(x.contiguous(), group)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return back(out)


class _SumOver(torch.autograd.Function):
    """``psum`` over each group of ``groups`` in turn (the sum over their
    product). The output is the same on every rank and its gradient
    arrives replicated, so each rank's share passes it on unchanged."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            send, back = _wire(x.clone(), g)
            dist.all_reduce(send, group=g)
            x = back(send)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None
