"""Token-choice top-k MoE in PyTorch (the unsharded path of the JAX
package's ``models/moe.py``).

Each token's k slots are scattered into per-expert capacity buckets
[E, c, d], the experts run as batched products, and the slots come back
weighted by their gates. Capacity c = ceil(T · k · cf / E); overflow slots
are dropped (Switch-style, no gate renormalisation after the drop). Gates
are top-k-normalised; the router runs in fp32 with the Switch aux loss.

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
import torch.nn.functional as F
from torch import nn

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


def moe_mlp(params, cfg, x):
    """MoE FF block. x: (B, S, d) → ((B, S, d), aux_loss)."""
    b, s, d = x.shape
    e, k, cf = cfg.n_experts, cfg.topk, cfg.capacity_factor
    c = _capacity(b * s, k, e, cf)
    x_flat = x.reshape(-1, d)
    gates, ids, aux = _route(x_flat, params.router, e, k)
    buckets, refs = _bucketize(x_flat, ids, gates, e, c)
    y = _expert_ffn(buckets, params.w_gate, params.w_up, params.w_down)
    return _unbucketize(y, refs, b * s).reshape(b, s, d), aux
