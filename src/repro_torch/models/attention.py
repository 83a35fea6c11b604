"""GQA attention in PyTorch (the JAX package's ``models/attention.py``):
training/prefill over a full sequence, and single-token decode.

Three full-sequence modes, numerically equivalent and checked against
each other:

  * "dense"      — the full S×S masked product.
  * "chunked"    — a loop over KV chunks with online softmax (flash-style
                   rescaling); memory O(S·ck), the accumulator in the value
                   dtype as in the reference.
  * "triangular" — query blocks against their causal KV prefix only.

Scores are fp32 whatever the compute dtype: the reference multiplies bf16
q and k with ``preferred_element_type=float32``, so q and k are upcast
before the product here (a bf16 einsum would round the scores to bf16).

Decode: a single-token query against the KV cache, which is written in
place at each example's position.

Under a mesh (``axes``) q/k/v are constrained by heads over the model
axis where it divides them, as in the reference; ``pad_heads`` pads the
heads to divisibility instead.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import (all_reduce, contiguous_strides, full,
                                    grad_placed_as, local, local_part,
                                    local_ranges, pad, replicated, shards,
                                    unshard)
from .layers import Init, apply_rope

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, init: Init, cfg):
        super().__init__()
        d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh = cfg.resolved_head_dim
        self.wq = init.normal((d, h * dh), d)
        self.wk = init.normal((d, hkv * dh), d)
        self.wv = init.normal((d, hkv * dh), d)
        self.wo = init.normal((h * dh, d), h * dh)
        if cfg.qkv_bias:
            self.bq = init.zeros(h * dh)
            self.bk = init.zeros(hkv * dh)
            self.bv = init.zeros(hkv * dh)


def _project_qkv(params, cfg, x, positions, axes=None):
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q = q + params.bq.to(q.dtype)
        k = k + params.bk.to(k.dtype)
        v = v + params.bv.to(v.dtype)
    q = apply_rope(_heads(q, h, axes), positions, cfg.rope_theta)
    k = apply_rope(_heads(k, hkv, axes), positions, cfg.rope_theta)
    v = _heads(v, hkv, axes)
    if axes is not None:
        tq = axes.tp_if_divisible(h)
        tkv = axes.tp_if_divisible(hkv)
        q = axes.constrain(q, "dp", None, tq, None)
        k = axes.constrain(k, "dp", None, tkv, None)
        v = axes.constrain(v, "dp", None, tkv, None)
    return q, k, v


def _heads(t, n, axes):
    """(B, S, n·Dh) → (B, S, n, Dh). A projection sharded over a model
    axis that does not divide its n heads is gathered whole first:
    DTensor cannot split a sharded dim unevenly (GSPMD reshards it)."""
    if axes is not None and not axes.tp_if_divisible(n):
        t = unshard(t, -1)
    return t.reshape(*t.shape[:2], n, -1)


def _group(q, hkv):
    """(B, S, H, D) → (B, S, Hkv, G, D), kv-major. Heads sharded more ways
    than Hkv divides are gathered whole first (DTensor cannot split a
    sharded dim unevenly)."""
    b, s, h, dh = q.shape
    if hkv % shards(q, 2):
        q = unshard(q, 2)
    return q.reshape(b, s, hkv, h // hkv, dh)


def _gqa_scores(q, k, scale):
    """q: (B,Sq,H,D), k: (B,Sk,Hkv,D) → scores (B,Hkv,G,Sq,Sk) fp32."""
    qg = _group(q, k.shape[2])
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale


def _gqa_values(probs, v):
    """probs: (B,Hkv,G,Sq,Sk), v: (B,Sk,Hkv,D) → (B,Sq,H,D)."""
    b, hkv, g, sq, sk = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hkv * g, -1)


def _causal_mask(qpos, kpos):
    return qpos[:, None] >= kpos[None, :]


def _dense_attention(q, k, v, scale):
    sq, sk = q.shape[1], k.shape[1]
    scores = _gqa_scores(q, k, scale)
    mask = _causal_mask(torch.arange(sq, device=q.device),
                        torch.arange(sk, device=q.device))
    scores = torch.where(replicated(mask, scores), scores, NEG_INF)
    return _gqa_values(torch.softmax(scores, dim=-1), v)


def _chunked_attention(q, k, v, scale, chunk: int):
    """Online-softmax loop over KV chunks (memory-bounded)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qpos = torch.arange(sq, device=q.device)
    m = replicated(torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                              device=q.device), q)
    l = replicated(torch.zeros((b, hkv, g, sq), dtype=torch.float32,
                               device=q.device), q)
    acc = replicated(torch.zeros((b, hkv, g, sq, dh), dtype=v.dtype,
                                 device=q.device), q)
    for j in range(k.shape[1] // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        scores = _gqa_scores(q, kj, scale)                  # (B,Hkv,G,Sq,ck)
        kpos = j * chunk + torch.arange(chunk, device=q.device)
        scores = torch.where(replicated(_causal_mask(qpos, kpos), scores),
                             scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype), vj)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def _triangular_attention(q, k, v, scale, chunk: int):
    """Query blocks against their causal KV prefix: exact causal FLOPs."""
    outs = []
    for i in range(q.shape[1] // chunk):
        kv_end = (i + 1) * chunk
        scores = _gqa_scores(q[:, i * chunk:kv_end], k[:, :kv_end], scale)
        qpos = i * chunk + torch.arange(chunk, device=q.device)
        kpos = torch.arange(kv_end, device=q.device)
        scores = torch.where(replicated(_causal_mask(qpos, kpos), scores),
                             scores, NEG_INF)
        outs.append(_gqa_values(torch.softmax(scores, dim=-1),
                                v[:, :kv_end]))
    return torch.cat(outs, dim=1)


def _pad_heads_for_tp(q, k, v, cfg, axes):
    """Pad KV heads (and q-head groups with them) up to TP divisibility.

    A head count the model axis does not divide would be left replicated
    across it (every rank doing all heads); zero-padding to the next
    multiple shards it. Padded heads are appended at the tail of the
    kv-major layout, so slicing the output back is a contiguous cut."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    tp = axes.tp_size
    g = h // hkv
    hkv_p = -(-hkv // tp) * tp
    qg = pad(_group(q, hkv), (0, 0, 0, 0, 0, hkv_p - hkv))
    q = qg.reshape(b, s, hkv_p * g, dh)
    k = pad(k, (0, 0, 0, hkv_p - hkv))
    v = pad(v, (0, 0, 0, hkv_p - hkv))
    q = axes.constrain(q, "dp", None, "tp", None)
    k = axes.constrain(k, "dp", None, "tp", None)
    v = axes.constrain(v, "dp", None, "tp", None)
    return q, k, v, (hkv, hkv_p, g)


def _unpad_heads(out, pad_info):
    hkv, hkv_p, g = pad_info
    b, s, _, dh = out.shape
    out = out.reshape(b, s, hkv_p, g, dh)[:, :, :hkv]
    return out.reshape(b, s, hkv * g, dh)


def _per_block(core, q, k, v, axes):
    """``core(q, k, v)`` → (B, S, H, Dh) on each rank's block of batch and
    heads. Attention is independent across both, so under a mesh each
    rank runs ``core`` on its own rows (over the data axes) and heads
    (over the model axis when it divides the q and kv heads alike —
    rank r's q heads are then the groups of its kv heads; else every
    model rank does all heads, as GSPMD replicates such attention).
    DTensor's own rules would plan the scores' product afresh over every
    axis, which on a 3-D mesh takes minutes of host time."""
    if not isinstance(q, DTensor):
        return core(q, k, v)
    heads = axes.tp if (axes.tp_if_divisible(q.shape[2])
                        and axes.tp_if_divisible(k.shape[2])) else None
    dims = ("dp", None, heads, None)
    q, k, v = (axes.constrain(t, *dims) for t in (q, k, v))
    # contiguous, as the strides declared below say (a later reshape of a
    # part split over the heads would otherwise fail to view)
    out = core(*(local_part(t) for t in (q, k, v))).contiguous()
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=contiguous_strides(q.shape))


def attention(params, cfg, x, positions, mode: str = "dense",
              chunk: int = 1024, axes=None, pad_heads: bool = False):
    """Causal self-attention over a full sequence (train / prefill).

    Returns (out (B,S,d), (k, v)): the K/V (the real, unpadded heads) are
    what prefill stores. ``pad_heads`` pads the heads to the model axis
    under a mesh whose TP size does not divide them."""
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    q, k, v = _project_qkv(params, cfg, x, positions, axes)
    kv_for_cache = (k, v)
    pad_info = None
    if (pad_heads and axes is not None and axes.tp
            and (cfg.n_heads % axes.tp_size or
                 cfg.n_kv_heads % axes.tp_size)):
        q, k, v, pad_info = _pad_heads_for_tp(q, k, v, cfg, axes)
    s = x.shape[1]
    chunk = min(chunk, s)
    if mode not in ("dense", "chunked", "triangular"):
        raise ValueError(f"unknown attention mode {mode!r}")

    def core(q, k, v):
        if mode == "dense" or s <= chunk:
            return _dense_attention(q, k, v, scale)
        tail = (-s) % chunk  # padded tail is "future" → causally masked out
        if tail:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, tail)) for t in (q, k, v))
        if mode == "chunked":
            return _chunked_attention(q, k, v, scale, chunk)[:, :s]
        return _triangular_attention(q, k, v, scale, chunk)[:, :s]
    out = _per_block(core, q, k, v, axes)
    if pad_info is not None:
        out = _unpad_heads(out, pad_info)
    if axes is not None:
        out = axes.constrain(out, "dp", None,
                             axes.tp_if_divisible(cfg.n_heads), None)
    # the gradient comes back from ``wo`` split over head_dim·heads; a
    # head count the model axis does not divide cannot be split off it
    out = grad_placed_as(out.reshape(*x.shape[:2], -1))
    return out @ params.wo, kv_for_cache


def decode_attention(params, cfg, x, cache_k, cache_v, pos, axes=None):
    """Single-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, Hkv, Dh), written in place at
    ``pos`` (a sharded step writes the whole new K/V: the cache is a plain
    tensor); pos: (B,) current lengths, each below S_max. Returns
    out (B, 1, d)."""
    b = x.shape[0]
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    q, k, v = _project_qkv(params, cfg, x, pos[:, None], axes)
    if isinstance(cache_k, DTensor):
        out = _decode_sharded(q, k, v, cache_k, cache_v, pos, scale)
        return out.reshape(b, 1, -1) @ params.wo
    idx = (torch.arange(b, device=x.device), pos.long())
    cache_k.index_put_(idx, full(k)[:, 0].to(cache_k.dtype))
    cache_v.index_put_(idx, full(v)[:, 0].to(cache_v.dtype))
    scores = _gqa_scores(q, cache_k.to(q.dtype), scale)    # (B,Hkv,G,1,S)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    mask = kpos[None, :] <= pos[:, None]                   # (B, S)
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    out = _gqa_values(torch.softmax(scores, dim=-1), cache_v.to(q.dtype))
    return out.reshape(b, 1, -1) @ params.wo


def _decode_sharded(q, k, v, cache_k, cache_v, pos, scale):
    """``decode_attention`` on a cache sharded as ``launch.specs
    .cache_spec_tree`` places it (DTensors (B, S_max, Hkv, Dh) split over
    batch, sequence, kv heads or head_dim): each rank writes the new K/V
    into its own block and attends over it. A head_dim split sums the
    scores over its ranks; a sequence split combines the softmax
    statistics and the values across its ranks (flash-decode). Returns
    the whole (B, 1, H, Dh) output on every rank."""
    dm = cache_k.device_mesh
    split = {}
    for i, p in enumerate(cache_k.placements):
        if isinstance(p, Shard):
            if p.dim in split:
                raise ValueError(f"cache dim {p.dim} split over two mesh "
                                 f"dims: {cache_k.placements}")
            split[p.dim] = i
    (b0, b1), (s0, s1), (h0, h1), (d0, d1) = local_ranges(cache_k)
    g = q.shape[2] // cache_k.shape[2]
    ck, cv = local(cache_k), local(cache_v)
    posl = full(pos)[b0:b1].long()
    rows = torch.arange(b1 - b0, device=ck.device)
    at = torch.clamp(posl - s0, 0, s1 - s0 - 1)
    mine = ((posl >= s0) & (posl < s1))[:, None, None]
    for c, new in ((ck, k), (cv, v)):
        blk = full(new)[b0:b1, 0, h0:h1, d0:d1].to(c.dtype)
        c.index_put_((rows, at), torch.where(mine, blk, c[rows, at]))
    ql = full(q)[b0:b1, :, h0 * g:h1 * g, d0:d1]
    scores = _gqa_scores(ql, ck.to(ql.dtype), scale)   # (b,hkv,g,1,s)
    if 3 in split:
        scores = all_reduce(scores, "sum", dm, split[3])
    kpos = s0 + torch.arange(s1 - s0, device=ck.device)
    mask = kpos[None, :] <= posl[:, None]
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    if 1 in split:
        m = all_reduce(scores.amax(dim=-1, keepdim=True), "max", dm,
                       split[1])
        e = torch.exp(scores - m)
        probs = e / all_reduce(e.sum(dim=-1, keepdim=True), "sum", dm,
                               split[1])
        out = _gqa_values(probs, cv.to(ql.dtype))
        out = all_reduce(out.float(), "sum", dm, split[1]).to(ql.dtype)
    else:
        out = _gqa_values(torch.softmax(scores, dim=-1), cv.to(ql.dtype))
    shape = (q.shape[0], 1, q.shape[2], q.shape[3])
    pl = [Replicate()] * dm.ndim
    for dim in (0, 2, 3):
        if dim in split:
            pl[split[dim]] = Shard(dim)
    return DTensor.from_local(out.contiguous(), dm, pl, run_check=False,
                              shape=shape,
                              stride=contiguous_strides(shape)).full_tensor()
