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
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

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


def _project_qkv(params, cfg, x, positions):
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q = q + params.bq.to(q.dtype)
        k = k + params.bk.to(k.dtype)
        v = v + params.bv.to(v.dtype)
    q = apply_rope(q.reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hkv, dh), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, hkv, dh)


def _gqa_scores(q, k, scale):
    """q: (B,Sq,H,D), k: (B,Sk,Hkv,D) → scores (B,Hkv,G,Sq,Sk) fp32."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
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
    scores = torch.where(mask, scores, NEG_INF)
    return _gqa_values(torch.softmax(scores, dim=-1), v)


def _chunked_attention(q, k, v, scale, chunk: int):
    """Online-softmax loop over KV chunks (memory-bounded)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=v.dtype, device=q.device)
    for j in range(k.shape[1] // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        scores = _gqa_scores(q, kj, scale)                  # (B,Hkv,G,Sq,ck)
        kpos = j * chunk + torch.arange(chunk, device=q.device)
        scores = torch.where(_causal_mask(qpos, kpos), scores, NEG_INF)
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
        scores = torch.where(_causal_mask(qpos, kpos), scores, NEG_INF)
        outs.append(_gqa_values(torch.softmax(scores, dim=-1),
                                v[:, :kv_end]))
    return torch.cat(outs, dim=1)


def attention(params, cfg, x, positions, mode: str = "dense",
              chunk: int = 1024):
    """Causal self-attention over a full sequence (train / prefill).

    Returns (out (B,S,d), (k, v)): the K/V are what prefill stores."""
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    q, k, v = _project_qkv(params, cfg, x, positions)
    kv_for_cache = (k, v)
    s = x.shape[1]
    chunk = min(chunk, s)
    if mode == "dense" or s <= chunk:
        out = _dense_attention(q, k, v, scale)
    else:
        pad = (-s) % chunk  # padded tail is "future" → causally masked out
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                       for t in (q, k, v))
        if mode == "chunked":
            out = _chunked_attention(q, k, v, scale, chunk)
        elif mode == "triangular":
            out = _triangular_attention(q, k, v, scale, chunk)
        else:
            raise ValueError(f"unknown attention mode {mode!r}")
        out = out[:, :s]
    return out.reshape(*x.shape[:2], -1) @ params.wo, kv_for_cache


def decode_attention(params, cfg, x, cache_k, cache_v, pos):
    """Single-token decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, S_max, Hkv, Dh), written in place at
    ``pos``; pos: (B,) current lengths, each below S_max. Returns
    out (B, 1, d)."""
    b = x.shape[0]
    scale = 1.0 / np.sqrt(cfg.resolved_head_dim)
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])
    idx = (torch.arange(b, device=x.device), pos.long())
    cache_k.index_put_(idx, k[:, 0].to(cache_k.dtype))
    cache_v.index_put_(idx, v[:, 0].to(cache_v.dtype))
    scores = _gqa_scores(q, cache_k.to(q.dtype), scale)    # (B,Hkv,G,1,S)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    mask = kpos[None, :] <= pos[:, None]                   # (B, S)
    scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    out = _gqa_values(torch.softmax(scores, dim=-1), cache_v.to(q.dtype))
    return out.reshape(b, 1, -1) @ params.wo
