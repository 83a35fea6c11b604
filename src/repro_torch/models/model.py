"""Model zoo in PyTorch (the JAX package's ``models/model.py``): any
``ArchConfig`` as a servable LM.

Families: dense (llama/phi/qwen/granite), moe (qwen3/granite MoE), ssm
(mamba2), hybrid (zamba2: an SSM backbone plus one shared attention block
invoked every ``attn_every`` layers), audio/vlm (a dense backbone with a
stub frontend: inputs may be precomputed embeddings instead of token ids).

An ``LM`` holds fp32 master parameters in a ``ModuleList`` of per-family
blocks, named as the reference's parameter tree (``blocks.<l>.attn.wq``
is layer l of the reference's stacked ``blocks/attn/wq``). Compute runs on
the parameters cast to the compute dtype (``cast_params``, the reference's
``_cast_params``), a tree of tensors with the ``LM``'s attribute paths.
With grad enabled ``forward`` and ``loss_fn`` cast inside the autograd
graph, so gradients reach the fp32 masters; ``prefill`` (no grad) makes a
detached copy once and the ``decode_step``s after it reuse it (nothing
changes the weights while serving), where the reference casts on every
call. The layer stack is a Python loop; ``RunConfig.scan_layers`` is accepted
and changes nothing here (the reference gives the same answer either
way); ``pad_heads`` pads attention heads to the model axis under a mesh.

Every entry point takes ``axes`` (a ``distributed.Axes``, after ``run``
so that positional calls keep working). Under a mesh the parameters are
DTensors (``launch.specs.tree_shardings``), the batch is placed over the
data-parallel axes, each ``constrain`` sits where the reference's sits,
and the constants that meet sharded activations are replicated DTensors;
serving runs in ``axes.context()``. Its cache is a plain tensor that
every rank holds whole, or, where the caller places it (``prefill``'s
``cache=``; ``launch.specs.cache_spec_tree``), DTensors that each rank
writes and reads its own block of (``attention.decode_attention``).

Rematerialisation (``RunConfig.remat``) wraps the reference's bodies: a
dense or MoE block, a hybrid group (the shared block and its SSM layers),
an SSM block. ``"full"`` keeps only each body's inputs
(``torch.utils.checkpoint``, non-reentrant); ``"dots"`` also keeps the
outputs of its unbatched matmuls (``aten.mm``), the counterpart of
``dots_with_no_batch_dims_saveable``.

The serving cache has the reference's layout and dtypes: ``pos`` (B,)
int32; ``k``/``v`` (n_layers, B, max_len, Hkv, Dh) for attention stacks;
``ssm`` {``h`` (n_layers, B, H, P, N) fp32, ``conv`` (n_layers, B, W-1,
d_inner+2N)} for SSM stacks, plus ``shared_k``/``shared_v`` (groups, B,
max_len, Hkv, Dh) for the hybrid. ``decode_step`` updates it in place.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import checkpoint as ckpt_mod

from ..device import as_tensor, resolve_device
from ..distributed.sharding import (context, full, local_ranges,
                                    write_block)
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (Embedding, Init, SwiGLU, cross_entropy_loss, embed,
                     rms_norm, swiglu, unembed)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs (orthogonal to the architecture)."""
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"          # none | full | dots
    attn_mode: str = "dense"     # dense | chunked | triangular
    attn_chunk: int = 1024
    cache_dtype: Any = torch.bfloat16
    scan_layers: bool = True     # accepted; the stack is always a loop
    # Zero-pad attention heads to TP divisibility under a mesh.
    pad_heads: bool = False

    def checkpoint(self, fn):
        """``fn`` rematerialised under this config's policy when grad is
        enabled (without grad there is nothing to save)."""
        if self.remat == "none":
            return fn
        if self.remat == "full":
            kw = {}
        elif self.remat == "dots":
            kw = {"context_fn": functools.partial(
                ckpt_mod.create_selective_checkpoint_contexts,
                [torch.ops.aten.mm.default])}
        else:
            raise ValueError(self.remat)

        @functools.wraps(fn)
        def wrapped(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return ckpt_mod.checkpoint(fn, *args, use_reentrant=False, **kw)
        return wrapped


DEFAULT_RUN = RunConfig()


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One attention layer: dense, audio, vlm (SwiGLU) or moe."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        self.attn = attn_mod.Attention(init, cfg)
        self.ln1 = init.ones(cfg.d_model)
        self.ln2 = init.ones(cfg.d_model)
        if cfg.has_moe:
            self.moe = moe_mod.MoE(init, cfg)
        else:
            self.mlp = SwiGLU(init, cfg.d_model, cfg.d_ff)


class SSMBlock(nn.Module):
    """One SSM layer (ssm and hybrid families)."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        self.ssm = ssm_mod.SSM(init, cfg)
        self.ln = init.ones(cfg.d_model)


class SharedBlock(nn.Module):
    """Zamba2's shared attention+FF block (one set of weights)."""

    def __init__(self, init: Init, cfg):
        super().__init__()
        self.attn = attn_mod.Attention(init, cfg)
        self.mlp = SwiGLU(init, cfg.d_model, cfg.d_ff)
        self.ln1 = init.ones(cfg.d_model)
        self.ln2 = init.ones(cfg.d_model)


class LM(nn.Module):
    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(init, cfg.vocab, cfg.d_model)
        block = SSMBlock if cfg.has_ssm else Block
        self.blocks = nn.ModuleList(block(init, cfg)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init.ones(cfg.d_model)
        if cfg.family == "hybrid":
            self.shared = SharedBlock(init, cfg)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(init, cfg.vocab, cfg.d_model)
        self._compute = None     # (dtype, tree): the cast copy prefill made

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def compute_params(self, dtype, refresh: bool = False):
        """This model's parameters in ``dtype`` for serving: the model
        itself for its own dtype, else a detached ``cast_params`` copy,
        kept until ``refresh`` or another dtype asks for a new one."""
        if dtype == self.final_norm.dtype:
            return self
        if refresh or self._compute is None or self._compute[0] != dtype:
            self._compute = None          # free the old copy first
            with torch.no_grad():
                self._compute = (dtype, cast_params(self, dtype))
        return self._compute[1]


def cast_params(module: nn.Module, dtype):
    """``module``'s parameters cast to ``dtype`` (the reference's
    ``_cast_params``) as a tree of namespaces with the module's attribute
    paths (``p.blocks[l].attn.wq``). The cast is differentiable when grad
    is enabled (gradients reach the fp32 masters), and a parameter already
    in ``dtype`` is the parameter itself."""
    out = types.SimpleNamespace(**{
        name: p.to(dtype) if p.is_floating_point() else p
        for name, p in module.named_parameters(recurse=False)})
    for name, child in module.named_children():
        setattr(out, name, [cast_params(c, dtype) for c in child]
                if isinstance(child, nn.ModuleList)
                else cast_params(child, dtype))
    return out


def init_lm(cfg, generator: torch.Generator = None, device=None) -> LM:
    """A model with fp32 master parameters drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        return LM(cfg, Init(dev, generator))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(cfg, bp, x, axes=None):
    """The block's FF half on its normed input → (out, aux)."""
    if cfg.has_moe:
        return moe_mod.moe_mlp(bp.moe, cfg, x, axes)
    return _swiglu(bp.mlp, x, axes), None


def _swiglu(mp, x, axes=None):
    return swiglu(x, mp.w_gate, mp.w_up, mp.w_down, axes)


def _attention(cfg, run, ap, x, positions, axes):
    return attn_mod.attention(ap, cfg, x, positions, run.attn_mode,
                              run.attn_chunk, axes, run.pad_heads)


def _dense_block(cfg, run, bp, x, positions, axes=None):
    h, kv = _attention(cfg, run, bp.attn, rms_norm(x, bp.ln1, cfg.norm_eps),
                       positions, axes)
    x = x + h
    h, aux = _ffn(cfg, bp, rms_norm(x, bp.ln2, cfg.norm_eps), axes)
    return x + h, aux, kv


def _shared_block(cfg, run, sp, x, positions, axes=None):
    h, kv = _attention(cfg, run, sp.attn, rms_norm(x, sp.ln1, cfg.norm_eps),
                       positions, axes)
    x = x + h
    return x + _swiglu(sp.mlp, rms_norm(x, sp.ln2, cfg.norm_eps), axes), kv


def _input(x, dev, axes, dtype=None):
    """An input (a batch entry, tokens) on ``dev``, placed over the
    data-parallel axes under a mesh."""
    x = as_tensor(x, dev, dtype)
    if axes is None:
        return x
    return axes.place(x, "dp", *([None] * (x.ndim - 1)))


def _embed_inputs(params, batch, run, axes=None):
    dev = params.final_norm.device
    if "embeddings" in batch:
        x = _input(batch["embeddings"], dev, axes, run.compute_dtype)
    else:
        x = embed(params.embed, _input(batch["tokens"], dev, axes).long(),
                  run.compute_dtype)
    if axes is not None:
        x = axes.constrain(x, "dp", None, None)
    return x


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _logits(params, cfg, x, axes=None):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    table = params.unembed if not cfg.tie_embeddings else params.embed
    return unembed(table, x, axes)


def _layers(cfg, run, params, x, positions, ssm_state=None, kv_out=None,
            axes=None):
    """The layer stack over a full sequence → (x, aux sum).

    ``ssm_state(l)`` gives layer l's serving state to continue (and
    takes the new one back); ``kv_out(i, k, v)`` receives attention
    layer (or hybrid group) i's K/V. Both are for ``prefill``. The bodies
    the reference rematerialises go through ``run.checkpoint``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def ssm_layer(l, x):
        bp = params.blocks[l]
        xin = rms_norm(x, bp.ln, cfg.norm_eps)
        if ssm_state is None:
            return x + ssm_mod.ssm_forward(bp.ssm, cfg, xin, axes=axes)
        h, st = ssm_mod.ssm_forward(bp.ssm, cfg, xin, ssm_state(l), axes)
        ssm_state(l, st)
        return x + h

    def group(g, x):
        x, kv = _shared_block(cfg, run, params.shared, x, positions, axes)
        if kv_out is not None:
            kv_out(g, *kv)
        for j in range(cfg.attn_every):
            x = ssm_layer(g * cfg.attn_every + j, x)
        return x

    def block(l, x):
        x, a, kv = _dense_block(cfg, run, params.blocks[l], x, positions,
                                axes)
        if kv_out is not None:
            kv_out(l, *kv)
        return x, a

    if cfg.family == "ssm":
        body = run.checkpoint(ssm_layer)
        for l in range(cfg.n_layers):
            x = body(l, x)
    elif cfg.family == "hybrid":
        body = run.checkpoint(group)
        for g in range(cfg.n_layers // cfg.attn_every):
            x = body(g, x)
    else:
        body = run.checkpoint(block)
        for l in range(cfg.n_layers):
            x, a = body(l, x)
            if a is not None:
                aux = aux + a
    return x, aux


def forward(cfg, params: LM, batch, run: RunConfig = DEFAULT_RUN,
            axes=None):
    """Full-sequence forward → (logits fp32 (B,S,V), aux_loss).

    Differentiable with respect to ``params`` when grad is enabled (the
    cast is part of the graph); without grad it refreshes the serving
    copy of the weights. Under a mesh the logits and aux are DTensors."""
    if torch.is_grad_enabled():
        p = cast_params(params, run.compute_dtype)
    else:
        p = params.compute_params(run.compute_dtype, refresh=True)
    x = _embed_inputs(p, batch, run, axes)
    b, s, _ = x.shape
    x, aux = _layers(cfg, run, p, x, _positions(b, s, x.device), axes=axes)
    if not cfg.has_ssm:
        aux = aux / cfg.n_layers
    return _logits(p, cfg, x, axes), aux


def loss_fn(cfg, params: LM, batch, run: RunConfig = DEFAULT_RUN,
            axes=None):
    logits, aux = forward(cfg, params, batch, run, axes)
    labels = _input(batch["labels"], logits.device, axes).long()
    mask = batch.get("mask")
    if mask is not None:
        mask = _input(mask, logits.device, axes)
    ce = cross_entropy_loss(logits, labels, mask)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, run: RunConfig = DEFAULT_RUN,
               device=None):
    """Empty serving cache sized for ``max_len`` context."""
    dev = resolve_device(device)
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)

    def zeros(n, shape, dtype):
        return torch.zeros((n, *shape), dtype=dtype, device=dev)

    if cfg.has_ssm:
        st = ssm_mod.init_ssm_state(cfg, batch, run.cache_dtype, dev)
        cache["ssm"] = {k: zeros(cfg.n_layers, a.shape, a.dtype)
                        for k, a in st.items()}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        cache["shared_k"] = zeros(groups, kv_shape, run.cache_dtype)
        cache["shared_v"] = zeros(groups, kv_shape, run.cache_dtype)
    elif not cfg.has_ssm:
        cache["k"] = zeros(cfg.n_layers, kv_shape, run.cache_dtype)
        cache["v"] = zeros(cfg.n_layers, kv_shape, run.cache_dtype)
    return cache


@torch.no_grad()
def prefill(cfg, params: LM, batch, max_len: int,
            run: RunConfig = DEFAULT_RUN, axes=None, cache=None):
    """Process a full prompt → (last-token logits (B,V), cache).

    Makes the compute-dtype copy of the weights that the decode steps
    after it reuse. ``cache`` is an empty cache of ``init_cache``'s
    layout to fill (under a mesh its entries may be DTensors, placed as
    ``launch.specs.cache_spec_tree`` says: each rank fills its block);
    None makes one that every rank holds whole."""
    with context(axes):
        p = params.compute_params(run.compute_dtype, refresh=True)
        x = _embed_inputs(p, batch, run, axes)
        b, s, _ = x.shape
        if cache is None:
            cache = init_cache(cfg, b, max_len, run, x.device)
        ssm_state = kv_out = None
        if cfg.has_ssm:
            def ssm_state(l, st=None):
                if st is None:
                    return {k: full(a[l]) for k, a in cache["ssm"].items()}
                for k, a in cache["ssm"].items():
                    write_block(a[l], full(st[k]))
        if cfg.family != "ssm":
            ks, vs = ((cache["shared_k"], cache["shared_v"])
                      if cfg.family == "hybrid" else (cache["k"], cache["v"]))

            def kv_out(i, k, v):
                _write_prefix(ks[i], k)
                _write_prefix(vs[i], v)
        x, _ = _layers(cfg, run, p, x, _positions(b, s, x.device), ssm_state,
                       kv_out, axes)
        cache["pos"].fill_(s)
        return full(_logits(p, cfg, x[:, -1:], axes))[:, 0], cache


def _write_prefix(dst, src):
    """``dst[:, :s] = src`` for a prompt's K/V ``src`` (B, s, Hkv, Dh),
    cast to the cache's dtype. A DTensor ``dst`` (whose ``src`` is a
    DTensor on its mesh) takes this rank's block: ``src`` is placed as
    ``dst`` is on every dim but the sequence, and the rank writes the
    part of ``[0, s)`` its sequence range holds."""
    s = src.shape[1]
    if not isinstance(dst, DTensor):
        dst[:, :s] = full(src)
        return
    pl = tuple(Replicate() if isinstance(q, Shard) and q.dim % dst.ndim == 1
               else q for q in dst.placements)
    part = src.redistribute(dst.device_mesh, pl).to_local()
    lo, hi = local_ranges(dst)[1]
    if min(hi, s) > lo:
        dst.to_local()[:, :min(hi, s) - lo] = part[:, lo:min(hi, s)]


@torch.no_grad()
def decode_step(cfg, params: LM, tokens, cache, run: RunConfig = DEFAULT_RUN,
                axes=None):
    """One decoding step. tokens: (B,) int → (logits (B,V), cache).

    The cache is updated in place (and returned): the new K/V are written
    at ``pos``, the SSM states replaced, ``pos`` advanced by one."""
    with context(axes):
        return _decode_step(cfg, params, tokens, cache, run, axes)


def _decode_step(cfg, params, tokens, cache, run, axes):
    p = params.compute_params(run.compute_dtype)
    pos = cache["pos"]
    tokens = _input(tokens, params.device, axes).long()
    x = embed(p.embed, tokens[:, None], run.compute_dtype)
    if axes is not None:
        x = axes.constrain(x, "dp", None, None)

    def ssm_at(x, l):
        bp = p.blocks[l]
        st = {k: a[l] for k, a in cache["ssm"].items()}
        h, st2 = ssm_mod.ssm_decode_step(bp.ssm, cfg,
                                         rms_norm(x, bp.ln, cfg.norm_eps),
                                         {k: full(a) for k, a in st.items()},
                                         axes)
        for k, a in st.items():
            write_block(a, full(st2[k]))
        return x + h

    def attn_at(x, ap, ln, l, ks, vs):
        return x + attn_mod.decode_attention(
            ap, cfg, rms_norm(x, ln, cfg.norm_eps), ks[l], vs[l], pos, axes)

    if cfg.family == "ssm":
        for l in range(cfg.n_layers):
            x = ssm_at(x, l)
    elif cfg.family == "hybrid":
        sp = p.shared
        for g in range(cfg.n_layers // cfg.attn_every):
            x = attn_at(x, sp.attn, sp.ln1, g, cache["shared_k"],
                        cache["shared_v"])
            x = x + _swiglu(sp.mlp, rms_norm(x, sp.ln2, cfg.norm_eps), axes)
            for j in range(cfg.attn_every):
                x = ssm_at(x, g * cfg.attn_every + j)
    else:
        for l, bp in enumerate(p.blocks):
            x = attn_at(x, bp.attn, bp.ln1, l, cache["k"], cache["v"])
            h, _ = _ffn(cfg, bp, rms_norm(x, bp.ln2, cfg.norm_eps), axes)
            x = x + h
    pos.add_(1)
    return full(_logits(p, cfg, x, axes))[:, 0], cache
