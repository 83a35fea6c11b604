"""Shared neural-net layers in PyTorch (the JAX package's
``models/layers.py``).

Numerics policy, as in the reference: parameters are fp32 masters, compute
runs in the compute dtype (bf16 unless asked otherwise), and reductions
and norms run in fp32. Weights are stored ``(in, out)`` as the reference
stores them, so a layer is ``x @ w``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import (contiguous_strides, grad_placed_as,
                                    local_part, local_ranges, partial_over,
                                    replicated, unshard)


class Init:
    """Parameter factory for a model's constructor: seeded normal draws
    from ``generator`` on ``device``, or uninitialised storage in ``dtype``
    when ``generator`` is None (a model about to be loaded or cast into).

    Parameters are made frozen (``requires_grad`` False), so a model
    serves and evaluates without building a graph; a train state turns
    gradients on (``train.init_train_state``)."""

    def __init__(self, device, generator=None, dtype=torch.float32):
        self.device, self.generator, self.dtype = device, generator, dtype

    def _param(self, data) -> nn.Parameter:
        return nn.Parameter(data, requires_grad=False)

    def _empty(self, shape):
        return torch.empty(shape, device=self.device, dtype=self.dtype)

    def normal(self, shape, fan_in=None, scale=1.0) -> nn.Parameter:
        """``scale`` times ``normal_init``: N(0, 1/fan_in) draws."""
        if self.generator is None:
            return self._param(self._empty(shape))
        return self._param(scale * normal_init(
            shape, fan_in, self.generator, self.device, self.dtype))

    def const(self, values) -> nn.Parameter:
        """A parameter holding ``values`` (a tensor made on the CPU)."""
        if self.generator is None:
            return self._param(self._empty(tuple(values.shape)))
        return self._param(values.to(device=self.device, dtype=self.dtype))

    def ones(self, n: int) -> nn.Parameter:
        return self.const(torch.ones(n))

    def zeros(self, n: int) -> nn.Parameter:
        return self.const(torch.zeros(n))


def normal_init(shape, fan_in=None, generator=None, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """N(0, 1/fan_in) draws from an explicit ``torch.Generator``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / np.sqrt(max(1, fan_in))
    return scale * torch.randn(shape, generator=generator, device=device,
                               dtype=dtype)


def rms_norm(x, weight, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, axes=None):
    """SwiGLU FF. TP: gate/up column-parallel, down row-parallel."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    if axes is not None:
        h = axes.constrain(h, "dp", None, "tp")
    return h @ w_down


class SwiGLU(nn.Module):
    """``swiglu``'s weights (the model applies them to its cast copy)."""

    def __init__(self, init: Init, d_model: int, d_ff: int):
        super().__init__()
        self.w_gate = init.normal((d_model, d_ff), d_model)
        self.w_up = init.normal((d_model, d_ff), d_model)
        self.w_down = init.normal((d_ff, d_model), d_ff)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama-style, rotate-half).
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_frequencies_on(head_dim: int, theta: float, device: torch.device):
    """fp32 frequencies on ``device``, made once: no host copy (and so no
    stream sync) and no extra launches in a decode step."""
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) int32. fp32 inside."""
    freqs = _rope_frequencies_on(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., S, D/2)
    cos = replicated(torch.cos(angles)[..., None, :], x)    # (..., S, 1, D/2)
    sin = replicated(torch.sin(angles)[..., None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding.
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, init: Init, vocab: int, d_model: int):
        super().__init__()
        self.table = init.normal((vocab, d_model), fan_in=1, scale=0.02)


def embed(params, tokens, compute_dtype=torch.bfloat16):
    table = params.table.to(compute_dtype)
    if isinstance(table, DTensor):
        return _embed_sharded(table, tokens)
    return table[tokens]


def _embed_sharded(table, tokens):
    """The lookup on each rank's tokens from the whole table (gathered,
    as FSDP gathers a layer's weights): DTensor's rule for the lookup's
    backward on a sharded table fails on torch 2.11. The table's local
    gradient is this rank's share of the sum over the token shards."""
    dm = table.device_mesh
    whole = local_part(table.redistribute(dm, [Replicate()] * dm.ndim),
                       partial_over(tokens))
    out = whole[tokens.to_local()]
    shape = (*tokens.shape, table.shape[-1])
    return DTensor.from_local(out, dm, tokens.placements, run_check=False,
                              shape=shape, stride=contiguous_strides(shape))


def unembed(params, x, axes=None):
    """Logits in fp32 from the (compute-dtype-rounded) table (vocab-sharded
    over TP)."""
    table = params.table
    if axes is not None:
        # x whole over the model axis and the table's d_model split over
        # the data axes gathered (ZeRO-3): else DTensor gathers the batch
        # of x or the vocab of the table instead, and a rank computes the
        # logits of every token or of the whole vocab
        x = axes.constrain(x, "dp", None, None)
        table = axes.constrain(table, "tp", None)
    logits = x.float() @ table.float().T
    if axes is not None:
        logits = axes.constrain(logits, "dp", None, "tp")
    return logits


def cross_entropy_loss(logits, labels, mask=None):
    """Token-mean cross entropy; logits fp32 (B, S, V), labels (B, S).

    DTensor logits over several ranks stay as they are placed (a
    vocab-parallel cross entropy where the vocab is split): the
    log-partition and the gold logit are sums over the vocab that DTensor
    reduces across its shards, and the gold logit is picked by comparing
    each rank's vocab ids with the labels (DTensor has no rule for the
    label gather on a split dim, and the gather's backward makes zeros of
    the whole global logits on every rank)."""
    last = logits.ndim - 1      # (DTensor on torch 2.11 wants dims >= 0)
    if isinstance(logits, DTensor) and logits.device_mesh.size() > 1:
        m = logits.detach().amax(dim=last, keepdim=True)
        logz = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=last))
        gold = torch.where(labels[..., None].long() == _vocab_ids(logits),
                           logits, 0.0).sum(dim=last)
        # the loss's gradient reaches nll placed as nll is (else DTensor
        # meets a replicated gradient with the sharded logits by
        # gathering the logits' batch)
        nll = grad_placed_as(logz - gold)
    else:
        logits = unshard(logits, last)
        logz = torch.logsumexp(logits, dim=last)
        gold = torch.gather(logits, last, labels[..., None].long())[..., 0]
        nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _vocab_ids(logits):
    """The vocab ids (V,) as a DTensor split as the last dim of the
    DTensor ``logits`` is (each rank making its own part)."""
    last = logits.ndim - 1
    dm = logits.device_mesh
    lo, hi = local_ranges(logits)[last]
    pl = [Shard(0) if isinstance(p, Shard) and p.dim % logits.ndim == last
          else Replicate() for p in logits.placements]
    n = logits.shape[last]
    return DTensor.from_local(
        torch.arange(lo, hi, device=logits.device), dm, pl,
        run_check=False, shape=(n,), stride=(1,))
