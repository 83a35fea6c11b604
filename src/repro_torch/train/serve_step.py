"""Serving steps in PyTorch (the JAX package's ``train/serve_step.py``):
batched prefill and single-token decode, greedy or sampled.

Sampling draws from a ``torch.Generator``; it cannot reproduce
``jax.random.categorical``'s draws, so sampled tokens are not equal to
the JAX package's (greedy tokens are). Each takes ``axes`` (a mesh) as
the reference's do; the cache stays whole on every rank.
"""
from __future__ import annotations

import torch

from ..models import decode_step, prefill


def make_prefill_step(cfg, run, max_len: int, axes=None):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch, max_len, run, axes)
    return prefill_step


def make_serve_step(cfg, run, sample: bool = False,
                    temperature: float = 1.0, axes=None):
    def serve_step(params, tokens, cache, generator=None):
        logits, cache = decode_step(cfg, params, tokens, cache, run, axes)
        if sample:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        return next_tok.to(torch.int32), logits, cache
    return serve_step


def generate(cfg, params, prompt_tokens, n_steps: int, run,
             max_len: int = None, generator=None, sample: bool = False,
             axes=None):
    """Greedy/sampled generation loop → (B, n_steps) int32 tokens."""
    b, s = prompt_tokens.shape
    max_len = max_len or (s + n_steps)
    logits, cache = prefill(cfg, params, {"tokens": prompt_tokens}, max_len,
                            run, axes)
    serve = make_serve_step(cfg, run, sample, axes=axes)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(n_steps - 1):
        tok, _, cache = serve(params, tok, cache, generator)
        out.append(tok)
    return torch.stack(out, dim=1)
