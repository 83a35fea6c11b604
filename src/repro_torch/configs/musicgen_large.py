"""musicgen-large — decoder-only LM over EnCodec audio tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284].
Backbone only: the EnCodec frontend is a stub; input_specs() provides
precomputed frame embeddings (frontend="stub").
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    frontend="stub",
    tie_embeddings=False,
    source="arXiv:2306.05284",
))
