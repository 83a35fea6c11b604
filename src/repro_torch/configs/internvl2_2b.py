"""internvl2-2b — InternViT + InternLM2; we implement the LM backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821].
The InternViT vision frontend is a stub; input_specs() provides precomputed
patch embeddings (frontend="stub").
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    frontend="stub",
    source="arXiv:2404.16821",
))
