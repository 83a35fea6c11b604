"""phi3-medium-14b — dense RoPE/SwiGLU/GQA decoder.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352 [arXiv:2404.14219].
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    head_dim=128,
    tie_embeddings=False,
    source="arXiv:2404.14219",
))
