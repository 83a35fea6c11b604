"""qwen1.5-32b — dense decoder with QKV bias.

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064
[hf:Qwen/Qwen1.5-0.5B family].
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-32B",
))
