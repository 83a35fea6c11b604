"""granite-moe-1b-a400m — 32-expert top-8 MoE decoder.

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=32,
    topk=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
