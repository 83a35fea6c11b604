"""qwen3-moe-30b-a3b — 128-expert top-8 MoE decoder.

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936
[hf:Qwen/Qwen3-30B-A3B].
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    n_experts=128,
    topk=8,
    source="hf:Qwen/Qwen3-30B-A3B",
))
