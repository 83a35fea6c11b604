"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242]. One shared attention+FF block (shared weights) is
invoked every 6 SSM layers (9 invocations) — our simplification of Zamba2's
shared-block scheme (the real model adds per-invocation LoRA deltas;
recorded in DESIGN.md).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    source="arXiv:2411.15242",
))
