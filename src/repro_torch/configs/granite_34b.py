"""granite-34b — llama-arch code model with MQA (kv=1).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324].
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    source="arXiv:2405.04324",
))
