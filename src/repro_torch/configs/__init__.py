"""Assigned architecture configs (one module per arch) + registry."""
from .base import SHAPES, ArchConfig, ShapeSpec, all_archs, cells, get_arch

from . import (mamba2_780m, phi3_medium_14b, llama3_2_1b, qwen1_5_32b,
               granite_34b, qwen3_moe_30b_a3b, granite_moe_1b_a400m,
               zamba2_2_7b, musicgen_large, internvl2_2b)

ALL_ARCHS = [
    mamba2_780m.CONFIG,
    phi3_medium_14b.CONFIG,
    llama3_2_1b.CONFIG,
    qwen1_5_32b.CONFIG,
    granite_34b.CONFIG,
    qwen3_moe_30b_a3b.CONFIG,
    granite_moe_1b_a400m.CONFIG,
    zamba2_2_7b.CONFIG,
    musicgen_large.CONFIG,
    internvl2_2b.CONFIG,
]

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_arch", "all_archs",
           "cells", "ALL_ARCHS"]
