"""PyTorch/CUDA port of the MATSA sDTW system (``repro``), for NVIDIA
Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``repro_torch.core`` ↔ ``repro.core``, ``repro_torch.kernels.sdtw``
↔ ``repro.kernels.sdtw``) and imports neither JAX nor ``repro``. Public
entry points run on the CUDA device unless called with ``device="cpu"``.
"""
from .core import MatsaResult, align, matsa, sdtw, stream
from .search import search_topk

__all__ = ["MatsaResult", "align", "matsa", "sdtw", "search_topk", "stream"]
