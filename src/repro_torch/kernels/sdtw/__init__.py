"""The sDTW kernel: a hand-written Hopper kernel (``csrc/sdtw.cu``), its
plain PyTorch version and the wrapper that dispatches between them."""
from .ops import (LAUNCHES, MAX_N, carry_from_numpy, carry_to_numpy,
                  kernel_carry_init, reset_launches, resolve_blocks,
                  sdtw_cuda)
from .sdtw import sdtw_kernel_plain

__all__ = ["LAUNCHES", "MAX_N", "carry_from_numpy", "carry_to_numpy",
           "kernel_carry_init", "reset_launches", "resolve_blocks",
           "sdtw_cuda", "sdtw_kernel_plain"]
