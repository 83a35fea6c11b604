"""The sDTW kernels: three hand-written Hopper kernels
(``csrc/sdtw_rows.cu``, ``csrc/sdtw_chain.cu`` and ``csrc/sdtw.cu``), their
plain PyTorch version and the wrapper that dispatches between them."""
from .ops import (CHAIN_MAX_N, KERNELS, LAUNCHES, ROWS_MAX_N,
                  carry_from_numpy, carry_to_numpy, choose_kernel,
                  kernel_carry_init, launch_config, reset_launches,
                  resolve_blocks, resolve_chain, resolve_rows, sdtw_cuda,
                  tuned_launch)
from .sdtw import sdtw_kernel_plain

__all__ = ["CHAIN_MAX_N", "KERNELS", "LAUNCHES", "ROWS_MAX_N",
           "carry_from_numpy", "carry_to_numpy", "choose_kernel",
           "kernel_carry_init", "launch_config", "reset_launches",
           "resolve_blocks", "resolve_chain", "resolve_rows", "sdtw_cuda",
           "sdtw_kernel_plain", "tuned_launch"]
