"""The frozen yardstick: the work a call stands for and the card's peak.

Copied from the port's ``chip_smoke.py`` (from the kernels' SASS
counts) and frozen here, so that no change to the program can move it.

Int32 peak of one NVIDIA H100 SXM: 132 SMs x 64 int32 lanes an SM x the
1.98 GHz maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``) =
16.727e12 int32 instructions a second.

Int32 instructions a DP cell needs, counted in the SASS of the rows
kernel's steady-state loop (``cuobjdump -sass``):

  * ``distance``: an answer that is a distance alone (and where it ends,
    read from the last row once per column, not per cell): a subtract
    (IMAD.IADD), IABS, VIMNMX3 (the three-way min) and VIADDMNMX (add,
    then the saturating min): 4.
  * ``span``: an answer that carries where each match starts, so every
    cell carries its start: the subtract, IABS, two lexicographic mins
    of three compares (ISETP) and two predicated moves each, and
    VIADDMNMX: 13.

The fused instructions are taken at the int32 rate; a lower rate of
their own would raise the bound. The answer decides the count, not the
kernel that runs, so the bound reads the same work whatever computes it.
"""
from __future__ import annotations

SMS = 132
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
INT32_PEAK = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ   # 16.727e12 op/s

OPS_PER_CELL = {"distance": 4, "span": 13}


def bound_seconds(cells: float, answer: str) -> float:
    """The least time the card could take for ``cells`` DP cells of an
    ``answer`` of that kind, at the int32 peak."""
    return cells * OPS_PER_CELL[answer] / INT32_PEAK


def filter_cells(queries: int, query_size: int, ref_size: int) -> int:
    """DP cells of a query-filtering call: queries x N x M."""
    return queries * query_size * ref_size


def selfjoin_cells(windows: int, window: int, ref_size: int) -> int:
    """DP cells of a self-join call: windows x window x series length."""
    return windows * window * ref_size

