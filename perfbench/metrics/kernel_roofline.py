"""Kernels: the least time the card could take for the window's DP cells
(``yardstick.bound_seconds``: the instructions a cell of this answer
needs at the int32 peak) over the summed time of every CUDA kernel the
traced window ran, whatever its name, in %."""
from perfbench import yardstick

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    lo, hi = tr.window
    busy = sum(min(e, hi) - max(s, lo) for s, e, _, _ in tr.kernels
               if e > lo and s < hi)
    if busy <= 0:
        return None
    return 100 * yardstick.bound_seconds(run.cells, run.answer) / (busy / 1e9)
