"""End to end: DP cells of the window's answered calls (queries x query
length x reference length, summed; yardstick) over the whole window, in
10^9 cells a second."""
UNIT = "Gcell/s"


def read(run):
    if not run.calls:
        return None
    return run.cells / run.window_s / 1e9
