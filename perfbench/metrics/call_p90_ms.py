"""End to end: the 90th percentile of the latency of every call completed
in the window, each timed from its issue until its answers are on the
host, in ms."""
import numpy as np

UNIT = "ms"


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(run.latencies, 90)) * 1e3
