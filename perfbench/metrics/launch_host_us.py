"""Paths, engine and tuning: the host's time for one sDTW kernel call,
the mean length of the program's ``repro_torch.sdtw`` spans (the whole
of ``kernels.sdtw.ops.sdtw_cuda``: checks, allocations, the ban, the
tuner's pick and the launch) in the window, in us."""
from perfbench.metrics._spans import intervals

UNIT = "us"


def read(run):
    spans = intervals(run, "repro_torch.sdtw")
    if spans is None:
        return None
    return sum(e - s for s, e in spans) / len(spans) / 1e3
