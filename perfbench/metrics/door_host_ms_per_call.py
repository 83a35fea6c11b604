"""Front doors: the device's idle time inside the program's own span of
its front door (``repro_torch.matsa``, the whole of ``matsa``), summed
over the window and divided by its calls, in ms. The program's
counterpart of ``host_ms_per_call``, which reads the benchmark's span
around the call."""
from perfbench.metrics._spans import intervals

UNIT = "ms"


def read(run):
    spans = intervals(run, "repro_torch.matsa")
    if spans is None or not run.trace.calls:
        return None
    idle = sum((e - s) - run.trace.busy(s, e) for s, e in spans)
    return idle / len(run.trace.calls) / 1e6
