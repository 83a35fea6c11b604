"""Front doors: the time the program spends moving its callers' arrays
onto the card (the spans ``repro_torch.stage`` of ``device.as_tensor``),
summed over the window and divided by its calls, in ms."""
from perfbench.metrics._spans import intervals

UNIT = "ms"


def read(run):
    spans = intervals(run, "repro_torch.stage")
    if spans is None or not run.trace.calls:
        return None
    return sum(e - s for s, e in spans) / len(run.trace.calls) / 1e6
