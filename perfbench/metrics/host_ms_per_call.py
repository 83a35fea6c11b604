"""Front doors: the host's time in a call, in ms, averaged over the
window's calls: each call's span (the benchmark's own, around the front
door) less the time inside it in which the device was busy."""
UNIT = "ms"


def read(run):
    tr = run.trace
    if tr is None or not tr.calls or not tr.device:
        return None
    host = sum((e - s) - tr.busy(s, e) for s, e in tr.calls)
    return host / len(tr.calls) / 1e6
