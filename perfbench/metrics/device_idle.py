"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card, in %."""
UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    lo, hi = tr.window
    return 100 * (1 - tr.busy() / (hi - lo))
