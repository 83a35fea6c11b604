"""Paths, engine and tuning: sDTW kernel launches a call, from the
program's counter ``repro_torch.kernels.sdtw.ops.LAUNCHES``, summed over
the window."""
UNIT = "launches"


def read(run):
    if not run.calls or not run.launches:
        return None
    return run.launches / run.calls
