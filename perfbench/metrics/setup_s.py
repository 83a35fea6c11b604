"""End to end: set-up, from the process's start to the window's: imports,
the card, the kernels' build or load, the data made from the seed and
the warm-up of the cell's shapes, in s."""
UNIT = "s"


def read(run):
    return run.setup_s
