"""setup_s: seconds from the start of the process to the start of the
measured window (imports, the card's context, weights drawn on the card,
the cell's warm-up, and in a fresh checkout the kernels' build)."""


def read(run):
    return run.setup_s
