"""setup_s: seconds from the process's start to the window's first timed
unit: imports, the card's context, loading (on a checkout's first run,
building) the kernels, the ICs and the warm-up."""


def read(run):
    return run.setup_s
