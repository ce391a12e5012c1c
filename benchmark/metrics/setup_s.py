"""Seconds from the process's start to the window's: imports, the card,
the program's kernels, the world, the seeded inputs and the warm-up."""


def read(run):
    return run['setup_s']
