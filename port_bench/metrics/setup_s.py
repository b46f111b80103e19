"""setup_s: seconds from the process's start to the window's: imports, the
weights made from the seed, the program built, kernels built or loaded,
every shape warmed up (host clock)."""


def read(run):
    return run.setup_s
