"""setup_s: seconds from the process's start to the first timed iteration
(imports, the kernels' build or load, interning, the load and its converge,
one warm iteration)."""


def read(run):
    return run.setup_s
