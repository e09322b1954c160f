"""Process start to the window's start (host clock): imports, the model's
build, the seeded weights, the kernels built or loaded, the warm-up of
the cell's shapes."""


def read(run):
    return run.setup_s
