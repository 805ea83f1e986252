"""From process start to the first timed step: imports, the kernels' build
or load, the inputs from the seed, the warm-up."""


def read(run):
    return run.setup_s
