"""setup_s: seconds from the start of the process to the end of the warm
calls: imports, the CUDA context, the kernels' build where the checkout
has none, the inputs from the seed, one call on every pool entry."""


def read(run):
    return run.setup_s
