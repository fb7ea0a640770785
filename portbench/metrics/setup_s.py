"""setup_s: seconds from process start to the first timed request (CUDA
init, the kernels' builds or loads, the inputs, the warm-up request)."""


def read(run):
    return run["setup_s"]
