"""setup_s (s): process start to the first timed batch: imports, CUDA
initialisation, the kernels' build on a checkout's first run (loading them
after), and the warm-up batch."""


def read(r):
    return r.setup_s
