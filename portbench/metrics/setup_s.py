"""setup_s: process start to the first timed pass (imports, the CUDA context,
the rows made on the card, the kernels' build or cache hit, the warm pass)."""


def read(w):
    return w.setup_s
