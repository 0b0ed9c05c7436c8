"""setup_s: process start to the first timed request, host clock: the
interpreter, torch and CUDA, the table made on the card, and the warm-up
of every shape the traffic uses (captures, and the kernels' build in a
fresh checkout)."""


def read(run):
    return run.setup_s
