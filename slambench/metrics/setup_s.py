"""setup_s: process start to the start of the first timed frame: imports,
CUDA context, the room and frames rendered on the card, the vocabulary,
the system, the set-up frames (K1's build on a checkout's first run)."""


def read(run):
    return run.setup_s
