"""Seconds from the process's start to the window's opening: imports, the
weights drawn from the seed, the kernels built or loaded, the warm-up of
the cell's shapes and, in a served cell, the engine filled to its steady
state."""


def read(rec):
    return rec.setup_s
