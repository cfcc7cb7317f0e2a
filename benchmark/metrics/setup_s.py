"""setup_s: from the start of the process to the end of the warm-up call:
imports, CUDA initialization, building and canonicalizing the problem,
constructing the solver, loading (or, in a fresh checkout, building) the
kernels, making the pool of batches, and one call at the cell's shapes."""


def read(rec):
    return rec.setup_s
