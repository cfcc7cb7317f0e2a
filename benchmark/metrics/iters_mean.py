"""iters_mean: the mean of the solver's reported iterations (``iters``) over
every instance of the traced calls: a count from the program."""


def read(rec):
    n = rec.counters['instances']
    return rec.counters['iters_sum'] / n if n else None
