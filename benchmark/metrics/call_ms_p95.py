"""call_ms_p95: the 95th percentile over every call of the window of one
``solve_batch`` call, from the call to its synchronized result, timed by
CUDA events on the card's clock (the stream is idle when each call starts,
so the span holds the call's host work too)."""
import statistics


def read(rec):
    if len(rec.call_s) < 2:
        return None
    return 1e3 * statistics.quantiles(rec.call_s, n=20)[18]
