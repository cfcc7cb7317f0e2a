"""device_idle_pct: the share of the traced calls' wall time (first call's
start to last call's end, host clock as the profiler aligns it) in which no
operation (kernel, copy, fill) ran on the device, from the union of their
intervals in the trace."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
