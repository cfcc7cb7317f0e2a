"""Reading a ``torch.profiler`` trace of the window's traced calls.

The profiler's Chrome trace is written to a temporary file, read once and
deleted.  ``TraceView`` holds what the per-layer readers need: the device's
operations (kernels, copies, fills) with their times, the traced calls'
host spans (``bench.call``).  Times are in seconds on the host's clock, as the profiler aligns
them.
"""
import json
import os
import tempfile

CALL_SPAN = 'bench.call'
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_HOST_CATS = ('cuda_runtime', 'cuda_driver', 'cpu_op', 'python_function')


def export_and_read(prof):
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


class TraceView:
    def __init__(self, chrome):
        ev = chrome.get('traceEvents', chrome) if isinstance(chrome, dict) \
            else chrome
        self.device_ops = []   # (name, start_s, dur_s, cat)
        self.host_ops = []     # (name, start_s, dur_s)
        calls = []
        for e in ev:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            t, d = float(e['ts']) * 1e-6, float(e.get('dur', 0)) * 1e-6
            if cat in _DEVICE_CATS:
                self.device_ops.append((e['name'], t, d, cat))
            elif cat == 'user_annotation' and e['name'] == CALL_SPAN:
                calls.append((t, t + d))
            elif cat in _HOST_CATS:
                self.host_ops.append((e['name'], t, d))
        self.calls = len(calls)
        self.window = ((min(c[0] for c in calls), max(c[1] for c in calls))
                       if calls else None)
        self.device_ops.sort(key=lambda o: o[1])

    @property
    def window_s(self):
        return self.window[1] - self.window[0] if self.window else 0.0

    def kernels(self):
        return [o for o in self.device_ops if o[3] == 'kernel']

    def busy_intervals(self):
        """The union of the device's operations, clipped to the window."""
        if not self.window:
            return []
        w0, w1 = self.window
        out = []
        for _, t, d, _ in self.device_ops:
            a, b = max(t, w0), min(t + d, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals())

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps summed by the host operation that was running at their start
        (the innermost one, by the latest start)."""
        by_name = {}
        for name, _, d, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = {}
        busy = self.busy_intervals()
        if busy:
            edges = ([(self.window[0], busy[0][0])]
                     + [(busy[i][1], busy[i + 1][0])
                        for i in range(len(busy) - 1)]
                     + [(busy[-1][1], self.window[1])])
            starts = [a for a, b in edges if b > a]
            labels = self._host_at(starts)
            for (a, b), name in zip([e for e in edges if e[1] > e[0]],
                                    labels):
                gaps[name] = gaps.get(name, 0.0) + (b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[k, v] for k, v in ops],
                'idle_gaps': [[k, v] for k, v in idle]}

    def _host_at(self, times):
        """For each of the ascending ``times``, the innermost host operation
        running then (the one that started last), in one sweep."""
        host = sorted(self.host_ops, key=lambda o: o[1])
        active, i, out = [], 0, []
        for t in times:
            while i < len(host) and host[i][1] <= t:
                active.append(host[i])
                i += 1
            active = [o for o in active if o[1] + o[2] >= t]
            out.append(active[-1][0] if active
                       else 'python (no traced host op)')
        return out
