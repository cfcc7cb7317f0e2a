"""k3_ms: device time per traced call in kernel K3 (the per-instance check
interval, csrc/admm_iterate.cu), found by its kernels' names."""
import re

PATTERN = re.compile(r'^(void )?\(anonymous namespace\)::'
                     r'iterate_(resident|stream)_kernel(<[^>]*>)?\(')


def read(rec):
    tr = rec.trace
    if tr is None or not tr.calls:
        return None
    t = [d for name, _, d, _ in tr.kernels() if PATTERN.search(name)]
    return 1e3 * sum(t) / tr.calls if t else None
