"""cublas_gemm_ms: device time per traced call in the library's matrix
products (cuBLAS GEMM and GEMV kernels, by name): on the per-instance route
the Ruiz scaling, forming M, the Newton-Schulz factor and the
canonicalization's one product.  The package's own kernels, which sit in
an anonymous namespace, are left out."""
import re

PATTERN = re.compile(r'gemm|gemv|xmma|cutlass', re.IGNORECASE)
OWN = re.compile(r'^(void )?\(anonymous namespace\)::')


def read(rec):
    tr = rec.trace
    if tr is None or not tr.calls:
        return None
    t = [d for name, _, d, _ in tr.kernels()
         if PATTERN.search(name) and not OWN.match(name)]
    return 1e3 * sum(t) / tr.calls if t else None
