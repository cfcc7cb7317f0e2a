"""The plain references: one module per family, named as the
configuration's ``family``, each providing ``solve(values, sizes, dtype,
tol)`` in plain PyTorch.  They import nothing of the package under test or
of JAX, and take nothing the package made: only the parameter values."""
