"""cvxpygen_tpu_torch: the parametrized convex-solver framework in PyTorch,
with hand-written CUDA kernels for Hopper.

The port of ``cvxpygen_tpu`` (JAX/Pallas), which stays in the repository as
the reference it is held against.  Same layout and module names:

- modeling layer (expressions/atoms/constraints/problem) and canon/: the
  offline compilation of a DPP problem family into theta-affine maps
  (NumPy, kept as this package's own copy);
- runtime/ canonicalizes a parameter batch with one torch GEMM and solves
  it; solvers/ and ops/ hold the torch solvers and the CUDA kernels
  (csrc/), each kernel beside its plain torch version;
- cpg.generate_code provides the reference's public API
  (reference cvxpygen/cpg.py:17-30);
- autodiff/ holds the differentiable solves (QP, banded QP, conic) and
  ``TorchLayer``, a cvxpylayers-style layer over them;
- solvers/explicit.py holds the explicit (multi-parametric QP) solver:
  the offline region enumeration and the torch lookup-table evaluator;
- parallel/ shards a batch (and P/A by rows) over torch.distributed
  ranks; runtime/aot.py exports a solve with torch.export and
  runtime/profiling.py times its stages;
- native/ holds the embedded C++ core (cpg_core.cpp, the JAX package's
  core) and ``NativeQPSolver``, its ctypes runtime: a host float64 solver
  with an embedded gradient, never a route of the torch solvers;
  codegen/emit_c.py writes each generated package's ``c/``, a standalone
  C project over that core (``make && ./cpg_example``).

Entry points run on CUDA unless the caller passes ``device='cpu'``; with
no card and no explicit device they raise.
"""

from .expressions import Constant, Parameter, Variable
from .problem import Maximize, Minimize, Problem
from .constraints import ExpCone, PSD, PowCone3D, SOC
from .atoms import (
    abs, diff, entr, exp, geo_mean, huber, inv_pos, kl_div, lambda_max,
    lambda_min, log, log_det, log_sum_exp, logistic, maximum, minimum,
    multiply, neg,
    norm, norm1, norm2, norm_inf, pos, power, quad_form, quad_over_lin,
    rel_entr, reshape, sqrt, square, sum, sum_squares, trace, vec,
)
from .autodiff.torch_layer import TorchLayer

__all__ = [
    'Variable', 'Parameter', 'Constant', 'Problem', 'Minimize', 'Maximize',
    'SOC', 'ExpCone', 'PSD', 'PowCone3D', 'TorchLayer', 'abs', 'diff', 'entr', 'exp',
    'geo_mean',
    'huber', 'inv_pos', 'kl_div', 'lambda_max', 'lambda_min', 'log',
    'log_det', 'log_sum_exp',
    'logistic', 'maximum', 'minimum', 'multiply', 'neg', 'norm', 'norm1',
    'norm2', 'norm_inf', 'pos', 'power', 'quad_form', 'quad_over_lin',
    'rel_entr', 'reshape', 'sqrt', 'square', 'sum', 'sum_squares', 'trace',
    'vec',
]

__version__ = '0.1.0'
