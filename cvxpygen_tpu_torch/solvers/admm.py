"""OSQP-style ADMM settings and the Newton-Schulz KKT inverse, in torch.

Port of the JAX package's ``solvers/admm.py``: ``ADMMSettings`` keeps the
same fields and defaults (the tests assert it), and the Newton-Schulz
helpers compute the same batched SPD inverse with ``torch.matmul``.

Problem form:  min 0.5 x'Px + q'x  s.t.  l <= A x <= u  (rows 0..n_eq are
equalities, l==u).  Default settings mirror reference osqp.py:102-115
(rho=0.1, sigma=1e-6, alpha=1.6, eps 1e-3, max_iter 4000) with adaptive_rho
off.

Precision: every matmul of a solve runs in full float32 (or float64), never
TF32; ``full_f32_matmul`` switches TF32 off for the duration of a solve and
restores the caller's setting.  The reference's bf16 bulk phase of the cold
Newton-Schulz start is specific to its TPU build; the port runs the full-
precision branch on every device.

``admm_solve`` is the per-instance batched solve (every instance has its own
P and A).  Three engines run it:

- kernel K2 (ops/admm_full_kernel.py), the whole solve, with
  ``use_pallas='full'``: the CUDA kernel on the card, its plain torch
  version on the CPU or with ``'full_interpret'``;
- the torch loop with kernel K3 (ops/admm_kernel.py) for each check
  interval's iterations, where ``use_iterate_kernel`` says so: with 'auto'
  on the card in float32 at KKT mode 'ns' when the reference's block rule
  (``pick_block``) gives the whole batch a block, as the JAX package
  takes its fused kernel on a TPU; with 'always' at KKT mode 'ns' or
  'inv' (K3's plain version on the CPU).  K3 applies M^-1 without the
  refinement sweep, as the reference's kernel does;
- the torch loop alone, which applies M^-1 with ``kkt_refine`` sweeps,
  otherwise.

The kernels are float32 code: float64 on the card takes the loop under
'auto', and 'always' or 'full' raise at entry.  On CUDA, a shape a forced
kernel cannot take raises; nothing drops to the loop.

The loop's data-dependent control flow (its end, the adaptive-rho
refactorization, the Newton-Schulz rescue) goes through a ``flow``:
``EAGER`` (Python, one host read per decision) or ``TRACED`` (``torch.cond``
and ``while_loop``, which ``torch.export`` carries: runtime/aot.py); both
run the same loop body.  With a batch ``group`` every batch-wide decision
is reduced over the group's ranks (parallel/mesh.py); with a model
``shard`` P, A and M^-1 are row blocks and every product with them is
exchanged over the model group (``make_sharded_qp_solve``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from ..ops.build import require_kernel_dtype
from .collectives import NO_SHARD, group_all, group_any, group_sum

_INF = 1e30  # parity: reference replace_inf (utils.py:213-228)


@dataclass(frozen=True)
class ADMMSettings:
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 4000
    check_interval: int = 25
    scaling: int = 10
    warm_starting: bool = True
    # KKT application mode:
    #   'ns'   Newton-Schulz iterations for M^{-1}: pure batched matmuls;
    #   'inv'  Cholesky once + explicit inverse (good on CPU/float64);
    #   'chol' triangular solves every iteration (reference-like);
    #   'auto' 'ns' on CUDA, 'inv' on the CPU.
    kkt_solver: str = 'auto'
    kkt_refine: int = 1
    # cold Newton-Schulz sweeps from the diagonal start
    ns_iters: int = 16
    # hand-written kernel selection (the field keeps the reference's name).
    # Shared-KKT solve: 'auto'/'always'/'full' launch kernel K1 on CUDA
    # tensors (ops/admm_shared_kernel.py).  Per-instance solve: 'full'
    # launches kernel K2, 'auto' (CUDA, where the reference's block rule
    # gives one) and 'always' launch kernel K3 once per check interval.
    # 'full_interpret' runs the whole-solve kernel's plain torch version,
    # 'never' runs the torch loop.  The kernels take float32: in float64 on
    # CUDA 'auto' runs the loop, and a forced kernel raises.
    use_pallas: str = 'auto'
    # reference: full-precision tail of its mixed-precision cold start; the
    # port is full precision throughout, and kernel K2 keeps only its
    # branch (the certificate rescue runs when ns_iters > ns_f32_iters)
    ns_f32_iters: int = 5
    # adaptive rho (OSQP section 5.2): rescale by the normalized residual
    # ratio at each check; re-"factorization" is a warm Newton-Schulz
    # restart.  Off by default (reference comparison settings pin it off).
    adaptive_rho: bool = False
    adaptive_rho_tolerance: float = 5.0
    ns_adapt_iters: int = 8
    # stop adapting rho after this many iterations (0 = never stop)
    adaptive_rho_until: int = 0


@contextlib.contextmanager
def full_f32_matmul():
    """Full-precision float32 matmuls (no TF32) inside the block; the
    caller's setting is restored on exit (the reference runs its solves
    under ``jax.default_matmul_precision('highest')``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _inf_norm(v, axis=-1):
    return torch.amax(torch.abs(v), dim=axis)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _ns_diag_start(M, shard=NO_SHARD):
    """Diagonal-preconditioner NS start X0 = diag(M)^{-1} rescaled so
    eig(M X0) in (0, 1] -- monotone NS from any SPD M.  M is (B, n, n), or
    this rank's row block of it under a model ``shard``."""
    n = M.shape[-1]
    dg = shard.gather(torch.diagonal(M, offset=shard.bounds(n)[0], dim1=1,
                                     dim2=2), n)
    dg_inv = 1.0 / torch.clamp(dg, min=1e-12)
    ninf = shard.max(torch.amax(
        torch.sum(torch.abs(M * dg_inv[:, None, :]), dim=2), dim=1))
    scale = dg_inv / torch.clamp(ninf, min=1.0)[:, None]
    return shard.rows(_eye(n, M), n, dim=0)[None] * scale[:, None, :]


def ns_residual_err(M, X, shard=NO_SHARD):
    """Per-instance ||I - M X||_inf (entrywise): the NS convergence
    certificate.  NaN iterates compare as 'not < threshold', so err-based
    guards catch divergence AND overflow."""
    n = M.shape[-1]
    R = (shard.rows(_eye(n, M), n, dim=0)[None]
         - torch.matmul(M, shard.gather(X, n, dim=-2)))
    return shard.max(torch.amax(torch.abs(R), dim=(1, 2)))


def _ns_sweeps(M, X, iters, shard=NO_SHARD, flow=None):
    n = M.shape[-1]
    I2 = 2.0 * _eye(n, M)

    def sweep(X):
        return (torch.matmul(
            X, I2 - shard.matmul(M, shard.gather(X, n, dim=-2), n)),)

    return (flow or EAGER).repeat(iters, sweep, (X,))[0]


def _ns_rescue(M, X, iters, shard=NO_SHARD, flow=None):
    """Recompute, from the monotone diagonal start, every instance whose
    residual certificate ||I - MX|| is not below 0.05."""
    bad = ~(ns_residual_err(M, X, shard) < 0.05)

    def rescue(M, X, bad):
        Xr = _ns_sweeps(M, _ns_diag_start(M, shard), iters, shard, flow)
        return torch.where(bad[:, None, None], Xr, X)

    return (flow or EAGER).branch(bad.any(), rescue, lambda M, X, bad: X,
                                  (M, X, bad))


def newton_schulz_inverse(M, iters, shard=NO_SHARD, flow=None):
    """Batched SPD inverse by Newton-Schulz, X <- X(2I - MX), from the
    diagonal preconditioner start: the reference's full-precision branch
    (its bf16 bulk phase, and with it ``ns_f32_iters``, exists only on its
    TPU build).  Under a model ``shard`` M and X are this rank's row
    blocks, and each sweep gathers X and M X over the model group."""
    return _ns_sweeps(M, _ns_diag_start(M, shard), iters, shard, flow)


def newton_schulz_warm(M, X0, iters, shard=NO_SHARD, flow=None):
    """Newton-Schulz restarted from a previous inverse (adaptive-rho
    refactorization).  X0 is rescaled by ||M X0||_inf >= lambda_max so
    eig(M X0) lies in (0, 1] -- monotone convergence from any SPD warm
    start -- and the certificate rescue guards a contaminated X0."""
    n = M.shape[-1]
    ninf = shard.max(torch.amax(torch.sum(torch.abs(
        torch.matmul(M, shard.gather(X0, n, dim=-2))), dim=2), dim=1))
    X0 = X0 / torch.clamp(ninf, min=1.0)[:, None, None]
    X = _ns_sweeps(M, X0, iters, shard, flow)
    return _ns_rescue(M, X, max(iters, 30), shard, flow)


def ruiz_equilibrate(P, q, A, l, u, iters, shard=NO_SHARD):
    """Modified Ruiz scaling on [[P, A'],[A, 0]] + cost scaling c (OSQP
    paper alg. 2), batched over the leading axis.  Returns
    (P, q, A, l, u, c, D, E) scaled; under a model ``shard`` P and A are
    this rank's row blocks and the column norms are reduced over the model
    group."""
    B, n = q.shape
    m = l.shape[1]
    dtype, dev = P.dtype, P.device
    c = torch.ones((B,), dtype=dtype, device=dev)
    D = torch.ones((B, n), dtype=dtype, device=dev)
    E = torch.ones((B, m), dtype=dtype, device=dev)

    def inv_sqrt(v):
        return torch.where(v > 1e-12,
                           1.0 / torch.sqrt(torch.clamp(v, min=1e-12)),
                           torch.ones_like(v))

    for _ in range(iters):
        nx_P = shard.max(torch.amax(torch.abs(P), dim=1))        # (B, n)
        nx_A = (shard.max(torch.amax(torch.abs(A), dim=1)) if m
                else torch.zeros_like(nx_P))
        nx = torch.maximum(nx_P, nx_A)
        nc = shard.gather(torch.amax(torch.abs(A), dim=2), m) if m else E
        dx = torch.clamp(inv_sqrt(nx), 1e-4, 1e4)
        dc = torch.clamp(inv_sqrt(nc), 1e-4, 1e4)
        P = shard.rows(dx, n)[:, :, None] * P * dx[:, None, :]
        A = shard.rows(dc, m)[:, :, None] * A * dx[:, None, :]
        q = dx * q
        D = D * dx
        E = E * dc
        # cost scaling (OSQP scaling.c: each zero norm is replaced by 1
        # before the max, so q == 0 cannot inflate the cost)
        col = torch.mean(shard.max(torch.amax(torch.abs(P), dim=1)), dim=1)
        col = torch.where(col < 1e-12, torch.ones_like(col), col)
        qn = _inf_norm(q)
        qn = torch.where(qn < 1e-12, torch.ones_like(qn), qn)
        g = torch.clamp(1.0 / torch.maximum(col, qn), 1e-4, 1e4)
        P = P * g[:, None, None]
        q = q * g[:, None]
        c = c * g
    return P, q, A, E * l, E * u, c, D, E


_USE_PALLAS = ('auto', 'always', 'never', 'full', 'full_interpret')


def pick_block(B, m, n, dtype):
    """The JAX package's block for its fused iteration kernel
    (``_pick_block``, its solvers/admm.py:258-267): the largest of 32, 16,
    8 that divides B and whose scoped-memory estimate is within 14 MB, or
    None.  The port takes K3 under 'auto' only where this gives a block;
    K3's own layout is ``pick_iterate_block``'s."""
    esize = 4 if dtype == torch.float32 else 8
    for blk in (32, 16, 8):
        est = blk * (2 * (n * n + m * n) + 2 * m * n) * esize
        if B % blk == 0 and est <= 14 * 1024 * 1024:
            return blk
    return None


def admm_kkt_mode(st: ADMMSettings, dev):
    """The KKT mode the solve runs: ``st.kkt_solver``, with 'auto' 'ns' on
    the card and 'inv' elsewhere (the reference's rule, its
    solvers/admm.py:332-334, with the card in its TPU's place)."""
    if st.kkt_solver == 'auto':
        return 'ns' if dev.type == 'cuda' else 'inv'
    return st.kkt_solver


def use_full_kernel(st: ADMMSettings, dtype, dev):
    """Whether the whole solve runs in kernel K2 ('full') or its plain
    version ('full_interpret'); 'full' in another dtype than float32 on the
    card raises."""
    if st.use_pallas == 'full':
        require_kernel_dtype(dtype, dev, 'kernel K2 (the whole solve)',
                             "use_pallas='full'")
    return st.use_pallas in ('full', 'full_interpret')


def use_iterate_kernel(st: ADMMSettings, kkt_mode, B, m, n, dtype, dev):
    """Whether the per-instance loop runs kernel K3 for each check
    interval, by the JAX package's rule (its solvers/admm.py:446-455).
    'auto': KKT mode 'ns', the card, float32 (the kernel's only dtype) and
    a block from ``pick_block`` for B, the whole batch's size -- so a B=1
    solve, a B that is not a multiple of 8, or n and m above about 270 run
    the refined loop.  'always': KKT mode 'ns' or 'inv' on any device; in
    another dtype than float32 on the card it raises.  Other modes: no."""
    if st.use_pallas == 'auto':
        return (kkt_mode == 'ns' and dev.type == 'cuda'
                and dtype == torch.float32
                and pick_block(B, m, n, dtype) is not None)
    if st.use_pallas == 'always' and kkt_mode in ('ns', 'inv'):
        require_kernel_dtype(dtype, dev, 'kernel K3 (the fused iterations)',
                             "use_pallas='always'")
        return True
    return False


def _scale(P, q, A, l, u, n_eq, st, x0, y0, shard=NO_SHARD):
    """Ruiz-scaled problem data, base rho and scaled starting point."""
    B, n = q.shape
    m = l.shape[1]
    dtype, dev = P.dtype, P.device
    # clamp infinities (parity with generated C: +-1e30)
    l = torch.clamp(l, -_INF, _INF)
    u = torch.clamp(u, -_INF, _INF)
    Ps, qs, As, ls, us, c, D, E = ruiz_equilibrate(P, q, A, l, u, st.scaling,
                                                   shard)
    s = dict(Ps=Ps, qs=qs, As=As, ls=ls, us=us, c=c, D=D, E=E)
    # per-row rho: equalities get rho_eq_scale * rho (OSQP convention); a
    # per-instance scale factor carries adaptive rho
    is_eq = torch.arange(m, device=dev) < n_eq
    s['rho_base'] = torch.where(
        is_eq, torch.full((m,), st.rho * st.rho_eq_scale, dtype=dtype,
                          device=dev),
        torch.full((m,), st.rho, dtype=dtype, device=dev)
    ).expand(B, m).contiguous()
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(dtype)
        s['x_start'] = (1.0 / D) * x0
        s['z_start'] = E * shard.mv(A, x0, m)
    else:
        s['x_start'] = torch.zeros((B, n), dtype=dtype, device=dev)
        s['z_start'] = torch.zeros((B, m), dtype=dtype, device=dev)
    s['y_start'] = (c[:, None] * (1.0 / E)
                    * torch.as_tensor(y0, device=dev).to(dtype)
                    if y0 is not None
                    else torch.zeros((B, m), dtype=dtype, device=dev))
    return s


def _full_args(s):
    return (s['Ps'], s['qs'], s['As'], s['ls'], s['us'], s['rho_base'],
            s['D'], s['E'], 1.0 / s['c'], s['x_start'], s['z_start'],
            s['y_start'])


def full_kernel_kwargs(st: ADMMSettings):
    """Keyword arguments of kernel K2 for these settings."""
    return dict(sigma=st.sigma, alpha=st.alpha, eps_abs=st.eps_abs,
                eps_rel=st.eps_rel, check_interval=st.check_interval,
                max_iter=st.max_iter, ns_iters=st.ns_iters,
                ns_f32_iters=st.ns_f32_iters,
                ns_adapt_iters=st.ns_adapt_iters, adaptive=st.adaptive_rho,
                rho_tol=st.adaptive_rho_tolerance, kkt_refine=st.kkt_refine,
                adapt_until=st.adaptive_rho_until)


def full_kernel_args(P, q, A, l, u, n_eq, settings: ADMMSettings, x0=None,
                     y0=None):
    """The positional arguments that admm_solve hands to kernel K2
    (ops/admm_full_kernel.py) for this batch: the Ruiz-scaled data, the base
    rho, the scaling factors and the scaled start."""
    with full_f32_matmul():
        return _full_args(_scale(P, q, A, l, u, n_eq, settings, x0, y0))


def admm_solve(P, q, A, l, u, n_eq, settings: ADMMSettings, x0=None, y0=None,
               group=None, shard=NO_SHARD, flow=None):
    """Solve a batch of QPs, each with its own P (B, n, n) and A (B, m, n).

    Returns dict(x, y, z, obj, iters, pri_res, dua_res, solved, status)
    with y in the OSQP sign convention (Px + q + A'y = 0 at the optimum).

    ``group``: a process group over which the batch is sharded; the loop's
    end and the adaptive-rho refactorization are decided over its ranks,
    and kernel K2's block and the K3 route are taken from the whole batch
    (no collective when None).  ``shard``: a model-axis ``RowShard``; P and
    A are then this rank's row blocks (P (B, n_r, n), A (B, m_r, n)) and l,
    u whole.  ``flow``: ``EAGER`` (the default) or ``TRACED``."""
    with full_f32_matmul():
        return _admm_solve_impl(P, q, A, l, u, n_eq, settings, x0, y0,
                                group, shard, flow or EAGER)


class _EagerFlow:
    """Python control flow: each data-dependent decision is one host read
    (the loop's condition once per check interval)."""

    @staticmethod
    def branch(pred, true_fn, false_fn, operands):
        return true_fn(*operands) if bool(pred) else false_fn(*operands)

    @staticmethod
    def loop(cond, body, state):
        while bool(cond(*state)):
            state = body(*state)
        return state

    @staticmethod
    def repeat(n, step, carry):
        for _ in range(n):
            carry = step(*carry)
        return carry


class _TracedFlow:
    """The same decisions as graph operators (``torch.cond``, ``while_loop``)
    for ``torch.export``.  Neither operator lets an output alias an input,
    so an output that is one of the inputs is copied."""

    @staticmethod
    def branch(pred, true_fn, false_fn, operands):
        return torch.cond(pred, _unaliased(true_fn), _unaliased(false_fn),
                          tuple(operands))

    @staticmethod
    def loop(cond, body, state):
        from torch._higher_order_ops.while_loop import while_loop
        return while_loop(cond, _unaliased(body), tuple(state))

    @classmethod
    def repeat(cls, n, step, carry):
        """``n`` steps as one loop operator, so that the program records
        (and the tracer traces) the step once."""
        def counted(i, *c):
            return (i + 1,) + tuple(step(*c))
        i0 = torch.zeros((), dtype=torch.int32, device=carry[0].device)
        return cls.loop(lambda i, *c: i < n, counted, (i0,) + tuple(carry))[1:]


def _unaliased(fn):
    def run(*args):
        out = fn(*args)
        one = isinstance(out, torch.Tensor)
        outs = tuple(o.clone() if any(o is a for a in args) else o
                     for o in ((out,) if one else out))
        return outs[0] if one else outs
    return run


EAGER = _EagerFlow()
TRACED = _TracedFlow()


def iterate_interval(st: ADMMSettings, kkt_mode, k3_block, Minv, Ps, As, qs,
                     ls, us, rho_vec, x, z, y, shard=NO_SHARD, flow=EAGER):
    """One check interval's iterations of the per-instance solve, as its
    route runs them: kernel K3 where ``k3_block`` is set (the solve sets
    it where ``use_iterate_kernel`` says so), else the loop, which applies
    M^-1 (the Cholesky factor in 'chol') with ``st.kkt_refine`` sweeps.
    runtime/profiling.py times this function."""
    if k3_block is not None:
        return torch.ops.cvxpygen_tpu_torch.admm_iterate(
            Minv, As, qs, ls, us, rho_vec, x, z, y, st.sigma, st.alpha,
            st.check_interval, k3_block)
    n, m = qs.shape[1], ls.shape[1]

    def M_matvec(x):
        # M x without materializing M (used by iterative refinement)
        return (shard.mv(Ps, x, n) + st.sigma * x
                + shard.vm(rho_vec * shard.mv(As, x, m), As, m))

    def kkt_apply(rhs):
        if kkt_mode == 'chol':
            return torch.cholesky_solve(rhs[..., None], Minv)[..., 0]
        xt = shard.mv(Minv, rhs, n)
        for _ in range(st.kkt_refine):
            xt = xt + shard.mv(Minv, rhs - M_matvec(xt), n)
        return xt

    def step(xn, zn, yn):
        rhs = st.sigma * xn - qs + shard.vm(rho_vec * zn - yn, As, m)
        xt = kkt_apply(rhs)
        zt = shard.mv(As, xt, m)
        x1 = st.alpha * xt + (1 - st.alpha) * xn
        w = st.alpha * zt + (1 - st.alpha) * zn + yn / rho_vec
        zn = torch.minimum(torch.maximum(w, ls), us)
        return x1, zn, rho_vec * (w - zn)
    return flow.repeat(st.check_interval, step, (x, z, y))


def form_M(Ps, As, sigma, rho_vec, shard=NO_SHARD):
    """M = P + sigma I + A' diag(rho) A per instance (B, n, n); under a
    model ``shard`` this rank's row block of it."""
    n = Ps.shape[-1]
    m = rho_vec.shape[-1]
    AtRA = shard.sum(torch.matmul(
        As.transpose(1, 2), As * shard.rows(rho_vec, m)[:, :, None]))
    return ((Ps + sigma * shard.rows(_eye(n, Ps), n, dim=0))
            + shard.rows(AtRA, n, dim=1))


def _admm_solve_impl(P, q, A, l, u, n_eq, st: ADMMSettings, x0, y0,
                     group=None, shard=NO_SHARD, flow=EAGER):
    B, n = q.shape
    m = l.shape[1]
    dtype, dev = P.dtype, P.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if m == 0:
        Lc = torch.linalg.cholesky(P + st.sigma * _eye(n, P))
        x = torch.cholesky_solve(-q[..., None], Lc)[..., 0]
        obj = (0.5 * torch.einsum('bi,bij,bj->b', x, P, x)
               + torch.sum(q * x, dim=1))
        ones_i = torch.ones((B,), dtype=torch.int32, device=dev)
        return dict(x=x, y=zeros(B, 0), z=zeros(B, 0), obj=obj, iters=ones_i,
                    pri_res=zeros(B), dua_res=zeros(B),
                    solved=torch.ones((B,), dtype=torch.bool, device=dev),
                    status=ones_i)

    if st.kkt_solver not in ('auto', 'ns', 'inv', 'chol'):
        raise ValueError(
            f"ADMMSettings.kkt_solver={st.kkt_solver!r}: expected one of "
            "'auto', 'ns', 'inv', 'chol'")
    if st.use_pallas not in _USE_PALLAS:
        raise ValueError(
            f"ADMMSettings.use_pallas={st.use_pallas!r}: expected one of "
            + ', '.join(repr(v) for v in _USE_PALLAS))
    kkt_mode = admm_kkt_mode(st, dev)
    adaptive = st.adaptive_rho and kkt_mode != 'chol'
    if shard.group is not None and (kkt_mode == 'chol'
                                    or st.use_pallas != 'never'):
        raise ValueError("a model-sharded solve takes use_pallas='never' and "
                         f"kkt_solver 'ns' or 'inv', not {st.use_pallas!r} "
                         f'and {kkt_mode!r}')
    if flow is TRACED and st.use_pallas in ('full', 'full_interpret'):
        raise ValueError(f'use_pallas={st.use_pallas!r}: the whole-solve '
                         'kernel K2 cannot be exported; export the K3 route '
                         "('auto' or 'always') or the loop ('never')")
    use_k2 = use_full_kernel(st, dtype, dev)
    # the whole batch's size: K2's block and the K3 route are part of the
    # answer, so a rank takes them from the whole batch, as one process does
    # (under 'auto' only where K3 can run: the card in float32)
    B_all = B
    if group is not None and (use_k2 or (
            st.use_pallas == 'auto' and dev.type == 'cuda'
            and dtype == torch.float32)):
        B_all = int(group_sum(torch.tensor(B, device=dev), group))
    # the fused iteration kernel K3 applies M^-1 without refinement
    k3_block = None
    if use_iterate_kernel(st, kkt_mode, B_all, m, n, dtype, dev):
        from ..ops.admm_kernel import pick_iterate_block
        k3_block = pick_iterate_block(B, m, n)
        if k3_block is None:
            raise ValueError(f'fused iteration kernel: n={n}, m={m} does not '
                             'fit shared memory')

    s = _scale(P, q, A, l, u, n_eq, st, x0, y0, shard)
    Ps, qs, As, ls, us = s['Ps'], s['qs'], s['As'], s['ls'], s['us']
    c, D, E = s['c'], s['D'], s['E']
    c_inv, D_inv, E_inv = 1.0 / c, 1.0 / D, 1.0 / E
    rho_base = s['rho_base']

    def finish(x, z, y, obj, it_vec, status, rp, rd):
        obj = torch.where(status == -3, torch.full_like(obj, float('inf')),
                          obj)
        obj = torch.where(status == -4, torch.full_like(obj, -float('inf')),
                          obj)
        return dict(x=D * x, y=c_inv[:, None] * E * y, z=E_inv * z, obj=obj,
                    iters=it_vec, pri_res=rp, dua_res=rd,
                    solved=(status == 1), status=status)

    if use_k2:
        # the whole solve in kernel K2 (ops/admm_full_kernel.py)
        from ..ops.admm_full_kernel import (admm_solve_full,
                                            admm_solve_full_plain,
                                            pick_full_block)
        solve = (admm_solve_full_plain if st.use_pallas == 'full_interpret'
                 else admm_solve_full)
        block = None
        if group is not None:
            # the block is part of the answer (the rescue and the
            # refactorization act on whole blocks)
            block = pick_full_block(B_all, m, n, dtype)
            if block is None or B % block:
                raise ValueError(
                    f'full-solve kernel: the block of the whole batch '
                    f'({B_all} instances) is {block} instances, and this '
                    f'rank holds {B}: each rank must hold whole blocks')
        return finish(*solve(*_full_args(s), **full_kernel_kwargs(st),
                             block=block))

    def factor(rho_vec, Minv_warm=None):
        M = form_M(Ps, As, st.sigma, rho_vec, shard)
        if kkt_mode == 'ns':
            if Minv_warm is None:
                return newton_schulz_inverse(M, st.ns_iters, shard, flow)
            return newton_schulz_warm(M, Minv_warm, st.ns_adapt_iters, shard,
                                      flow)
        Lc = torch.linalg.cholesky(shard.gather(M, n, dim=-2))
        if kkt_mode == 'chol':
            return Lc  # keep the factor; triangular solves every iteration
        return shard.rows(torch.cholesky_solve(_eye(n, M).expand(B, n, n),
                                               Lc), n, dim=-2)

    u_open = us >= _INF * 0.5
    l_open = ls <= -_INF * 0.5
    u_fin = torch.where(u_open, torch.zeros_like(us), us * E_inv)
    l_fin = torch.where(l_open, torch.zeros_like(ls), ls * E_inv)

    def residuals(z, Ax, Px, Aty):
        rp = _inf_norm(E_inv * (Ax - z))
        rp_den = torch.maximum(_inf_norm(E_inv * Ax), _inf_norm(E_inv * z))
        rd = c_inv * _inf_norm(D_inv * (Px + qs + Aty))
        rd_den = c_inv * torch.maximum(
            torch.maximum(_inf_norm(D_inv * Px), _inf_norm(D_inv * Aty)),
            _inf_norm(D_inv * qs))
        ok = ((rp <= st.eps_abs + st.eps_rel * rp_den)
              & (rd <= st.eps_abs + st.eps_rel * rd_den))
        return rp, rd, rp_den, rd_den, ok

    def infeasibility(dx, dy, Pdx, Adx, Atdy):
        """OSQP section 3.4 certificates per instance (scaled space with the
        unscaling factors applied).  Returns (prim_inf, dual_inf)."""
        eps = 1e-4
        Edy = E * dy
        dy_n = _inf_norm(Edy) * c_inv
        cert_p1 = _inf_norm(D_inv * Atdy) * c_inv <= eps * dy_n
        sup = torch.sum(u_fin * torch.clamp(Edy, min=0.0)
                        + l_fin * torch.clamp(Edy, max=0.0), dim=1) * c_inv
        open_dir = (torch.any((dy > 1e-12) & u_open, dim=1)
                    | torch.any((dy < -1e-12) & l_open, dim=1))
        prim_inf = (dy_n > 1e-10) & cert_p1 & (sup <= -eps * dy_n) & ~open_dir
        dx_n = _inf_norm(D * dx)
        cert_d1 = _inf_norm(D_inv * Pdx) * c_inv <= eps * dx_n
        cert_d2 = torch.sum(qs * dx, dim=1) * c_inv <= -eps * dx_n
        up_ok = u_open | (E_inv * Adx <= eps * dx_n[:, None])
        lo_ok = l_open | (E_inv * Adx >= -eps * dx_n[:, None])
        dual_inf = ((dx_n > 1e-10) & cert_d1 & cert_d2
                    & torch.all(up_ok & lo_ok, dim=1))
        return prim_inf, dual_inf

    def refactor(Minv, rho_scale):
        return factor(rho_base * rho_scale[:, None], Minv_warm=Minv)

    def body(x, z, y, Minv, rho_scale, it, done, it_vec, status, rp, rd):
        """One check interval: its iterations, then the residuals, the
        certificates and adaptive rho."""
        rho_vec = rho_base * rho_scale[:, None]
        xn, zn, yn = iterate_interval(st, kkt_mode, k3_block, Minv, Ps, As,
                                      qs, ls, us, rho_vec, x, z, y, shard,
                                      flow)
        # freeze converged instances: batch result == single-instance result
        mask = done[:, None]
        dx = torch.where(mask, torch.zeros_like(x), xn - x)
        dy = torch.where(mask, torch.zeros_like(y), yn - y)
        x = torch.where(mask, x, xn)
        z = torch.where(mask, z, zn)
        y = torch.where(mask, y, yn)
        it = it + st.check_interval
        # fused check products: one pass over A/P for the residuals (x, y)
        # and the certificates (dx, dy)
        xs = torch.stack([x, dx], dim=1)                 # (B, 2, n)
        ys = torch.stack([y, dy], dim=1)                 # (B, 2, m)
        Axs = shard.gather(torch.matmul(xs, As.transpose(1, 2)), m)
        Pxs = shard.gather(torch.matmul(xs, Ps.transpose(1, 2)), n)
        Atys = shard.sum(torch.matmul(shard.rows(ys, m), As))
        rp, rd, rp_den, rd_den, ok = residuals(z, Axs[:, 0], Pxs[:, 0],
                                               Atys[:, 0])
        p_inf, d_inf = infeasibility(dx, dy, Pxs[:, 1], Axs[:, 1],
                                     Atys[:, 1])
        it_vec = torch.where(ok & ~done, it, it_vec)
        status = torch.where(ok & (status == 0), 1, status)
        status = torch.where(p_inf & (status == 0), -3, status)
        status = torch.where(d_inf & (status == 0), -4, status)
        done = done | ok | p_inf | d_inf

        if adaptive:
            # OSQP adaptive rho per instance; any change (on any rank of
            # the batch group) refactors the whole batch (a warm
            # Newton-Schulz restart in 'ns' mode)
            ratio = torch.sqrt(
                (rp / torch.clamp(rp_den, min=1e-10))
                / torch.clamp(rd / torch.clamp(rd_den, min=1e-10), min=1e-10))
            tol = st.adaptive_rho_tolerance
            change = ((ratio > tol) | (ratio < 1.0 / tol)) & ~done
            step_f = torch.clamp(
                torch.where(change, ratio, torch.ones_like(ratio)), 0.1, 10.0)
            rho_scale = torch.clamp(rho_scale * step_f, 1e-6, 1e6)
            Minv = flow.branch(group_any(change, group), refactor,
                               lambda Minv, rho_scale: Minv,
                               (Minv, rho_scale))
        return x, z, y, Minv, rho_scale, it, done, it_vec, status, rp, rd

    def cond(x, z, y, Minv, rho_scale, it, done, *rest):
        return ~group_all(done, group) & (it < st.max_iter)

    rp0 = torch.full((B,), float('inf'), dtype=dtype, device=dev)
    izeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    state = (s['x_start'], s['z_start'], s['y_start'], factor(rho_base),
             torch.ones((B,), dtype=dtype, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((B,), dtype=torch.bool, device=dev), izeros,
             izeros.clone(), rp0, rp0.clone())
    x, z, y, _, _, it, done, it_vec, status, rp, rd = flow.loop(cond, body,
                                                                state)
    it_vec = torch.where(done, it_vec, it)
    obj = c_inv * (0.5 * shard.sum(torch.einsum(
        'bi,bij,bj->b', shard.rows(x, n), Ps, x)) + torch.sum(qs * x, dim=1))
    return finish(x, z, y, obj, it_vec, status, rp, rd)
