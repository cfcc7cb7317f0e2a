"""Plain reference of the MPC family (cvxgrp/cvxpygen tests/test_E2E_QP.py:
43-73), written again from its parameters:

    minimize   ||Psqrt X[:, H-1]||^2 + sum_{t<H} ||Qsqrt X[:, t]||^2
               + sum_t ||Rsqrt U[:, t]||^2 + 1
    subject to X[:, t+1] = A X[:, t] + B U[:, t],  |U| <= 1,  X[:, 0] = x_init

in the variables v = [vec X; vec U] (column-major), with no auxiliary
variables: the quadratic terms form P directly, the box is 2 H m rows of G.
"""
import torch

from .qp_ipm import solve_qp


def solve(values, sizes, dtype=torch.float64, tol=1e-8):
    """Solve the instances of ``values`` (parameter name -> (S, *shape)) in
    ``dtype``.  Returns the user's objective, each named variable and
    whether the solve converged, per instance."""
    vals = {k: v.to(dtype) for k, v in values.items()}
    qp, const = formulate(vals, sizes)
    sol = solve_qp(tol=tol, **qp)
    return {'obj': sol['obj'] + const, 'converged': sol['converged'],
            **named(sol['x'], sizes)}


def formulate(values, sizes):
    """values: parameter name -> tensor (S, *shape), float64.  Returns the QP
    (P, q, E, f, G, h) of qp_ipm.solve_qp and the objective's constant."""
    H, n, m = sizes['H'], sizes['n'], sizes['m']
    Psqrt, Qsqrt, Rsqrt = values['Psqrt'], values['Qsqrt'], values['Rsqrt']
    A, B, x_init = values['A'], values['B'], values['x_init']
    S = x_init.shape[0]
    dt, dev = x_init.dtype, x_init.device
    nx, nu = n * (H + 1), m * H
    N = nx + nu

    def xs(t):
        return slice(n * t, n * (t + 1))

    def us(t):
        return slice(nx + m * t, nx + m * (t + 1))

    P = torch.zeros((S, N, N), dtype=dt, device=dev)
    QQ = 2 * Qsqrt.transpose(1, 2) @ Qsqrt
    RR = 2 * Rsqrt.transpose(1, 2) @ Rsqrt
    for t in range(H):
        P[:, xs(t), xs(t)] += QQ
        P[:, us(t), us(t)] += RR
    P[:, xs(H - 1), xs(H - 1)] += 2 * Psqrt.transpose(1, 2) @ Psqrt
    q = torch.zeros((S, N), dtype=dt, device=dev)

    E = torch.zeros((S, n * (H + 1), N), dtype=dt, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev).expand(S, n, n)
    for t in range(H):
        rows = slice(n * t, n * (t + 1))
        E[:, rows, xs(t + 1)] = eye
        E[:, rows, xs(t)] = -A
        E[:, rows, us(t)] = -B
    E[:, n * H:, xs(0)] = eye
    f = torch.cat([torch.zeros((S, n * H), dtype=dt, device=dev), x_init], 1)

    G = torch.zeros((S, 2 * nu, N), dtype=dt, device=dev)
    iu = torch.arange(nu, device=dev)
    G[:, iu, nx + iu] = 1.0
    G[:, nu + iu, nx + iu] = -1.0
    h = torch.ones((S, 2 * nu), dtype=dt, device=dev)
    return dict(P=P, q=q, E=E, f=f, G=G, h=h), 1.0


def named(x, sizes):
    """The named variables at the reference's solution x (S, N), each a
    column-major flat tensor (S, size) as the problem declares it."""
    H, n, m = sizes['H'], sizes['n'], sizes['m']
    nx = n * (H + 1)
    return {'X': x[:, :nx], 'U': x[:, nx:nx + m * H]}

