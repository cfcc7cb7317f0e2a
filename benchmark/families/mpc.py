"""The MPC family of cvxpygen's tests (tests/test_E2E_QP.py:43-73 of
cvxgrp/cvxpygen), written in the port's modeling layer.

``build(sizes)`` returns the parametrized problem.  ``assign(sizes,
inputs)`` sets its parameters as the source's ``assign_MPC`` does, from the
inputs that the configuration fixes and the traffic mix draws (each a
tensor (pool, B or 1, *shape)); a dimension of 1 is shared by the rows of a
batch."""
import math

import torch

import cvxpygen_tpu_torch as ct


def build(sizes):
    H, n, m = sizes['H'], sizes['n'], sizes['m']
    U = ct.Variable((m, H), name='U')
    X = ct.Variable((n, H + 1), name='X')
    Psqrt = ct.Parameter((n, n), name='Psqrt', diag=True)
    Qsqrt = ct.Parameter((n, n), name='Qsqrt', diag=True)
    Rsqrt = ct.Parameter((m, m), name='Rsqrt', diag=True)
    nonzeros_A = ([(i, i) for i in range(n)]
                  + [(i, n // 2 + i) for i in range(n // 2)])
    A = ct.Parameter((n, n), name='A', sparsity=tuple(zip(*nonzeros_A)))
    nonzeros_B = [(n // 2 + i, i) for i in range(n // 2)]
    B = ct.Parameter((n, m), name='B', sparsity=tuple(zip(*nonzeros_B)))
    x_init = ct.Parameter(n, name='x_init')
    objective = ct.Minimize(
        ct.sum_squares(Psqrt @ X[:, H - 1]) + ct.sum_squares(Qsqrt @ X[:, :H])
        + ct.sum_squares(Rsqrt @ U) + 1)
    constraints = [X[:, 1:] == A @ X[:, :H] + B @ U,
                   ct.abs(U) <= 1,
                   X[:, 0] == x_init]
    return ct.Problem(objective, constraints)


def assign(sizes, inputs):
    """assign_MPC: A = I + td A_cont, B = td B_cont (positions driven by
    velocities, velocities by the inputs), weights I, I and sqrt(0.1) I."""
    n, m = sizes['n'], sizes['m']
    td, x_init = inputs['td'], inputs['x_init']
    kw = dict(dtype=td.dtype, device=td.device)
    eye = torch.eye(n, **kw)
    a_cont = torch.zeros((n, n), **kw)
    a_cont[:n // 2, n // 2:] = torch.eye(n // 2, **kw)
    b_cont = torch.zeros((n, m), **kw)
    b_cont[n // 2:] = torch.eye(m, **kw)
    td = td[..., None, None]
    return {'A': eye + td * a_cont, 'B': td * b_cont,
            'Psqrt': eye[None, None], 'Qsqrt': eye[None, None],
            'Rsqrt': math.sqrt(0.1) * torch.eye(m, **kw)[None, None],
            'x_init': x_init}
