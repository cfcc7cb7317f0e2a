"""Kernel K3's plain version (cvxpygen_tpu_torch/ops/admm_kernel.py) against
the JAX package's Pallas kernel ops/admm_kernel.py in interpret mode, and the
per-instance solve's K3 route against the JAX package's XLA loop.  float64
on the CPU, the same inputs made with numpy for both."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from test_full_kernel import _random_qp_batch
from test_pallas_kernels import _rand_problem
from cvxpygen_tpu.ops.admm_kernel import admm_iterate_pallas
from cvxpygen_tpu.solvers import admm as admm_ref
from cvxpygen_tpu_torch.ops import admm_kernel
from cvxpygen_tpu_torch.ops.admm_kernel import (admm_iterate,
                                                admm_iterate_plain,
                                                iterate_smem_bytes,
                                                pick_iterate_block,
                                                pick_iterate_ctas)
from cvxpygen_tpu_torch.solvers import admm


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test (several worker processes share the
    cores)."""
    with threadpool_limits(limits=1):
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize('n_iters', [1, 20])
def test_plain_matches_interpret_kernel(n_iters):
    args = _rand_problem(seed=n_iters)
    ref = admm_iterate_pallas(*args, sigma=1e-6, alpha=1.6, n_iters=n_iters,
                              block=4, interpret=True)
    out = admm_iterate_plain(*[_t(a) for a in args], sigma=1e-6, alpha=1.6,
                             n_iters=n_iters)
    for name, r, o in zip('xzy', ref, out):
        assert o.dtype == torch.float64
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10, err_msg=name)


def test_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    args = [_t(a) for a in _rand_problem(seed=5)]
    before = admm_iterate.launches
    out = admm_iterate(*args, sigma=1e-6, alpha=1.6, n_iters=3)
    ref = admm_iterate_plain(*args, sigma=1e-6, alpha=1.6, n_iters=3)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert admm_iterate.launches == before
    assert admm_kernel._LIB is None


def test_block_rule():
    assert pick_iterate_block(2048, 252, 222) == 1
    assert pick_iterate_block(8, 40000, 40000) is None


def test_layout_picker():
    """Thread blocks per instance in the resident layout: 2 at the MPC
    shape (n=222, m=252), 1 at the portfolio shape (n=130, m=172); shapes
    where a team of 8 cannot hold the rows take the streaming layout (0)
    while their vectors fit, and no layout where even those do not."""
    limit = 232448
    assert pick_iterate_ctas(252, 222) == 2
    assert iterate_smem_bytes(222, 252, 1) > limit
    assert iterate_smem_bytes(222, 252, 2) <= limit
    assert pick_iterate_ctas(172, 130) == 1
    assert pick_iterate_ctas(700, 600) == 0
    assert iterate_smem_bytes(600, 700, 8) > limit
    assert pick_iterate_block(64, 700, 600) == 1
    assert pick_iterate_ctas(40000, 40000) == 0
    assert pick_iterate_block(8, 40000, 40000) is None


def test_k3_route_matches_loop_without_refinement():
    """use_pallas='always' runs K3 (its plain version on the CPU) once per
    check interval; K3 applies M^-1 without refinement, so it is held
    against the XLA loop at kkt_refine=0."""
    (P, q, A, l, u), n_eq = _random_qp_batch(B=8)
    arrs = [np.asarray(v, np.float64) for v in (P, q, A, l, u)]
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000, check_interval=20,
              kkt_solver='ns', ns_iters=40, kkt_refine=0, adaptive_rho=True,
              adaptive_rho_tolerance=1.5)
    # the reference under jax.jit: called eagerly, JAX compiles each
    # operation of its Ruiz and Newton-Schulz loops one by one
    ref = jax.jit(admm_ref.admm_solve, static_argnums=(5, 6))(
        *(jnp.asarray(v) for v in arrs), n_eq,
        admm_ref.ADMMSettings(use_pallas='never', **kw))
    out = admm.admm_solve(*(torch.tensor(v) for v in arrs), n_eq,
                          admm.ADMMSettings(use_pallas='always', **kw))
    assert np.all(out['solved'].numpy())
    assert np.array_equal(np.asarray(ref['status']), out['status'].numpy())
    assert np.array_equal(np.asarray(ref['iters']), out['iters'].numpy())
    np.testing.assert_allclose(out['x'].numpy(), np.asarray(ref['x']),
                               rtol=0, atol=1e-8)
