"""The port's batched static-pivot LDL^T (cvxpygen_tpu_torch/ops/
ldl_batched.py) and the plain versions of kernels K6, K7 and K8
(ops/ldl_kernel.py) against the JAX package: its XLA lowering and its
Pallas kernels in interpret mode, float64."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from cvxpygen_tpu.ops import ldl_batched as ldl_ref
from cvxpygen_tpu.ops.ldl_kernel import (ldl_factor_pallas,
                                         ldl_inverse_pallas,
                                         ldl_solve_pallas)
from cvxpygen_tpu_torch.ops import ldl_batched, ldl_kernel

TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _quasidefinite(B, N, nblk, rng):
    """tests/test_ldl.py's quasidefinite batch: PD primal block, ND dual
    block, random coupling."""
    P = rng.standard_normal((B, nblk, nblk))
    K = np.zeros((B, N, N))
    K[:, :nblk, :nblk] = P @ np.swapaxes(P, 1, 2) + 1e-3 * np.eye(nblk)
    Bb = rng.standard_normal((B, N - nblk, nblk))
    K[:, nblk:, :nblk] = Bb
    K[:, :nblk, nblk:] = np.swapaxes(Bb, 1, 2)
    H = rng.standard_normal((B, N - nblk, N - nblk))
    K[:, nblk:, nblk:] = -(H @ np.swapaxes(H, 1, 2)
                           + 1e-3 * np.eye(N - nblk))
    signs = np.concatenate([np.ones(nblk), -np.ones(N - nblk)])
    return K, signs


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize('N,nblk', [(23, 7), (37, 17)])
def test_ldl_batched_matches_jax(N, nblk):
    """ldl_factor / ldl_solve / ldl_inverse against the JAX package's
    XLA lowering (the (B, nbp, p, p) Linv layout)."""
    rng = np.random.default_rng(0)
    K, signs = _quasidefinite(4, N, nblk, rng)
    b = rng.standard_normal((4, N))

    @jax.jit
    def ref(K, b):
        fac = ldl_ref.ldl_factor(K, signs=signs)
        return fac, ldl_ref.ldl_solve(fac, b), ldl_ref.ldl_inverse(fac)

    fac_r, x_r, Kinv_r = ref(jnp.asarray(K), jnp.asarray(b))
    fac = ldl_batched.ldl_factor(torch.tensor(K), signs=signs)
    for key in ('L', 'd', 'Linv'):
        _close(fac[key], fac_r[key])
    assert (fac['panel'], fac['N'], fac['Np']) == (16, N, 16 * -(-N // 16))
    _close(ldl_batched.ldl_solve(fac, torch.tensor(b)), x_r)
    _close(ldl_batched.ldl_inverse(fac), Kinv_r)
    xe = np.linalg.solve(K, b[..., None])[..., 0]
    _close(ldl_batched.ldl_solve(fac, torch.tensor(b)), xe, 1e-8)


@pytest.mark.parametrize('N,nblk', [(21, 9), (41, 17)])
def test_kernel_plain_versions_match_pallas_interpret(N, nblk):
    """K6, K7 and K8's plain versions against ldl_factor_pallas,
    ldl_inverse_pallas and ldl_solve_pallas in interpret mode: B=5 (the
    Pallas wrappers pad the batch), quasidefinite signs, N padded to a
    multiple of the panel."""
    rng = np.random.default_rng(1)
    B = 5
    K, signs = _quasidefinite(B, N, nblk, rng)
    b = rng.standard_normal((B, N))
    dd = 1e-9

    @jax.jit
    def ref(K, b):
        fac = ldl_factor_pallas(K, signs=signs, dyn_delta=dd, block_b=4,
                                interpret=True)
        return (fac['L'], fac['d'], fac['Linv'],
                ldl_inverse_pallas(fac, block_b=4, interpret=True),
                ldl_solve_pallas(fac, b, block_b=4, interpret=True))

    L_r, d_r, V_r, Kinv_r, x_r = ref(jnp.asarray(K), jnp.asarray(b))
    fac = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, dd)
    assert fac['Linv'].shape == V_r.shape
    _close(fac['L'], L_r)
    _close(fac['d'], d_r)
    _close(fac['Linv'], V_r)
    _close(ldl_kernel.ldl_inverse_plain(fac), Kinv_r)
    _close(ldl_kernel.ldl_solve_plain(fac, torch.tensor(b)), x_r)


def test_tiny_pivots_refinable():
    """tests/test_ldl.py:39-55: with a nearly zero primal block the
    dynamically regularized factor is a contraction for refinement against
    the true K; the port's factor equals the JAX package's."""
    rng = np.random.default_rng(1)
    B, N, nblk = 2, 24, 8
    K, signs = _quasidefinite(B, N, nblk, rng)
    K[:, :nblk, :nblk] *= 1e-7
    b = rng.standard_normal((B, N))
    fac = ldl_kernel.ldl_factor_kernel(torch.tensor(K), signs, 1e-6)
    fac_r = jax.jit(lambda K: ldl_ref.ldl_factor(K, signs=signs,
                                                 dyn_delta=1e-6))(
        jnp.asarray(K))
    _close(fac['d'], fac_r['d'])
    x = ldl_kernel.ldl_solve_kernel(fac, torch.tensor(b)).numpy()
    for _ in range(5):
        r = b - np.einsum('bij,bj->bi', K, x)
        x = x + ldl_kernel.ldl_solve_kernel(fac, torch.tensor(r)).numpy()
    resid = b - np.einsum('bij,bj->bi', K, x)
    assert np.max(np.abs(resid)) < 1e-8


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run the plain versions and leave their
    launch counts at 0; a tensor on another device raises."""
    for w in (ldl_kernel.ldl_factor_kernel, ldl_kernel.ldl_inverse_kernel,
              ldl_kernel.ldl_solve_kernel):
        monkeypatch.setattr(w, 'launches', 0)
    rng = np.random.default_rng(4)
    K, signs = _quasidefinite(3, 20, 6, rng)
    b = rng.standard_normal((3, 20))
    Kt, bt = torch.tensor(K), torch.tensor(b)
    fac = ldl_kernel.ldl_factor_kernel(Kt, signs, 1e-9)
    fac_p = ldl_kernel.ldl_factor_plain(Kt, signs, 1e-9)
    for key in ('L', 'd', 'Linv'):
        assert torch.equal(fac[key], fac_p[key])
    assert torch.equal(ldl_kernel.ldl_inverse_kernel(fac),
                       ldl_kernel.ldl_inverse_plain(fac_p))
    assert torch.equal(ldl_kernel.ldl_solve_kernel(fac, bt),
                       ldl_kernel.ldl_solve_plain(fac_p, bt))
    assert [w.launches for w in (ldl_kernel.ldl_factor_kernel,
                                 ldl_kernel.ldl_inverse_kernel,
                                 ldl_kernel.ldl_solve_kernel)] == [0, 0, 0]
    with pytest.raises(TypeError, match='no kernel'):
        ldl_kernel.ldl_factor_kernel(Kt.to('meta'), signs, 1e-9)


def test_small_n_panel_and_padding():
    """N below the panel makes the panel N (no padding); the factor of a
    padded N carries the identity tail."""
    rng = np.random.default_rng(5)
    K, signs = _quasidefinite(2, 7, 3, rng)
    fac = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, 1e-9)
    assert (fac['panel'], fac['Np'], tuple(fac['Linv'].shape)) == (7, 7,
                                                                   (2, 7, 7))
    K, signs = _quasidefinite(2, 18, 6, rng)
    fac = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, 1e-9)
    assert fac['Np'] == 32
    assert torch.equal(fac['d'][:, 18:], torch.ones(2, 14, dtype=torch.float64))
    assert torch.equal(fac['L'][:, 18:, 18:],
                       torch.eye(14, dtype=torch.float64).expand(2, 14, 14))
