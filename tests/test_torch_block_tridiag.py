"""The port's block-tridiagonal solver (cvxpygen_tpu_torch/ops/
block_tridiag.py) against the JAX package's ops/block_tridiag.py on random
SPD block-tridiagonal systems, float64 on the CPU, the same inputs made
with numpy for both."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from cvxpygen_tpu.ops import block_tridiag as ref_module
from cvxpygen_tpu_torch.ops import block_tridiag as port

RTOL = 1e-10


class _Jitted:
    """The reference module's functions under jax.jit: one compile per
    shape instead of one per operation."""

    def __getattr__(self, name):
        return jax.jit(getattr(ref_module, name))


ref = _Jitted()


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test (several worker processes share the
    cores)."""
    with threadpool_limits(limits=1):
        yield


def _random_bt_spd(B, nb, s, seed):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, nb, s, s))
    D = D @ np.swapaxes(D, 2, 3) + 4 * s * np.eye(s)
    L = 0.3 * rng.standard_normal((B, nb - 1, s, s))
    b = rng.standard_normal((B, nb, s))
    return D, L, b


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not got.size:
        return
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize('B,nb,s', [(3, 7, 4), (2, 12, 8), (1, 33, 4),
                                    (2, 41, 3)])
def test_cr_factor_and_solve_match_reference(B, nb, s):
    """Odd and even block counts, so every level's padding is covered
    (nb=41 runs 41 -> 21 -> 11 -> 6 -> 3 -> 2 -> 1)."""
    D, L, b = _random_bt_spd(B, nb, s, seed=nb)
    fac_ref = ref.cr_factor(jnp.asarray(D), jnp.asarray(L))
    fac = port.cr_factor(torch.tensor(D), torch.tensor(L))
    assert len(fac['levels']) == len(fac_ref['levels'])
    for lv, lv_ref in zip(fac['levels'], fac_ref['levels']):
        assert lv.keys() == lv_ref.keys()
        for k in lv:
            _close(lv[k].numpy(), lv_ref[k])
    _close(fac['root_inv'].numpy(), fac_ref['root_inv'])
    x_ref = ref.cr_solve(fac_ref, jnp.asarray(b))
    x = port.cr_solve(fac, torch.tensor(b))
    _close(x.numpy(), x_ref)
    # and it solves the system
    r = port.bt_matvec(torch.tensor(D), torch.tensor(L), x) - torch.tensor(b)
    assert float(r.abs().max()) < 1e-10


@pytest.mark.parametrize('B,nb,s', [(4, 16, 3), (2, 9, 4)])
def test_bt_factor_and_solve_match_reference(B, nb, s):
    D, L, b = _random_bt_spd(B, nb, s, seed=100 + nb)
    fac_ref = ref.bt_factor(jnp.asarray(D), jnp.asarray(L))
    fac = port.bt_factor(torch.tensor(D), torch.tensor(L))
    _close(fac['S_inv'].numpy(), fac_ref['S_inv'])
    _close(port.bt_solve(fac, torch.tensor(b)).numpy(),
           ref.bt_solve(fac_ref, jnp.asarray(b)))


def test_bt_matvec_matches_reference():
    D, L, b = _random_bt_spd(2, 5, 2, seed=2)
    _close(port.bt_matvec(torch.tensor(D), torch.tensor(L),
                          torch.tensor(b)).numpy(),
           ref.bt_matvec(jnp.asarray(D), jnp.asarray(L), jnp.asarray(b)))


def test_dense_to_bt_and_bandwidth_match_reference():
    D, L, _ = _random_bt_spd(2, 6, 2, seed=4)
    n = 12
    M = np.zeros((2, n, n))
    for i in range(6):
        M[:, 2 * i:2 * i + 2, 2 * i:2 * i + 2] = D[:, i]
        if i:
            M[:, 2 * i:2 * i + 2, 2 * i - 2:2 * i] = L[:, i - 1]
            M[:, 2 * i - 2:2 * i, 2 * i:2 * i + 2] = np.swapaxes(
                L[:, i - 1], 1, 2)
    D2, L2 = port.dense_to_bt(torch.tensor(M), 2)
    D2r, L2r = ref_module.dense_to_bt(jnp.asarray(M), 2)
    np.testing.assert_array_equal(D2.numpy(), np.asarray(D2r))
    np.testing.assert_array_equal(L2.numpy(), np.asarray(L2r))
    for pat in (M[0], np.ones((24, 24)), np.eye(24)):
        assert (port.detect_block_bandwidth(pat)
                == ref_module.detect_block_bandwidth(pat))
