"""Kernel K11's plain version (cvxpygen_tpu_torch/ops/banded_shared_kernel.py
::banded_iterate_plain) against the JAX package's banded_iterate in
interpret mode, on the shared-P/A charging batch of
tests/test_admm_banded_shared.py (T=48), float64 on the CPU; and its
rho-scaled iteration against the solve loop's K4 route on the unscaled
state."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from test_admm_banded_shared import _charging_family, _theta_batch
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.ops import banded_grouped as grouped_ref
from cvxpygen_tpu.ops import banded_shared_kernel as kernel_ref
from cvxpygen_tpu.ops.block_tridiag import cr_factor as cr_factor_ref
from cvxpygen_tpu.runtime import jax_family as jf_ref
from cvxpygen_tpu.solvers.admm_banded import build_banded_structure
from cvxpygen_tpu_torch.ops import banded_shared_kernel as kernel
from cvxpygen_tpu_torch.ops.banded_grouped import build_grouped_a
from cvxpygen_tpu_torch.solvers import admm_banded_shared as shared
from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
from cvxpygen_tpu_torch.solvers.admm_banded import \
    build_banded_structure as build_port

B = 4
TOL = 1e-9
ITER_KW = dict(sigma=1e-6, alpha=1.6, check_interval=5)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope='module')
def setup():
    """The port's set-up of the shared banded engine on the charging batch
    (Ruiz, CR factor at the base rho, grouped layouts), a seeded state in
    the rho-scaled variables, and the JAX package's own packed factor and
    L_left pack of the same M."""
    prob = _charging_family()
    fam = canon_ref(prob)
    st = build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m)
    jf = jf_ref.JaxFamily.from_family(fam, force_scatter=True)
    ds = jf_ref.canon_batch_sparse(jf, jnp.asarray(_theta_batch(fam, prob,
                                                                B)))
    l, u = jf_ref.qp_bounds_batch(jf, ds['b'])
    args = shared.banded_kernel_args(
        build_port(fam.P_idx, fam.A_idx, fam.n, fam.m),
        build_grouped_a(st.a_row, st.a_col, fam.m, st.s, st.nb),
        _t(ds['pvals'][0]), _t(ds['q']), _t(ds['avals'][0]), _t(l), _t(u),
        jf.n_zero, ADMMSettings(scaling=10))
    fac, meta, D_M, L_M, rho = args[0], args[1], args[6], args[7], args[11]
    fac_ref = jax.jit(cr_factor_ref)(jnp.asarray(D_M.numpy())[None],
                                     jnp.asarray(L_M.numpy())[None])
    packed_ref, meta_ref = grouped_ref.pack_cr_levels(fac_ref)
    assert meta_ref == meta
    rng = np.random.default_rng(3)
    x, z, y = (rng.standard_normal(tuple(a.shape)) for a in args[16:19])
    rho3 = rho[:, :, None]
    return dict(args=args, packed_ref=packed_ref,
                llp_ref=grouped_ref.pack_lleft(fac_ref),
                # the rho-scaled bounds and state
                q=args[13], l=args[14] * rho3, u=args[15] * rho3, x=x,
                z=_t(z) * rho3, y=y)


def _plain(s, kkt_refine, solve=kernel.cr_solve_plain):
    a = s['args']
    x, z, y = _t(s['x']), s['z'].clone(), _t(s['y'])
    out = kernel.banded_iterate_plain(
        a[0], a[1], a[2], a[3], a[6], a[7], a[11], s['q'], s['l'], s['u'],
        x, z, y, kkt_refine=kkt_refine, solve=solve, **ITER_KW)
    assert all(o is v for o, v in zip(out, (x, z, y)))
    return x, z, y


@pytest.mark.parametrize('kkt_refine', [0, 1])
def test_plain_version_matches_interpret_kernel(setup, kkt_refine):
    """Five iterations from a seeded state: x, z and y within 1e-9 of
    max(1, |v|) of the reference kernel's in interpret mode (its own packed
    factor and L_left pack of the same M)."""
    s = setup
    a = s['args']
    meta = a[1]

    def ref(packed, llp, B0, B1, D_M, L_M, rho, q, l, u, x, z, y):
        return kernel_ref.banded_iterate(
            packed, llp, meta, B0, B1, D_M, L_M, rho, q, l, u, x, z, y,
            kkt_refine=kkt_refine, interpret=True, **ITER_KW)

    def np_(v):
        return jnp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)

    out_ref = jax.jit(ref)(
        s['packed_ref'], s['llp_ref'],
        *(np_(v) for v in (a[2], a[3], a[6], a[7], a[11], s['q'], s['l'],
                           s['u'], s['x'], s['z'], s['y'])))
    for got, want in zip(_plain(s, kkt_refine), out_ref):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())))


def test_rho_scaled_iteration_is_the_k4_route(setup, monkeypatch):
    """The same iterations as the solve loop's K4 route (K5's plain version
    on the unscaled state, the CR solve through the K4 wrapper): x and y
    equal, z equal to the route's z times rho.  The K11 wrapper runs the
    plain version on CPU tensors and launches nothing."""
    s = setup
    a = s['args']
    rho3 = a[11][:, :, None]
    monkeypatch.setattr(kernel.banded_iterate, 'launches', 0)
    x, z, y = _t(s['x']), s['z'].clone(), _t(s['y'])
    kernel.banded_iterate(a[0], a[1], a[2], a[3], None, None, a[11],
                          s['q'], s['l'], s['u'], x, z, y, kkt_refine=0,
                          **ITER_KW)
    assert kernel.banded_iterate.launches == 0
    assert kernel._LIB_ITERATE is None
    xr, zr, yr = _t(s['x']), s['z'] / rho3, _t(s['y'])
    done = torch.zeros((1, 1, B), dtype=torch.int32)
    kernel.banded_shared_chunk_plain(
        *a[:16], xr, zr, yr, done, eps_abs=1e-3, eps_rel=1e-3, kkt_refine=0,
        solve=kernel.cr_solve, **ITER_KW)
    for got, want in ((x, xr), (z, zr * rho3), (y, yr)):
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=0,
            atol=1e-10 * max(1.0, float(want.abs().max())))
