"""The port's modeling layer, canonicalizer and float64 oracle
(cvxpygen_tpu_torch) against the JAX package's on the same problems.

Both packages build each problem from tests/problems.py: its source is
executed a second time with the module global ``ct`` bound to the port, so
its problem functions (which reseed numpy themselves) give the same
problem.
"""
import types

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import cvxpygen_tpu  # noqa: F401  (the reference package)
import problems as problems_ref
import cvxpygen_tpu_torch
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu_torch.canon.canonicalizer import (canonicalize,
                                                    family_from_arrays,
                                                    family_to_arrays)


def _problems_torch():
    mod = types.ModuleType('problems_torch')
    src = open(problems_ref.__file__).read()
    exec(compile(src, problems_ref.__file__, 'exec'), mod.__dict__)
    mod.ct = cvxpygen_tpu_torch
    return mod


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test: the suite runs in several worker
    processes on shared cores, where multi-threaded BLAS calls on these
    small problems spin against each other and run orders of magnitude
    slower."""
    with threadpool_limits(limits=1):
        yield


_FAMILIES = {
    'nonneg_LS': ('nonneg_LS_problem', 'assign_nonneg_LS'),
    'MPC': ('MPC_problem', 'assign_MPC'),
    'portfolio': ('portfolio_problem', 'assign_portfolio'),
}


def _both(name):
    make, assign = _FAMILIES[name]
    pt = _problems_torch()
    ref = getattr(problems_ref, assign)(getattr(problems_ref, make)())
    port = getattr(pt, assign)(getattr(pt, make)())
    return ref, port


def _assert_same_family(fa, fb):
    a, b = family_to_arrays(fa), family_to_arrays(fb)
    for k in ('n', 'm', 'p', 'p1', 'n_zero', 'n_nonneg', 'soc_dims',
              'is_maximization', 'n_exp', 'psd_dims', 'pow_alphas'):
        assert a[k] == b[k], k
    for k in ('P_idx', 'A_idx'):
        for ia, ib in zip(a[k], b[k]):
            assert np.array_equal(ia, ib), k
    for k in ('P_map', 'q_map', 'd_map', 'A_map', 'b_map', 'd_quad'):
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
            continue
        assert a[k]['shape'] == b[k]['shape'], k
        for part in ('data', 'indices', 'indptr'):
            assert np.array_equal(a[k][part], b[k][part]), (k, part)
    for pa, pb in zip(a['param_info'], b['param_info']):
        for k in ('name', 'shape', 'offset', 'flat_size'):
            assert pa[k] == pb[k], k
        if pa['coords'] is None:
            assert pb['coords'] is None
        else:
            for ca, cb in zip(pa['coords'], pb['coords']):
                assert np.array_equal(ca, cb)
    assert len(a['param_info']) == len(b['param_info'])
    for va, vb in zip(a['var_info'], b['var_info']):
        for k in ('name', 'shape', 'offset', 'size', 'is_user'):
            assert va[k] == vb[k], k
    assert a['constr_records'] == b['constr_records']


@pytest.mark.parametrize('name', sorted(_FAMILIES))
def test_canonicalization_equals_reference(name):
    ref, port = _both(name)
    _assert_same_family(canon_ref(ref), canonicalize(port))


@pytest.mark.parametrize('name', sorted(_FAMILIES))
def test_family_arrays_round_trip(name):
    """A Family canonicalized by the JAX package crosses into the port
    through plain arrays and stays the same family."""
    ref, port = _both(name)
    fam_ref = canon_ref(ref)
    fam = family_from_arrays(family_to_arrays(fam_ref))
    assert type(fam).__module__ == 'cvxpygen_tpu_torch.canon.canonicalizer'
    _assert_same_family(fam_ref, fam)
    _assert_same_family(fam, canonicalize(port))
    theta = fam_ref.pack_theta(params=ref.parameters())
    # Parameter ids come from each package's own counter, so the crossed
    # family is packed by name from the port's parameter values.
    values = {pp.name(): pp.value for pp in port.parameters()}
    assert np.array_equal(theta, fam.pack_theta(values=values))
    for a, b in zip(fam_ref.canon_numpy(theta), fam.canon_numpy(theta)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('name', sorted(_FAMILIES))
def test_oracle_matches_reference(name):
    ref, port = _both(name)
    obj_ref = ref.solve()
    obj = port.solve()
    assert port.status == ref.status
    assert abs(obj - obj_ref) <= 1e-9 * max(1.0, abs(obj_ref))
    for va, vb in zip(ref.variables(), port.variables()):
        np.testing.assert_allclose(vb.value, va.value, rtol=0, atol=1e-9)
