"""The port's scenario-consensus ADMM (cvxpygen_tpu_torch/parallel/
consensus.py) on the CPU, float64: against the monolithic coupled program
(the float64 oracle, tests/test_consensus.py's anchor), against the JAX
package's consensus_solve unsharded and on its 8 virtual devices, and on a
2-rank gloo world (tests/torch_world.py::consensus_world)."""
import types

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import cvxpygen_tpu as ct_ref
import torch_world
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.parallel.consensus import consensus_solve as solve_ref
from cvxpygen_tpu.parallel.mesh import make_mesh
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.parallel.consensus import (consensus_indices,
                                                   consensus_solve)

K = 2
SETTINGS = dict(rho_c=2.0, outer_iters=100, eps_consensus=1e-5)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _family(n=6, m=4):
    """tests/test_consensus.py::_family: min |v|^2 + c'v s.t. G v <= d0."""
    rng = np.random.default_rng(0)
    G = rng.standard_normal((m, n))
    v = ct_ref.Variable(n, name='v')
    c = ct_ref.Parameter(n, name='c')
    d0 = ct_ref.Parameter(m, name='d0')
    prob = ct_ref.Problem(ct_ref.Minimize(ct_ref.sum_squares(v) + c @ v),
                          [G @ v <= d0])
    return prob, G, c, d0


def _scenarios(B, n=6, m=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n)), np.abs(rng.standard_normal((B, m))) + 1


def _batch(B, seed):
    prob, G, c, d0 = _family()
    cs, ds = _scenarios(B, seed=seed)
    c.value, d0.value = cs[0], ds[0]
    fam = canon_ref(prob)
    thetas = np.stack([fam.pack_theta(values={'c': cs[b], 'd0': ds[b]})
                       for b in range(B)])
    return fam, family_from_arrays(family_to_arrays(fam)), thetas, G, cs, ds


@pytest.fixture(scope='module')
def sharded(tmp_path_factory):
    """tests/test_consensus.py::test_consensus_sharded_matches_unsharded's
    batch (B=16, seed 3): the port on two ranks, the JAX package unsharded
    and on its 8 virtual devices."""
    fam_r, fam, thetas, _, _, _ = _batch(16, seed=3)
    handle = torch_world.start_world(
        torch_world.consensus_world, 2, tmp_path_factory.mktemp('world'),
        dict(fam=fam, thetas=thetas, k=K))
    with threadpool_limits(1):
        sel = [('v', np.arange(K))]
        ref = solve_ref(fam_r, thetas, sel, **SETTINGS)
        ref_mesh = solve_ref(fam_r, thetas, sel, mesh=make_mesh(8),
                             **SETTINGS)
        single = consensus_solve(fam, thetas, sel, device='cpu', **SETTINGS)
    ranks = torch_world.join_world(handle)
    as_np = lambda out: {k: np.asarray(v) for k, v in out.items()}
    return types.SimpleNamespace(ref=as_np(ref), ref_mesh=as_np(ref_mesh),
                                 single={k: np.asarray(v)
                                         for k, v in single.items()},
                                 ranks=ranks)


def test_consensus_vs_monolithic():
    """The port's consensus (B=4, two consensus entries) against the
    monolithic coupled program: a shared first-stage w plus per-scenario
    copies, solved by the float64 oracle."""
    B = 4
    _, fam, thetas, G, cs, ds = _batch(B, seed=1)
    out = consensus_solve(fam, thetas, [('v', np.arange(K))], rho_c=2.0,
                          outer_iters=200, eps_consensus=1e-6, device='cpu')
    assert bool(out['solved'])
    w = ct_ref.Variable(K, name='w')
    objs, cons = [], []
    for b in range(B):
        vb = ct_ref.Variable(6, name=f'v{b}')
        pb = ct_ref.Parameter(6, name=f'c{b}')
        pb.value = cs[b]
        objs.append(ct_ref.sum_squares(vb) + pb @ vb)
        cons += [G @ vb <= ds[b], vb[:K] == w]
    mono_obj = ct_ref.Problem(ct_ref.Minimize(sum(objs[1:], objs[0])),
                              cons).solve()
    np.testing.assert_allclose(out['z_consensus'].numpy(),
                               np.asarray(w.value).ravel(), atol=1e-4)
    total = float(out['obj'].sum())
    assert abs(total - mono_obj) < 1e-4 * max(1.0, abs(mono_obj))


@pytest.mark.parametrize('ref', ['ref', 'ref_mesh'])
def test_consensus_matches_reference(sharded, ref):
    """The port, in one process and on two ranks, against the JAX
    package's consensus_solve (unsharded and on 8 devices): z_consensus and
    x within 1e-8, equal outer iterations, solved."""
    want = getattr(sharded, ref)
    for out in [sharded.single] + sharded.ranks:
        assert bool(out['solved']) and bool(want['solved'])
        assert int(out['outer_iters']) == int(want['outer_iters'])
        np.testing.assert_allclose(out['z_consensus'], want['z_consensus'],
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(out['x'], want['x'], rtol=0, atol=1e-8)
        np.testing.assert_allclose(out['obj'], want['obj'], rtol=0,
                                   atol=1e-8)


def test_consensus_indices_errors():
    _, fam, _, _, _, _ = _batch(2, seed=1)
    with pytest.raises(ValueError, match='unknown variable'):
        consensus_indices(fam, ['nope'])
    with pytest.raises(ValueError, match='out of range'):
        consensus_indices(fam, [('v', [99])])
    assert consensus_indices(fam, ['v']).size == 6
    with pytest.raises(ValueError, match='no consensus variables'):
        consensus_solve(fam, np.zeros((2, fam.p)), [('v', [])],
                        device='cpu')


def test_consensus_requires_shared_PA():
    """A family whose P depends on theta: consensus_solve refuses."""
    v = ct_ref.Variable(2, name='v')
    w = ct_ref.Parameter(2, name='w', nonneg=True)
    prob = ct_ref.Problem(ct_ref.Minimize(
        ct_ref.sum_squares(ct_ref.multiply(w, v)) + ct_ref.sum(v)),
        [v >= -1.0])
    w.value = np.array([1.0, 2.0])
    fam_r = canon_ref(prob)
    fam = family_from_arrays(family_to_arrays(fam_r))
    thetas = np.stack([fam.pack_theta(values={'w': np.array([1.0, 2.0])}),
                       fam.pack_theta(values={'w': np.array([2.0, 1.0])})])
    with pytest.raises(ValueError, match='shared across'):
        consensus_solve(fam, thetas, ['v'], device='cpu')
