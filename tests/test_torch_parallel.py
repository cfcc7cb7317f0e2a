"""The port's parallel layer (cvxpygen_tpu_torch/parallel/mesh.py and the
solvers' ``group``) on a 4-rank gloo world on the CPU, float64, against
the JAX package's sharded solves on its 8 virtual devices
(tests/test_parallel.py's MPC setup).  One world runs every case
(tests/torch_world.py::parallel_world) while the JAX references compute."""
import types

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import problems as problems_ref
import torch_world
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.parallel.mesh import (make_mesh, make_sharded_qp_solve,
                                        shard_theta, sharded_solve)
from cvxpygen_tpu.runtime.solver import CompiledConicSolver as ConicRef
from cvxpygen_tpu.runtime.solver import CompiledQPSolver as SolverRef
from cvxpygen_tpu.solvers.admm import ADMMSettings as SettingsRef
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver

B_SOCP = 8
ONE_RANK_CASES = ('shared_loop', 'shared_inv', 'per_instance_ns',
                  'per_instance_inv', 'ipm')


def _port_family(fam_ref):
    return family_from_arrays(family_to_arrays(fam_ref))


def _mpc_setup():
    make, assign = problems_ref.ALL['MPC']
    prob = make()
    fam = canon_ref(prob)
    thetas = []
    for seed in range(8):
        assign(prob, seed=seed)
        thetas.append(fam.pack_theta(params=prob.parameters()))
    return fam, np.stack(thetas)


def _socp_setup():
    """The ADP SOCP family (n=17, two SOC(4) cones), Rsqrt scaled by U(0.1,
    3) per entry: instances that stop at 6 and at 7 iterations on both
    ranks."""
    prob = problems_ref.assign_ADP(problems_ref.ADP_problem())
    fam = canon_ref(prob)
    base = fam.pack_theta(params=prob.parameters())
    ri = [pi for pi in fam.param_info if pi.name == 'Rsqrt'][0]
    theta = np.tile(base, (B_SOCP, 1))
    theta[:, ri.offset:ri.offset + ri.flat_size] *= \
        np.random.default_rng(1).uniform(0.1, 3.0, (B_SOCP, ri.flat_size))
    return fam, theta


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    fam, T = _mpc_setup()
    fam_s, T_s = _socp_setup()
    mpc = _port_family(fam)
    handle = torch_world.start_world(
        torch_world.parallel_world, 4, tmp_path_factory.mktemp('world'),
        dict(mpc=mpc, T=T, socp=_port_family(fam_s), T_socp=T_s))
    with threadpool_limits(1):
        assert len(jax.devices()) >= 8
        mesh = make_mesh(8)
        solver = SolverRef(fam)
        ref = dict(shared=sharded_solve(solver, T, mesh),
                   socp=sharded_solve(ConicRef(fam_s, dtype=jnp.float64),
                                      T_s, mesh))
        ref['per_instance'] = solver.solve_batch(shard_theta(T, mesh),
                                                 shared_PA=False)
        run = make_sharded_qp_solve(
            solver.jf, make_mesh(8, axes=('batch', 'model'), shape=(4, 2)),
            SettingsRef())
        ref['model'] = run(T[:4])
        ref['full_single'] = CompiledQPSolver(mpc, device='cpu').solve_batch(
            T, settings=torch_world.k2_settings(), shared_PA=False)
        ref = {k: {f: np.asarray(v) for f, v in r.items()}
               for k, r in ref.items()}
    ranks = torch_world.join_world(handle)
    return types.SimpleNamespace(ref=ref, ranks=ranks, T=T)


@pytest.mark.parametrize('case', ['shared', 'per_instance', 'socp'])
def test_sharded_solve_matches_reference(world, case):
    """sharded_solve on two batch ranks equals the JAX package's sharded
    solve: x and the objective within 1e-8 (relative) / 1e-10, each
    instance's iterations equal, every instance solved; every rank returns
    the whole batch."""
    ref = world.ref[case]
    for out in world.ranks:
        got = out[case]
        np.testing.assert_array_equal(got['iters'], ref['iters'])
        assert np.all(got['solved'])
        np.testing.assert_allclose(got['x'], ref['x'], rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(got['obj'], ref['obj'], rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize('case', ['shared', 'per_instance', 'socp'])
def test_termination_crosses_ranks(world, case):
    """The loop's end is decided over the ranks: the two batch ranks' own
    instances stop at different iterations (tests/test_parallel.py's
    check), and every instance of the whole batch is solved."""
    iters = world.ranks[0][case]['iters']
    half = len(iters) // 2
    assert sorted(iters[:half]) != sorted(iters[half:])
    assert len(set(iters.tolist())) > 1
    assert np.all(world.ranks[0][case]['solved'])
    if case == 'socp':
        single = world.ranks[0]['socp_single']
        np.testing.assert_array_equal(single['iters'], iters)


def test_model_axis_matches_reference(world):
    """make_sharded_qp_solve on the (2, 2) mesh (P and A by rows over the
    model axis) against the JAX package's (4, 2) mesh: objective within
    1e-6, x within 1e-5 / 1e-7."""
    ref = world.ref['model']
    for out in world.ranks:
        got = out['model_inv']
        np.testing.assert_allclose(got['obj'], ref['obj'], rtol=1e-6)
        np.testing.assert_allclose(got['x'], ref['x'], rtol=1e-5, atol=1e-7)


def test_model_axis_newton_schulz_matches_replicated(world):
    """The model axis with the Newton-Schulz factor and adaptive rho (each
    sweep and refactorization exchanged over the model group) against the
    replicated per-instance solve: equal iterations, x within 1e-9."""
    for out in world.ranks:
        got, ref = out['model_ns'], out['model_ns_single']
        np.testing.assert_array_equal(got['iters'], ref['iters'])
        assert np.all(got['solved'])
        np.testing.assert_allclose(got['x'], ref['x'], rtol=0, atol=1e-9)


def test_k1_rho_group_from_whole_batch(world):
    """Kernel K1's rho group is taken from the whole batch (8 instances: a
    group of 8); a rank holding 4 raises, naming both numbers."""
    msg = world.ranks[0]['k1_raise']
    assert msg is not None and '8 instances' in msg and 'holds 4' in msg


def test_k1_sharded_equals_single(world):
    """With a pinned rho group of 2 each rank holds whole groups: K1's plain
    version on each rank's rows equals the single-process call on them."""
    for rank, out in enumerate(world.ranks):
        lo = (rank // 2) * 4
        single, got = out['k1_single'], out['k1_sharded']
        np.testing.assert_array_equal(got['iters'],
                                      single['iters'][lo:lo + 4])
        np.testing.assert_allclose(got['x'], single['x'][lo:lo + 4],
                                   rtol=0, atol=1e-12)


def test_k2_sharded_equals_single(world):
    """Kernel K2 (its plain version, adaptive rho) through sharded_solve
    takes its block from the whole batch (4 of 8 instances in float64) and
    equals the single-process solve: equal iterations, x within 1e-12."""
    ref = world.ref['full_single']
    for out in world.ranks:
        got = out['full']
        assert np.all(got['solved'])
        np.testing.assert_array_equal(got['iters'], ref['iters'])
        np.testing.assert_allclose(got['x'], ref['x'], rtol=0, atol=1e-12)


def test_k2_block_from_whole_batch(world):
    """Kernel K2's block is taken from the whole batch (32 instances of a
    small QP: a block of 32); a rank holding 16 raises, naming both
    numbers, rather than solve with a block of 16."""
    for out in world.ranks:
        msg = out['k2_raise']
        assert msg is not None and '(32 instances)' in msg
        assert 'is 32 instances' in msg and 'holds 16' in msg


@pytest.mark.parametrize('case', ONE_RANK_CASES)
def test_one_rank_group_changes_nothing(world, case):
    """A 1-rank group gives results bitwise equal to the plain call (no
    group): the shared loop, the per-instance loop, the IPM."""
    assert all(out['one_rank_same'][case] for out in world.ranks)
