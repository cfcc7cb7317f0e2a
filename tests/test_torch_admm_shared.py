"""solvers/admm_shared.py and kernel K1's plain version
(cvxpygen_tpu_torch) against the JAX package: its XLA loop, and its Pallas
kernel ops/admm_shared_kernel.py run in interpret mode.  float64 on the CPU,
the same inputs made with numpy for both."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from test_admm_shared import _shared_qp_batch
from cvxpygen_tpu.ops.admm_shared_kernel import (admm_shared_solve_pallas,
                                                 pick_shared_chunk as
                                                 pick_shared_chunk_ref)
from cvxpygen_tpu.solvers import admm as admm_ref
from cvxpygen_tpu.solvers.admm_shared import (
    admm_solve_shared as admm_solve_shared_ref,
    ruiz_equilibrate_shared as ruiz_ref)
from cvxpygen_tpu_torch.ops.admm_shared_kernel import (
    _cta_rows, _launch, admm_shared_solve, admm_shared_solve_plain,
    pick_shared_chunk, ring_offset, shared_smem_bytes)
from cvxpygen_tpu_torch.solvers import admm
from cvxpygen_tpu_torch.solvers.admm_shared import (admm_solve_shared,
                                                    ruiz_equilibrate_shared,
                                                    use_kernel)

# adaptive_rho_tolerance 1.5 makes the adaptive runs actually refactor
# (their iteration counts differ from the non-adaptive runs; the default
# 5.0 never triggers a change on these batches)
_TOL = 1.5


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test: the suite runs in several worker
    processes on shared cores, where multi-threaded BLAS calls on these
    small problems spin against each other and run orders of magnitude
    slower."""
    with threadpool_limits(limits=1):
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


def _batch(**kw):
    (P, q, A, l, u), n_eq = _shared_qp_batch(**kw)
    return (P, q, A, l, u), tuple(_t(v) for v in (P, q, A, l, u)), n_eq


def _assert_same(ref, out, atol):
    assert np.array_equal(np.asarray(ref['status']), out['status'].numpy())
    assert np.array_equal(np.asarray(ref['iters']), out['iters'].numpy())
    for k in ('x', 'y', 'z'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol)
    np.testing.assert_allclose(out['obj'].numpy(), np.asarray(ref['obj']),
                               rtol=0, atol=atol)


def _settings(pkg, **kw):
    base = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=8000, ns_iters=40,
                adaptive_rho_tolerance=_TOL)
    base.update(kw)
    return pkg.ADMMSettings(**base)


@functools.lru_cache(maxsize=None)
def _reference(B, **kw):
    """The JAX package's shared solve of _batch(B) at these settings,
    computed once for the module (several tests hold the port to the same
    one)."""
    ref_in, _, n_eq = _batch(B=B)
    return admm_solve_shared_ref(*ref_in, n_eq, _settings(admm_ref, **kw))


@pytest.mark.parametrize('adaptive', [False, True])
@pytest.mark.parametrize('kkt', ['inv', 'chol', 'ns'])
def test_loop_matches_reference(kkt, adaptive):
    ref_in, port_in, n_eq = _batch(B=16)
    kw = dict(kkt_solver=kkt, use_pallas='never', adaptive_rho=adaptive)
    ref = admm_solve_shared_ref(*ref_in, n_eq, _settings(admm_ref, **kw))
    out = admm_solve_shared(*port_in, n_eq, _settings(admm, **kw))
    assert np.all(out['solved'].numpy())
    _assert_same(ref, out, atol=1e-8)


def test_adaptive_settings_refactor():
    """The adaptive runs below change rho: their iterations differ."""
    _, port_in, n_eq = _batch(B=16)
    off = admm_solve_shared(*port_in, n_eq, _settings(
        admm, kkt_solver='ns', use_pallas='never'))
    on = admm_solve_shared(*port_in, n_eq, _settings(
        admm, kkt_solver='ns', use_pallas='never', adaptive_rho=True))
    assert not np.array_equal(off['iters'].numpy(), on['iters'].numpy())


@pytest.mark.parametrize('adaptive', [False, True])
def test_kernel_plain_matches_interpret_kernel(adaptive):
    """K1's plain version behind admm_solve_shared against the JAX
    package's full_interpret path, which picks chunk = B there."""
    _, port_in, n_eq = _batch(B=32)
    assert pick_shared_chunk_ref(32, 18, 12) == 32
    kw = dict(kkt_solver='ns', use_pallas='full_interpret', max_iter=4000,
              check_interval=20, adaptive_rho=adaptive)
    ref = _reference(32, **kw)
    out = admm_solve_shared(*port_in, n_eq, _settings(admm, **kw), chunk=32)
    assert np.all(out['solved'].numpy())
    _assert_same(ref, out, atol=1e-9)


def _scaled_inputs(B=32, seed=1):
    """The scaled data admm_solve_shared hands to the kernel, made with the
    JAX package's own functions."""
    (P, q, A, l, u), n_eq = _shared_qp_batch(B=B, seed=seed)
    m, n = A.shape
    l, u = jnp.clip(l, -1e30, 1e30), jnp.clip(u, -1e30, 1e30)
    Ps, As, c, D, E = ruiz_ref(P, A, q, 10)
    rho = jnp.where(jnp.arange(m) < n_eq, 0.1 * 1e3, 0.1)
    M0 = Ps + 1e-6 * jnp.eye(n) + (As.T * rho[None, :]) @ As
    Minv0 = admm_ref.newton_schulz_inverse(M0[None], 40)[0]
    x_start, z_start = jnp.zeros((B, n)), jnp.zeros((B, m))
    return (Ps, (q * D) * c, As, l * E, u * E, rho, D, E, 1.0 / c, M0,
            Minv0, x_start, z_start, z_start)


def _kernel_kw(adaptive):
    return dict(sigma=1e-6, alpha=1.6, eps_abs=1e-6, eps_rel=1e-6,
                check_interval=20, max_iter=4010, ns_adapt_iters=8,
                adaptive=adaptive, rho_tol=_TOL, kkt_refine=1)


def _run_both(args, chunk, adaptive):
    ref = admm_shared_solve_pallas(*args, **_kernel_kw(adaptive),
                                   chunk=chunk, interpret=True)
    targs = [_t(a) if hasattr(a, 'shape') else float(a) for a in args]
    out = admm_shared_solve(*targs, **_kernel_kw(adaptive), chunk=chunk)
    return ref, out


def _assert_kernel_same(ref, out, atol=1e-9):
    names = ('x', 'z', 'y', 'iters', 'status', 'rp', 'rd')
    for name, a, b in zip(names, ref, out):
        a = np.asarray(a)
        if name in ('iters', 'status'):
            assert np.array_equal(a, b.numpy()), name
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-9, atol=atol,
                                       err_msg=name)


def test_kernel_plain_matches_interpret_kernel_chunked():
    """Chunk 8 of B=32 on both sides: four chunks, each with its own
    adaptive rho, and the chunking matters (chunk 32 gives other
    iterations)."""
    args = _scaled_inputs(B=32)
    ref, out = _run_both(args, chunk=8, adaptive=True)
    _assert_kernel_same(ref, out)
    assert np.all(out[4].numpy() == 1)
    whole = admm_shared_solve_plain(
        *[_t(a) if hasattr(a, 'shape') else float(a) for a in args],
        **_kernel_kw(True), chunk=32)
    assert not np.array_equal(whole[3].numpy(), out[3].numpy())
    fixed = admm_shared_solve_plain(
        *[_t(a) if hasattr(a, 'shape') else float(a) for a in args],
        **_kernel_kw(False), chunk=8)
    assert not np.array_equal(fixed[3].numpy(), out[3].numpy())


def test_kernel_plain_adapt_until_and_warm_start():
    (P, q, A, l, u), n_eq = _shared_qp_batch(B=16, seed=3)
    ref_in = (P, q, A, l, u)
    st = dict(kkt_solver='ns', use_pallas='full_interpret', max_iter=2000,
              check_interval=10, adaptive_rho=True, adaptive_rho_until=40)
    cold_ref = admm_solve_shared_ref(*ref_in, n_eq, _settings(admm_ref, **st))
    warm_ref = admm_solve_shared_ref(*ref_in, n_eq, _settings(admm_ref, **st),
                                     x0=cold_ref['x'], y0=cold_ref['y'])
    port_in = tuple(_t(v) for v in ref_in)
    cold = admm_solve_shared(*port_in, n_eq, _settings(admm, **st), chunk=16)
    warm = admm_solve_shared(*port_in, n_eq, _settings(admm, **st),
                             x0=cold['x'], y0=cold['y'], chunk=16)
    _assert_same(cold_ref, cold, atol=1e-9)
    _assert_same(warm_ref, warm, atol=1e-9)
    assert warm['iters'].float().mean() < cold['iters'].float().mean()


def test_loop_warm_start_matches_reference():
    ref_in, port_in, n_eq = _batch(B=8, seed=2)
    kw = dict(kkt_solver='inv', use_pallas='never')
    cold_ref = admm_solve_shared_ref(*ref_in, n_eq, _settings(admm_ref, **kw))
    warm_ref = admm_solve_shared_ref(*ref_in, n_eq, _settings(admm_ref, **kw),
                                     x0=cold_ref['x'], y0=cold_ref['y'])
    warm = admm_solve_shared(*port_in, n_eq, _settings(admm, **kw),
                             x0=_t(cold_ref['x']), y0=_t(cold_ref['y']))
    _assert_same(warm_ref, warm, atol=1e-8)


def _primal_infeasible():
    n, B = 2, 3
    P = np.eye(n)
    A = np.vstack([np.eye(n), np.eye(n)])
    q = np.zeros((B, n))
    l = np.tile([1.0, 1.0, -1e30, -1e30], (B, 1))
    u = np.tile([1e30, 1e30, -1.0, -1.0], (B, 1))
    return (P, q, A, l, u), -3


def _dual_infeasible():
    B = 2
    return (np.zeros((1, 1)), np.full((B, 1), -1.0), np.ones((1, 1)),
            np.zeros((B, 1)), np.full((B, 1), 1e30)), -4


@pytest.mark.parametrize('engine', ['never', 'full_interpret'])
@pytest.mark.parametrize('case', [_primal_infeasible, _dual_infeasible])
def test_infeasibility_matches_reference(case, engine):
    data, code = case()
    kw = dict(max_iter=4000, use_pallas=engine,
              kkt_solver='inv' if engine == 'never' else 'ns')
    ref = admm_solve_shared_ref(*(jnp.asarray(v) for v in data), 0,
                                admm_ref.ADMMSettings(**kw))
    out = admm_solve_shared(*(_t(v) for v in data), 0, admm.ADMMSettings(**kw))
    assert np.all(out['status'].numpy() == code)
    assert np.array_equal(np.asarray(ref['iters']), out['iters'].numpy())
    assert np.all(np.isinf(out['obj'].numpy()))


def test_ruiz_and_newton_schulz_match_reference():
    (P, q, A, _, _), _ = _shared_qp_batch(B=8)
    ref = ruiz_ref(P, A, q, 10)
    out = ruiz_equilibrate_shared(_t(P), _t(A), _t(q), 10)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14,
                                   atol=0)
    Ps, As = ref[0], ref[1]
    rho = jnp.full((As.shape[0],), 0.1)
    M = Ps + 1e-6 * jnp.eye(Ps.shape[0]) + (As.T * rho) @ As
    X_ref = admm_ref.newton_schulz_inverse(M[None], 16)
    X = admm.newton_schulz_inverse(_t(M)[None], 16)
    np.testing.assert_allclose(X.numpy(), np.asarray(X_ref), atol=1e-12)
    M2 = M + (As.T * (9 * rho)) @ As
    W_ref = admm_ref.newton_schulz_warm(M2[None], X_ref, 8)
    W = admm.newton_schulz_warm(_t(M2)[None], X, 8)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), atol=1e-12)
    np.testing.assert_allclose(
        admm.ns_residual_err(_t(M2)[None], W).numpy(),
        np.asarray(admm_ref.ns_residual_err(M2[None], W_ref)), atol=1e-12)


def test_chunk_rule():
    """The rho group is the JAX package's: 1024 at the flagship B=2048 (the
    port's first rule gave 8, one block's worth), none at B=1 and B=6, where
    the solver runs its loop (the first rule gave 1 and 2)."""
    assert pick_shared_chunk(2048, 252, 222) == 1024
    assert pick_shared_chunk(1, 252, 222) is None
    assert pick_shared_chunk(6, 252, 222) is None
    assert pick_shared_chunk(8, 40000, 40000) is None
    args = [_t(a) if hasattr(a, 'shape') else float(a)
            for a in _scaled_inputs(B=8)]
    with pytest.raises(ValueError, match='does not divide'):
        admm_shared_solve_plain(*args, **_kernel_kw(False), chunk=3)
    six = [a[:6] if hasattr(a, 'shape') and a.dim() == 2
           and a.shape[0] == 8 else a for a in args]
    with pytest.raises(ValueError, match='no rho group'):
        admm_shared_solve_plain(*six, **_kernel_kw(False))


@pytest.mark.parametrize('shape', [(252, 222), (18, 12)])
@pytest.mark.parametrize('B', [1, 6, 8, 32, 64, 256, 2048, 4096])
def test_chunk_rule_matches_reference(B, shape):
    m, n = shape
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64,
                                                   jnp.float64)):
        assert pick_shared_chunk(B, m, n, dt) == pick_shared_chunk_ref(
            B, m, n, jdt)


@pytest.mark.parametrize('B, kernel', [(32, True), (6, False)])
def test_default_route_matches_reference(B, kernel):
    """No chunk given: at B=32 both packages run the kernel at chunk 32 (its
    plain version here, interpret mode there), at B=6 both run the loop."""
    _, port_in, n_eq = _batch(B=B)
    kw = dict(kkt_solver='ns', use_pallas='full_interpret', max_iter=4000,
              check_interval=20, adaptive_rho=True)
    st = _settings(admm, **kw)
    assert use_kernel(st, 'ns', B, 18, 12, torch.float64,
                      torch.device('cpu')) is kernel
    assert (pick_shared_chunk_ref(B, 18, 12, jnp.float64)
            is not None) is kernel
    ref = _reference(B, **kw)
    out = admm_solve_shared(*port_in, n_eq, st)
    assert np.all(out['solved'].numpy())
    _assert_same(ref, out, atol=1e-9 if kernel else 1e-8)


def test_card_layout_rule():
    """Instances per thread block on the card: the largest of 16, 8, 4, 2, 1
    that divides the chunk and fits shared memory; the warps' rings start on
    16 bytes at every layout; a layout that does not tile the chunk or fit
    raises before anything reaches the card."""
    n, m = 222, 252
    assert shared_smem_bytes(16, n, m) <= 232448 < shared_smem_bytes(24, n, m)
    assert [_cta_rows(c, n, m) for c in (1024, 256, 8, 6, 4, 2, 1)] \
        == [16, 16, 8, 2, 4, 2, 1]
    wide = _cta_rows(16, 1000, 1000)
    assert shared_smem_bytes(wide, 1000, 1000) <= 232448 \
        < shared_smem_bytes(2 * wide, 1000, 1000)
    for shape in ((n, m), (12, 18), (5, 3), (1000, 1000)):
        assert all(ring_offset(r, *shape) % 4 == 0 for r in (16, 8, 4, 2, 1))
    for rows, chunk, shape in ((16, 8, (n, m)), (3, 6, (n, m)),
                               (16, 16, (1000, 1000))):
        args = (None, torch.zeros((16, shape[0])),
                torch.zeros((shape[1], shape[0]))) + (None,) * 11
        with pytest.raises(ValueError, match='do not tile'):
            _launch(args, dict(chunk=chunk, check_interval=15), rows)
