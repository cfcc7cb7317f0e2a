"""Kernel K2's plain version (cvxpygen_tpu_torch/ops/admm_full_kernel.py)
against the JAX package's Pallas kernel ops/admm_full_kernel.py in interpret
mode, on the scaled data the per-instance solve hands it.  float64 on the
CPU (float32 for the portfolio witness), the same inputs made with numpy
for both."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from test_full_kernel import _random_qp_batch
from cvxpygen_tpu.ops.admm_full_kernel import admm_solve_full_pallas
from cvxpygen_tpu.ops.admm_full_kernel import \
    pick_full_block as pick_full_block_ref
from cvxpygen_tpu.solvers import admm as admm_ref
from cvxpygen_tpu_torch.ops.admm_full_kernel import (_sweeps,
                                                     admm_solve_full,
                                                     admm_solve_full_plain,
                                                     full_layout,
                                                     full_smem_bytes,
                                                     ns_cert,
                                                     pick_full_block,
                                                     pick_full_ctas,
                                                     tf32x3_matmul)
from cvxpygen_tpu_torch.solvers import admm


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test (several worker processes share the
    cores)."""
    with threadpool_limits(limits=1):
        yield


def _t(a):
    return torch.tensor(np.asarray(a))


def _scaled_inputs(B=8, seed=0):
    """The scaled data admm_solve hands to the kernel, made with the JAX
    package's own functions."""
    (P, q, A, l, u), n_eq = _random_qp_batch(B=B, seed=seed)
    P, q, A, l, u = (jnp.asarray(np.asarray(v, np.float64))
                     for v in (P, q, A, l, u))
    m = A.shape[1]
    l, u = jnp.clip(l, -1e30, 1e30), jnp.clip(u, -1e30, 1e30)
    Ps, qs, As, ls, us, c, D, E = admm_ref.ruiz_equilibrate(P, q, A, l, u, 10)
    rho = jnp.broadcast_to(jnp.where(jnp.arange(m) < n_eq, 0.1 * 1e3, 0.1),
                           (B, m))
    zn, zm = jnp.zeros((B, P.shape[1])), jnp.zeros((B, m))
    return (Ps, qs, As, ls, us, rho, D, E, 1.0 / c, zn, zm, zm)


def _kernel_kw(ns_iters, adaptive=True):
    return dict(sigma=1e-6, alpha=1.6, eps_abs=1e-6, eps_rel=1e-6,
                check_interval=20, max_iter=4010, ns_iters=ns_iters,
                ns_f32_iters=5, ns_adapt_iters=8, adaptive=adaptive,
                rho_tol=1.5, kkt_refine=1)


def _assert_kernel_same(ref, out, atol=1e-9):
    names = ('x', 'z', 'y', 'obj', 'iters', 'status', 'rp', 'rd')
    for name, a, b in zip(names, ref, out):
        a = np.asarray(a)
        if name in ('iters', 'status'):
            assert np.array_equal(a, b.numpy()), name
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-9, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize('ns_iters', [40, 4])
def test_plain_matches_interpret_kernel(ns_iters):
    """Block 2 of B=8 with adaptive rho refactoring: ns_iters 40 runs the
    certificate rescue branch (ns_iters > ns_f32_iters), 4 skips it."""
    args = _scaled_inputs()
    ref = admm_solve_full_pallas(*args, **_kernel_kw(ns_iters), block=2,
                                 interpret=True)
    stats = {}
    out = admm_solve_full_plain(*[_t(a) for a in args],
                                **_kernel_kw(ns_iters), block=2, stats=stats)
    _assert_kernel_same(ref, out)
    assert stats['refactor_blocks'] > 0
    if ns_iters == 40:
        assert np.all(out[5].numpy() == 1)


def test_block_and_adaptive_rho_change_the_answer():
    args = [_t(a) for a in _scaled_inputs()]
    on = admm_solve_full_plain(*args, **_kernel_kw(40), block=2)
    off = admm_solve_full_plain(*args, **_kernel_kw(40, adaptive=False),
                                block=2)
    whole = admm_solve_full_plain(*args, **_kernel_kw(40), block=8)
    assert not np.array_equal(on[4].numpy(), off[4].numpy())
    # a block refactors all its instances when one changes rho: the same
    # iterations here, but other roundoff in x
    assert np.array_equal(on[4].numpy(), whole[4].numpy())
    assert not torch.equal(on[0], whole[0])
    # the wrapper runs the plain version on CPU tensors
    wrapped = admm_solve_full(*args, **_kernel_kw(40), block=2)
    for a, b in zip(on, wrapped):
        assert torch.equal(a, b)


def test_full_interpret_solve_matches_reference():
    """use_pallas='full_interpret' through both packages' admm_solve, each
    with its own block rule (8 for B=8)."""
    (P, q, A, l, u), n_eq = _random_qp_batch(B=8, seed=2)
    arrs = [np.asarray(v, np.float64) for v in (P, q, A, l, u)]
    kw = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=2000, check_interval=20,
              ns_iters=40, adaptive_rho=True, adaptive_rho_tolerance=1.5,
              use_pallas='full_interpret')
    ref = admm_ref.admm_solve(*(jnp.asarray(v) for v in arrs), n_eq,
                              admm_ref.ADMMSettings(**kw))
    out = admm.admm_solve(*(torch.tensor(v) for v in arrs), n_eq,
                          admm.ADMMSettings(**kw))
    assert np.all(out['solved'].numpy())
    assert np.array_equal(np.asarray(ref['iters']), out['iters'].numpy())
    for k in ('x', 'y', 'z', 'obj'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-9, err_msg=k)


def test_full_interpret_infeasible_and_warm_start():
    """test_full_kernel.py's primal-infeasible instance and its warm start,
    through the port's K2 plain version against the reference's."""
    (P, q, A, l, u), n_eq = _random_qp_batch(B=8, seed=1)
    P, q, A, l, u = (np.array(v, np.float64) for v in (P, q, A, l, u))
    A[0, 4] = A[0, 5]
    l[0, 4], u[0, 4] = -1e30, -1.0
    l[0, 5], u[0, 5] = 1.0, 1e30
    kw = dict(eps_abs=1e-4, eps_rel=1e-4, max_iter=2000, check_interval=10,
              ns_iters=40, use_pallas='full_interpret')
    data = (P, q, A, l, u)
    ref = admm_ref.admm_solve(*(jnp.asarray(v) for v in data), n_eq,
                              admm_ref.ADMMSettings(**kw))
    out = admm.admm_solve(*(torch.tensor(v) for v in data), n_eq,
                          admm.ADMMSettings(**kw))
    assert out['status'].tolist() == [-3] + [1] * 7
    assert np.isinf(out['obj'][0].item())
    assert np.array_equal(np.asarray(ref['iters']), out['iters'].numpy())
    warm_ref = admm_ref.admm_solve(*(jnp.asarray(v) for v in data), n_eq,
                                   admm_ref.ADMMSettings(**kw),
                                   x0=ref['x'], y0=ref['y'])
    warm = admm.admm_solve(*(torch.tensor(v) for v in data), n_eq,
                           admm.ADMMSettings(**kw), x0=out['x'],
                           y0=out['y'])
    assert np.array_equal(np.asarray(warm_ref['status']),
                          warm['status'].numpy())
    assert np.array_equal(np.asarray(warm_ref['iters']),
                          warm['iters'].numpy())
    ok = warm['status'].numpy() == 1
    np.testing.assert_allclose(warm['x'].numpy()[ok],
                               np.asarray(warm_ref['x'])[ok], rtol=0,
                               atol=1e-9)


def test_block_rule():
    """The port takes the reference kernel's block: 8 at the MPC shape, 16
    at the portfolio shape, the same as the reference for every shape and
    dtype here, and None where no block fits or divides B."""
    assert pick_full_block(2048, 252, 222) == 8
    assert pick_full_block(512, 172, 130) == 16
    for B, m, n in [(2048, 252, 222), (512, 172, 130), (8, 12, 10),
                    (96, 60, 50), (64, 400, 300), (6, 12, 10),
                    (8, 40000, 40000)]:
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.float64, jnp.float64)):
            assert pick_full_block(B, m, n, tdt) == pick_full_block_ref(
                B, m, n, jdt), (B, m, n, tdt)
    assert pick_full_block(8, 40000, 40000) is None
    assert pick_full_block(6, 12, 10) is None
    args = [_t(a) for a in _scaled_inputs()]
    with pytest.raises(ValueError, match='does not divide'):
        admm_solve_full_plain(*args, **_kernel_kw(40), block=3)
    with pytest.raises(ValueError, match='no block'):
        admm_solve_full_plain(*[a[:6] for a in args], **_kernel_kw(40))


def test_float32_portfolio_block_one_stalls_in_reference_too():
    """The portfolio family with per-instance factor loadings at full width
    (20 assets, 5 factors, n=130, m=172; bench.py:473-495 and its settings)
    in float32 at block 1: the Pallas kernel in interpret mode and the
    port's plain version leave the same instances (rows 3, 8, 9 and 15 of
    the bench's batch) at max_iter with the bench's one refinement sweep,
    and solve them with two.  So block 1 is a different algorithm from the
    reference's block (16 for this batch), not a fault of the port."""
    from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
    from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                        family_to_arrays)
    from cvxpygen_tpu_torch.runtime.torch_family import (TorchFamily,
                                                         canon_batch,
                                                         qp_bounds_batch)
    import problems as problems_ref
    prob = problems_ref.assign_portfolio(
        problems_ref.portfolio_problem(n=20, m=5), seed=0, n=20, m=5)
    fam_ref = canon_ref(prob)
    rng = np.random.default_rng(7)
    base = fam_ref.pack_theta(params=prob.parameters())
    Fi = [pi for pi in fam_ref.param_info if pi.name == 'F'][0]
    ai = [pi for pi in fam_ref.param_info if pi.name == 'a'][0]
    theta = np.tile(base, (512, 1))
    theta[:, Fi.offset:Fi.offset + Fi.flat_size] = np.round(
        rng.standard_normal((512, Fi.flat_size)))
    theta[:, ai.offset:ai.offset + ai.flat_size] = rng.standard_normal(
        (512, ai.flat_size))
    rows = [3, 8, 9, 15, 0, 1]
    tf = TorchFamily.from_family(family_from_arrays(family_to_arrays(fam_ref)),
                                 dtype=torch.float32, device='cpu')
    data = canon_batch(tf, theta[rows])
    l, u = qp_bounds_batch(tf, data['b'])
    for refine, status in ((1, [0, 0, 0, 0, 1, 1]), (2, [1] * 6)):
        st = admm.ADMMSettings(eps_abs=3e-4, eps_rel=3e-4, max_iter=4000,
                               check_interval=15, adaptive_rho=True,
                               kkt_refine=refine)
        args = admm.full_kernel_args(data['P'], data['q'], data['A'], l, u,
                                     tf.n_zero, st)
        kw = admm.full_kernel_kwargs(st)
        ref = admm_solve_full_pallas(
            *[jnp.asarray(a.numpy()) for a in args], **kw, block=1,
            interpret=True)
        out = admm_solve_full_plain(*args, **kw, block=1)
        assert out[0].dtype == torch.float32 and ref[0].dtype == jnp.float32
        assert np.asarray(ref[5]).tolist() == status, refine
        assert out[5].tolist() == status, refine
        if refine == 1:
            assert np.asarray(ref[4])[:4].tolist() == [3990] * 4
            assert out[4][:4].tolist() == [3990] * 4


def test_layout_picker():
    """The resident layout's team: 2 thread blocks per instance at the MPC
    shape, 1 at the portfolio shape, so both main-path blocks (8 and 16)
    fill one cluster of 16; block 32, and shapes no team of 8 holds, take
    the streaming layout (0)."""
    limit = 232448
    assert pick_full_ctas(252, 222) == 2
    assert full_smem_bytes(1, 222, 252, 1) > limit
    assert full_smem_bytes(1, 222, 252, 2) <= limit
    assert pick_full_ctas(172, 130) == 1
    assert [full_layout(b, 252, 222) for b in (1, 8, 16, 32)] == [2, 2, 0, 0]
    assert [full_layout(b, 172, 130) for b in (1, 16, 32)] == [1, 1, 0]
    assert pick_full_ctas(700, 600) == 0 and full_layout(4, 700, 600) == 0
    assert full_smem_bytes(2, 222, 252) <= limit


def test_tf32_rounding():
    """TF32 keeps 10 mantissa bits, rounding to nearest with ties away
    from zero (cvt.rna), and the split a = hi + lo is exact."""
    from cvxpygen_tpu_torch.ops.admm_full_kernel import _tf32
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                                 1 + 2.0 ** -9]
    a = torch.tensor(np.random.default_rng(0).standard_normal((64,)),
                     dtype=torch.float32)
    hi = _tf32(a)
    assert torch.equal(hi + (a - hi), a)
    lo_bits = _tf32(a - hi).view(torch.int32) & 0x1FFF
    assert not lo_bits.any()


def _mpc_M(B=4):
    """The MPC family's M = P + sigma I + A' diag(rho) A (n=222, m=252) in
    float32 on the CPU, from the seed of the existing tests, at B distinct
    x_init ~ U(-2, 2) (bench.py:132-136)."""
    from test_torch_solver import _problems_torch
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.runtime.torch_family import (TorchFamily,
                                                         canon_batch,
                                                         qp_bounds_batch)
    pt = _problems_torch()
    prob = pt.assign_MPC(pt.MPC_problem(), seed=0)
    fam = canonicalize(prob)
    theta = np.tile(fam.pack_theta(params=prob.parameters()), (B, 1))
    xi = [pi for pi in fam.param_info if pi.name == 'x_init'][0]
    theta[:, xi.offset:xi.offset + xi.flat_size] = np.random.default_rng(
        0).uniform(-2.0, 2.0, (B, xi.flat_size))
    tf = TorchFamily.from_family(fam, dtype=torch.float32, device='cpu')
    data = canon_batch(tf, theta)
    l, u = qp_bounds_batch(tf, data['b'])
    st = admm.ADMMSettings()
    Ps, _, As, _, _, rho, *_ = admm.full_kernel_args(
        data['P'], data['q'], data['A'], l, u, tf.n_zero, st)
    n = Ps.shape[-1]
    assert (n, As.shape[1]) == (222, 252) and Ps.dtype == torch.float32
    return (Ps + st.sigma * torch.eye(n)) + torch.matmul(
        As.transpose(1, 2), As * rho[:, :, None])


def test_tf32x3_certificate_within_twice_float32():
    """The kernel's factorization product (three-pass TF32 split) in the
    16 cold Newton-Schulz sweeps on the MPC M: its certificate ||I - M X||
    stays within twice that of float32 sweeps, while one TF32 pass does
    not come near."""
    from cvxpygen_tpu_torch.solvers.admm import _ns_diag_start
    M = _mpc_M()
    X0 = _ns_diag_start(M)
    c32 = ns_cert(M, _sweeps(M, X0, 16, torch.matmul))
    c3 = ns_cert(M, _sweeps(M, X0, 16, tf32x3_matmul), tf32x3_matmul)
    c3_f32 = ns_cert(M, _sweeps(M, X0, 16, tf32x3_matmul))
    assert float(c32.max()) < 1e-4
    assert float(c3.max()) <= 2 * float(c32.max())
    assert float(c3_f32.max()) <= 2 * float(c32.max())

    def tf32_once(a, b):
        from cvxpygen_tpu_torch.ops.admm_full_kernel import _tf32
        return torch.matmul(_tf32(a), _tf32(b))

    c1 = ns_cert(M, _sweeps(M, X0, 16, tf32_once))
    assert float(c1.max()) > 100 * float(c32.max())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_tf32x3_plain_matches_interpret_kernel(seed):
    """The plain version with the kernel's three-pass TF32 product in its
    factorization, in float32, against the Pallas kernel in interpret mode
    on the same float32 data: the same status and iterations, at eps 1e-3
    with adaptive rho off.  Tighter, or with adaptive rho on, float32
    roundoff alone moves this family's iterations: the plain version at
    full float32 then differs from the reference too, and so does the
    reference from itself with the host's thread count."""
    args = [np.asarray(a, np.float32) for a in _scaled_inputs(seed=seed)]
    kw = dict(_kernel_kw(40, adaptive=False), eps_abs=1e-3, eps_rel=1e-3)
    ref = admm_solve_full_pallas(*[jnp.asarray(a) for a in args], **kw,
                                 block=2, interpret=True)
    out = admm_solve_full_plain(*[torch.tensor(a) for a in args], **kw,
                                block=2, matmul=tf32x3_matmul)
    assert out[0].dtype == torch.float32
    assert np.all(out[5].numpy() == 1)
    assert np.array_equal(np.asarray(ref[5]), out[5].numpy())
    assert np.array_equal(np.asarray(ref[4]), out[4].numpy())
