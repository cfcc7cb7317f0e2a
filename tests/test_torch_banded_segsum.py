"""The banded solvers' order-fixed segment sum (cvxpygen_tpu_torch
solvers/admm_banded.py: ``seg_table``, ``_seg_sum``, ``assemble_banded_M``)
against ``index_add_`` and the JAX package's ``jax.ops.segment_sum``,
float64 on the CPU, the same inputs made with numpy for both; and, on a
card, two float32 set-ups of one batch held bitwise equal."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

import cvxpygen_tpu as ct_ref
from test_torch_banded import assign_charging, charging_problem
from cvxpygen_tpu.canon.canonicalizer import canonicalize as canon_ref
from cvxpygen_tpu.solvers import admm_banded as banded_ref
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.solvers.admm_banded import (_seg_sum,
                                                    assemble_banded_M,
                                                    banded_index,
                                                    build_banded_structure,
                                                    seg_table)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """One BLAS/OpenMP thread per test (several worker processes share the
    cores)."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope='module')
def charging():
    fam_ref = canon_ref(assign_charging(charging_problem(ct_ref)))
    fam = family_from_arrays(family_to_arrays(fam_ref))
    st = build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m)
    st_ref = banded_ref.build_banded_structure(fam_ref.P_idx, fam_ref.A_idx,
                                               fam_ref.n, fam_ref.m)
    return st, st_ref


@pytest.mark.parametrize('seed', [0, 1])
def test_seg_sum_matches_index_add_and_reference(seed):
    """Random ids over 40 segments, about a quarter of them empty; the
    gather table built on the fly and the one built beforehand give the
    same sums."""
    rng = np.random.default_rng(seed)
    num, K, B = 40, 120, 3
    ids = rng.choice(rng.permutation(num)[:30], K)
    vals = rng.standard_normal((B, K))
    out = _seg_sum(torch.tensor(vals), torch.tensor(ids), num)
    tab = torch.tensor(seg_table(ids, num))
    assert torch.equal(out, _seg_sum(torch.tensor(vals), None, num, tab))
    ref_add = torch.zeros((B, num), dtype=torch.float64).index_add_(
        1, torch.tensor(ids), torch.tensor(vals))
    ref_jax = banded_ref._seg_sum(jnp.asarray(vals), jnp.asarray(ids), num)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref_add.numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_jax), rtol=0,
                               atol=1e-13)
    empty = np.setdiff1d(np.arange(num), ids)
    assert len(empty) >= 10 and not out[:, empty].any()


def test_seg_table_layout():
    """Rows list each segment's positions in ascending order, padded with
    the zero column's position; ids >= num are left out."""
    tab = seg_table([2, 0, 2, 5, 2, 0], 3)
    assert tab.tolist() == [[1, 5, 6], [6, 6, 6], [0, 2, 4]]
    assert seg_table([], 2).tolist() == [[0], [0]]


def test_assemble_banded_M_matches_reference(charging):
    """M = P + sigma I + A' diag(rho) A in banded (D, L) blocks on the
    charging family of test_torch_banded.py, from random values, against
    the JAX package's assembly; the tables are sized by the structure."""
    st, st_ref = charging
    rng = np.random.default_rng(3)
    B = 3
    pvals = rng.uniform(0.5, 2.0, (B, len(st.p_row)))
    avals = rng.standard_normal((B, len(st.a_row)))
    rho = rng.uniform(0.1, 10.0, (B, st.m))
    ix = banded_index(st, 'cpu')
    assert [t.shape[1] for t in (ix.m_table, ix.av_table, ix.atv_table,
                                 ix.pv_table)] == [5, 3, 4, 1]
    D, L = assemble_banded_M(st, torch.tensor(pvals), torch.tensor(avals),
                             torch.tensor(rho), 1e-6, torch.float64, ix)
    D_ref, L_ref = banded_ref.assemble_banded_M(
        st_ref, jnp.asarray(pvals), jnp.asarray(avals), jnp.asarray(rho),
        1e-6, jnp.float64)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_ref), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), rtol=0,
                               atol=1e-12)


@pytest.mark.cuda
def test_two_setups_bitwise_equal_on_card(charging):
    """On a card, two float32 assemblies of one M and two per-instance
    matvec sums give bitwise equal results (the segment sums take no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 13)')
    st, _ = charging
    rng = np.random.default_rng(4)
    B = 64
    f32 = dict(dtype=torch.float32, device='cuda')
    pvals = torch.tensor(rng.uniform(0.5, 2.0, (B, len(st.p_row))), **f32)
    avals = torch.tensor(rng.standard_normal((B, len(st.a_row))), **f32)
    rho = torch.tensor(rng.uniform(0.1, 10.0, (B, st.m)), **f32)
    ix = banded_index(st, 'cuda')
    runs = [assemble_banded_M(st, pvals, avals, rho, 1e-6, torch.float32, ix)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    y = torch.tensor(rng.standard_normal((B, st.m)), **f32)
    sums = [_seg_sum(avals * y[:, ix.a_row], ix.a_col, st.n_pad,
                     ix.atv_table) for _ in range(2)]
    assert torch.equal(*sums)
