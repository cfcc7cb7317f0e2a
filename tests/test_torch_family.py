"""runtime/torch_family.py against the JAX package's runtime/jax_family.py:
canonicalization of a theta batch with one GEMM, in the dense and the
scatter map layouts, float64 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from problems import MPC_problem, assign_MPC, nonneg_LS_problem, \
    assign_nonneg_LS
from cvxpygen_tpu.canon.canonicalizer import canonicalize
from cvxpygen_tpu.runtime.jax_family import (JaxFamily, canon_batch as
                                             canon_batch_ref,
                                             canon_batch_shared as
                                             canon_batch_shared_ref,
                                             qp_bounds_batch as
                                             qp_bounds_batch_ref)
from cvxpygen_tpu_torch.canon.canonicalizer import (family_from_arrays,
                                                    family_to_arrays)
from cvxpygen_tpu_torch.runtime.torch_family import (TorchFamily, canon_batch,
                                                     canon_batch_shared,
                                                     qp_bounds_batch,
                                                     resolve_device)


def _mpc_batch(B=5, seed=3):
    prob = assign_MPC(MPC_problem(H=3), seed=0)
    fam = canonicalize(prob)
    base = fam.pack_theta(params=prob.parameters())
    xi = [pi for pi in fam.param_info if pi.name == 'x_init'][0]
    theta = np.tile(base, (B, 1))
    theta[:, xi.offset:xi.offset + xi.flat_size] = \
        np.random.default_rng(seed).uniform(-2, 2, (B, xi.flat_size))
    return fam, theta


def _nonneg_ls_batch(B=4, seed=5):
    prob = assign_nonneg_LS(nonneg_LS_problem(), seed=1)
    fam = canonicalize(prob)
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((B, fam.p))
    return fam, theta


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize('force_scatter', [False, True])
@pytest.mark.parametrize('make', [_mpc_batch, _nonneg_ls_batch])
def test_canon_batch_matches_reference(make, force_scatter):
    fam_ref, theta = make()
    fam = family_from_arrays(family_to_arrays(fam_ref))
    jf = JaxFamily.from_family(fam_ref, force_scatter=force_scatter)
    tf = TorchFamily.from_family(fam, device='cpu',
                                 force_scatter=force_scatter)
    assert tf.maps.dtype == torch.float64
    assert tf.dense_mode == jf.dense_mode
    ref = canon_batch_ref(jf, jnp.asarray(theta))
    out = canon_batch(tf, torch.as_tensor(theta))
    for k in ('P', 'q', 'd', 'A', 'b'):
        _close(ref[k], out[k])
    l_ref, u_ref = qp_bounds_batch_ref(jf, ref['b'])
    l, u = qp_bounds_batch(tf, out['b'])
    _close(l_ref, l)
    _close(u_ref, u)


@pytest.mark.parametrize('force_scatter', [False, True])
def test_canon_batch_shared_matches_reference(force_scatter):
    fam_ref, theta = _mpc_batch()
    fam = family_from_arrays(family_to_arrays(fam_ref))
    jf = JaxFamily.from_family(fam_ref, force_scatter=force_scatter)
    tf = TorchFamily.from_family(fam, device='cpu',
                                 force_scatter=force_scatter)
    ref = canon_batch_shared_ref(jf, jnp.asarray(theta))
    out = canon_batch_shared(tf, theta)     # a NumPy batch is accepted too
    assert out['P'].shape == (fam.n, fam.n)
    assert out['A'].shape == (fam.m, fam.n)
    for k in ('P', 'q', 'd', 'A', 'b'):
        _close(ref[k], out[k])


def test_device_rule(monkeypatch):
    """CUDA unless the caller names a device; no silent CPU fallback."""
    assert resolve_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    fam_ref, _ = _mpc_batch()
    with pytest.raises(RuntimeError):
        TorchFamily.from_family(family_from_arrays(family_to_arrays(fam_ref)))
