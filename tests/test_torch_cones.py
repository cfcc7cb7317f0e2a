"""ops/cones.py's torch projections (cvxpygen_tpu_torch) against the JAX
package's jnp ones, float64, on a mixed layout: nonneg, SOC(4), three exp
cones, a power cone (alpha 0.3) and PSD(3)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cvxpygen_tpu.ops import cones as cones_ref
from cvxpygen_tpu_torch.ops import cones

_LAYOUT = dict(n_nonneg=3, socs=(4,), n_exp=3, psds=(3,), pows=(0.3,))


def _inputs(B=64, seed=0):
    """Rows spread over every case of each projection: random normal
    vectors, scaled ones, and rows already inside K or its polar."""
    layout = cones.ConeLayout(**_LAYOUT)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, layout.total))
    v[B // 4:B // 2] *= 1e3
    v[B // 2:3 * B // 4] *= 1e-3
    inside = cones.project_cone(torch.tensor(v[-8:]), layout).numpy()
    v[-8:-4] = inside[:4]
    v[-4:] = -inside[4:]
    return v, layout


_FNS = ('project_cone', 'project_dual_cone', 'in_dual_cone_violation')


@pytest.fixture(scope='module')
def reference():
    """The JAX package's three functions on the inputs, under one jax.jit
    (called eagerly, JAX compiles each operation of the bisections one by
    one)."""
    v, _ = _inputs()
    lay = cones_ref.ConeLayout(**_LAYOUT)
    outs = jax.jit(lambda v: [getattr(cones_ref, fn)(v, lay)
                              for fn in _FNS])(jnp.asarray(v))
    return dict(zip(_FNS, (np.asarray(o) for o in outs)))


@pytest.mark.parametrize('fn', _FNS)
def test_projections_match_reference(reference, fn):
    v, layout = _inputs()
    ref = reference[fn]
    out = getattr(cones, fn)(torch.tensor(v), layout).numpy()
    scale = np.maximum(1.0, np.abs(v).max(axis=-1))
    if out.ndim == 2:
        scale = scale[:, None]
    assert np.all(np.abs(out - ref) / scale <= 1e-10), \
        float(np.max(np.abs(out - ref) / scale))


def test_projection_is_idempotent_and_matches_numpy_twin():
    v, layout = _inputs(B=16, seed=1)
    out = cones.project_cone(torch.tensor(v), layout)
    again = cones.project_cone(out, layout)
    np.testing.assert_allclose(again.numpy(), out.numpy(), rtol=0,
                               atol=1e-9 * max(1.0, np.abs(v).max()))
    for i in range(4):
        np.testing.assert_allclose(
            out[i].numpy(), cones.project_cone_np(v[i], layout), rtol=0,
            atol=1e-7)
