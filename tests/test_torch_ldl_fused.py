"""The plain versions of kernels K9 and K10 (cvxpygen_tpu_torch/ops/
ldl_kernel.py: ldl_factor_inverse_plain, ldl_kinv_plain) against the JAX
package's fused factor + inverse Pallas kernels in interpret mode, float64,
and the fused kernel's layout rule.  The conic IPM's routes through them
are held to the JAX package's IPM in tests/test_torch_ipm.py, beside the
one compile of its reference solve."""
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from cvxpygen_tpu.ops.ldl_kernel import (ldl_factor_inverse_pallas,
                                         ldl_kinv_pallas)
from cvxpygen_tpu_torch.ops import ldl_kernel

TOL = 1e-9
DD = float(np.finfo(np.float32).eps) ** 0.5 * 0.1


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _kkt(B, n, mc, seed):
    """tests/test_ldl.py's well-conditioned quasidefinite KKT batch
    [[I, -G'], [-G, -H]] with its pivot signs."""
    rng = np.random.default_rng(seed)
    N = n + mc
    G = rng.standard_normal((B, mc, n))
    Hs = rng.standard_normal((B, mc, mc)) * 0.3
    H = np.einsum('bij,bkj->bik', Hs, Hs) + np.eye(mc)
    K = np.zeros((B, N, N))
    K[:, :n, :n] = np.eye(n)
    K[:, :n, n:] = -np.swapaxes(G, 1, 2)
    K[:, n:, :n] = -G
    K[:, n:, n:] = -H
    return K, np.concatenate([np.ones(n), -np.ones(mc)])


# (B, n, mc, seed): tests/test_ldl.py's two shapes, N = 24 and 21, both
# padded to Np = 32 with an identity tail
SHAPES = [(4, 10, 14, 11), (5, 9, 12, 13)]
KERNELS = {
    'K9': (ldl_kernel.ldl_factor_inverse_plain, ldl_factor_inverse_pallas),
    'K10': (ldl_kernel.ldl_kinv_plain, ldl_kinv_pallas),
}


@pytest.mark.parametrize('shape', SHAPES, ids=['N24', 'N21'])
@pytest.mark.parametrize('name', ['K9', 'K10'])
def test_plain_version_matches_interpret_kernel(name, shape):
    """The plain version against the Pallas kernel in interpret mode
    (block_b=4, so B=5 pads the reference's batch), float64: within 1e-9
    of max(1, |Kinv|), and K Kinv within 1e-9 of the identity."""
    B, n, mc, seed = shape
    K, signs = _kkt(B, n, mc, seed)
    plain, pallas = KERNELS[name]
    ref = jax.jit(functools.partial(pallas, signs=signs, dyn_delta=DD,
                                    block_b=4, interpret=True))(
        jnp.asarray(K))
    got = plain(torch.tensor(K), signs, DD).numpy()
    assert got.shape == K.shape
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                               atol=TOL * max(1.0, float(np.abs(ref).max())))
    R = np.eye(K.shape[1]) - np.einsum('bij,bjk->bik', K, got)
    assert np.abs(R).max() < TOL


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the K9 and K10 wrappers run their plain versions and
    leave their launch counts at 0; a tensor on another device raises."""
    K, signs = _kkt(3, 7, 13, 5)
    Kt = torch.tensor(K)
    for kern, plain in ((ldl_kernel.ldl_factor_inverse_kernel,
                         ldl_kernel.ldl_factor_inverse_plain),
                        (ldl_kernel.ldl_kinv_kernel,
                         ldl_kernel.ldl_kinv_plain)):
        monkeypatch.setattr(kern, 'launches', 0)
        assert torch.equal(kern(Kt, signs, DD), plain(Kt, signs, DD))
        assert kern.launches == 0
        with pytest.raises(TypeError, match='no kernel'):
            kern(Kt.to('meta'), signs, DD)
    # both compute the same function: the inverse of the regularized K
    np.testing.assert_allclose(
        ldl_kernel.ldl_factor_inverse_plain(Kt, signs, DD).numpy(),
        ldl_kernel.ldl_kinv_plain(Kt, signs, DD).numpy(), rtol=0, atol=1e-12)


# the fused kernel's layout by N (csrc/ldl_kinv.cu): the factor resident in
# shared memory (two blocks per SM at the entropy shape), else the factor
# and R in a device scratch
KINV_CASES = [(5, 5, 16, 'resident', 2), (21, 32, 32, 'resident', 2),
              (161, 176, 32, 'resident', 2), (321, 336, 32, 'scratch', 2),
              (801, 816, 32, 'scratch', 2), (1601, 1616, 32, 'scratch', 2)]


def _kinv_smem_words(N, Np, p, w, layout):
    """csrc/ldl_kinv.cu::smem_bytes in words, from its constants: 16 x 16
    tiles, R rows of w + 4, Z (16 x w), K7's stages of 256 rows at stride
    20, parts rounded to 16-byte lines."""
    def r4(n):
        return -(-n // 4) * 4
    R, Z = Np * (w + 4), 16 * w
    if layout == 'resident':
        nbp = Np // p
        return nbp * (nbp + 1) // 2 * 256 + R + r4(Np * p) + r4(Np) + Z
    stage = r4(p * p + (min(Np - p, 256) * 20 if Np > p else 0))
    return Z + 2 * stage


@pytest.mark.parametrize('N,Np,width,layout,per_sm', KINV_CASES,
                         ids=[f'N{c[0]}' for c in KINV_CASES])
def test_kinv_layout_rule(N, Np, width, layout, per_sm):
    """kinv_layout against the C source's rule: K7's width (so that Kinv
    is bitwise K7's), the first layout whose block (dynamic memory plus the
    static pair of panel buffers, 2 x 4 x (256 + 16) bytes) fits the
    232,448-byte limit, its shared memory, its scratch per instance and the
    blocks an SM holds (233,472 bytes, 1 KB reserved per block; at most
    two by registers, the kernel's launch bound)."""
    lay = ldl_kernel.kinv_layout(N)
    p = min(16, N)
    assert (lay['p'], lay['Np'], lay['width'], lay['layout']) == (
        p, Np, width, layout)
    assert lay['width'] == ldl_kernel.inverse_plan(N)['width']
    assert lay['tiles'] == -(-N // width)
    static = 2 * 4 * (256 + 16)
    order = ldl_kernel.KINV_LAYOUTS
    for earlier in order[:order.index(layout)]:
        assert 4 * _kinv_smem_words(N, Np, p, width, earlier) + static > 232448
    assert lay['smem_bytes'] == 4 * _kinv_smem_words(N, Np, p, width, layout)
    assert lay['smem_bytes'] + static <= 232448
    nbp = Np // p
    factor = nbp * (nbp + 1) // 2 * 256 + -(-Np * p // 4) * 4 + -(-Np // 4) * 4
    assert lay['scratch_words'] == (
        0 if layout == 'resident' else factor + Np * (width + 4))
    assert lay['blocks_per_sm'] == per_sm == min(
        2, 233472 // (lay['smem_bytes'] + static + 1024))


def test_kinv_layout_has_a_launch_for_every_n():
    """Every N has a layout within the per-block limit, up to and beyond
    the parents' reach (the parent K9 ran to about Np = 3300, the parent
    K10 any N through its scratch), at K7's width."""
    static = 2 * 4 * (256 + 16)
    for N in list(range(1, 400)) + list(range(400, 4200, 37)):
        lay = ldl_kernel.kinv_layout(N)
        assert 0 < lay['smem_bytes'] <= 232448 - static
        assert lay['layout'] in ldl_kernel.KINV_LAYOUTS
        assert lay['width'] == ldl_kernel.inverse_plan(N)['width']


def test_k9_takes_no_group():
    """K9's wrapper lost the interleaving's ``group=`` (one fused kernel
    serves K9 and K10)."""
    K, signs = _kkt(2, 4, 5, 3)
    with pytest.raises(TypeError):
        ldl_kernel.ldl_factor_inverse_kernel(torch.tensor(K), signs, DD,
                                             group=8)
    assert not hasattr(ldl_kernel, 'FI_GROUP')


@pytest.mark.cuda
@pytest.mark.parametrize('N', [7, 21, 161])
def test_fused_kernel_is_k6_plus_k7_on_card(N):
    """On a card, K9 and K10 (one fused kernel) bitwise equal to K7 on K6's
    factor, both triangles, and within 1e-4 of max(1, |v|_inf) per
    instance of their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 12)')
    n = N // 2
    K, signs = _kkt(8, n, N - n, N)
    Kc = torch.tensor(K, dtype=torch.float32, device='cuda')
    k67 = ldl_kernel.ldl_inverse_kernel(
        ldl_kernel.ldl_factor_kernel(Kc, signs, DD))
    for kern, plain in ((ldl_kernel.ldl_factor_inverse_kernel,
                         ldl_kernel.ldl_factor_inverse_plain),
                        (ldl_kernel.ldl_kinv_kernel,
                         ldl_kernel.ldl_kinv_plain)):
        out = kern(Kc, signs, DD)
        assert torch.equal(out, k67)
        ref = plain(Kc, signs, DD).double().flatten(1)
        scale = torch.clamp(ref.abs().amax(dim=1), min=1.0)
        err = (out.double().flatten(1) - ref).abs().amax(dim=1) / scale
        assert float(err.max()) <= 1e-4
