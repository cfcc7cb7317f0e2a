"""The port's batched static-pivot LDL^T (cvxpygen_tpu_torch/ops/
ldl_batched.py) and the plain versions of kernels K6, K7 and K8
(ops/ldl_kernel.py) against the JAX package: its XLA lowering and its
Pallas kernels in interpret mode, float64."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from cvxpygen_tpu.ops import ldl_batched as ldl_ref
from cvxpygen_tpu.ops.ldl_kernel import (ldl_factor_pallas,
                                         ldl_inverse_pallas,
                                         ldl_solve_pallas)
from cvxpygen_tpu_torch.ops import ldl_batched, ldl_kernel

TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _quasidefinite(B, N, nblk, rng):
    """tests/test_ldl.py's quasidefinite batch: PD primal block, ND dual
    block, random coupling."""
    P = rng.standard_normal((B, nblk, nblk))
    K = np.zeros((B, N, N))
    K[:, :nblk, :nblk] = P @ np.swapaxes(P, 1, 2) + 1e-3 * np.eye(nblk)
    Bb = rng.standard_normal((B, N - nblk, nblk))
    K[:, nblk:, :nblk] = Bb
    K[:, :nblk, nblk:] = np.swapaxes(Bb, 1, 2)
    H = rng.standard_normal((B, N - nblk, N - nblk))
    K[:, nblk:, nblk:] = -(H @ np.swapaxes(H, 1, 2)
                           + 1e-3 * np.eye(N - nblk))
    signs = np.concatenate([np.ones(nblk), -np.ones(N - nblk)])
    return K, signs


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    scale = max(1.0, float(np.max(np.abs(b))))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize('N,nblk', [(23, 7), (37, 17)])
def test_ldl_batched_matches_jax(N, nblk):
    """ldl_factor / ldl_solve / ldl_inverse against the JAX package's
    XLA lowering (the (B, nbp, p, p) Linv layout)."""
    rng = np.random.default_rng(0)
    K, signs = _quasidefinite(4, N, nblk, rng)
    b = rng.standard_normal((4, N))

    @jax.jit
    def ref(K, b):
        fac = ldl_ref.ldl_factor(K, signs=signs)
        return fac, ldl_ref.ldl_solve(fac, b), ldl_ref.ldl_inverse(fac)

    fac_r, x_r, Kinv_r = ref(jnp.asarray(K), jnp.asarray(b))
    fac = ldl_batched.ldl_factor(torch.tensor(K), signs=signs)
    for key in ('L', 'd', 'Linv'):
        _close(fac[key], fac_r[key])
    assert (fac['panel'], fac['N'], fac['Np']) == (16, N, 16 * -(-N // 16))
    _close(ldl_batched.ldl_solve(fac, torch.tensor(b)), x_r)
    _close(ldl_batched.ldl_inverse(fac), Kinv_r)
    xe = np.linalg.solve(K, b[..., None])[..., 0]
    _close(ldl_batched.ldl_solve(fac, torch.tensor(b)), xe, 1e-8)


@pytest.mark.parametrize('N,nblk', [(21, 9), (41, 17)])
def test_kernel_plain_versions_match_pallas_interpret(N, nblk):
    """K6, K7 and K8's plain versions against ldl_factor_pallas,
    ldl_inverse_pallas and ldl_solve_pallas in interpret mode: B=5 (the
    Pallas wrappers pad the batch), quasidefinite signs, N padded to a
    multiple of the panel."""
    rng = np.random.default_rng(1)
    B = 5
    K, signs = _quasidefinite(B, N, nblk, rng)
    b = rng.standard_normal((B, N))
    dd = 1e-9

    @jax.jit
    def ref(K, b):
        fac = ldl_factor_pallas(K, signs=signs, dyn_delta=dd, block_b=4,
                                interpret=True)
        return (fac['L'], fac['d'], fac['Linv'],
                ldl_inverse_pallas(fac, block_b=4, interpret=True),
                ldl_solve_pallas(fac, b, block_b=4, interpret=True))

    L_r, d_r, V_r, Kinv_r, x_r = ref(jnp.asarray(K), jnp.asarray(b))
    fac = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, dd)
    assert fac['Linv'].shape == V_r.shape
    _close(fac['L'], L_r)
    _close(fac['d'], d_r)
    _close(fac['Linv'], V_r)
    _close(ldl_kernel.ldl_inverse_plain(fac), Kinv_r)
    _close(ldl_kernel.ldl_solve_plain(fac, torch.tensor(b)), x_r)


def test_tiny_pivots_refinable():
    """tests/test_ldl.py:39-55: with a nearly zero primal block the
    dynamically regularized factor is a contraction for refinement against
    the true K; the port's factor equals the JAX package's."""
    rng = np.random.default_rng(1)
    B, N, nblk = 2, 24, 8
    K, signs = _quasidefinite(B, N, nblk, rng)
    K[:, :nblk, :nblk] *= 1e-7
    b = rng.standard_normal((B, N))
    fac = ldl_kernel.ldl_factor_kernel(torch.tensor(K), signs, 1e-6)
    fac_r = jax.jit(lambda K: ldl_ref.ldl_factor(K, signs=signs,
                                                 dyn_delta=1e-6))(
        jnp.asarray(K))
    _close(fac['d'], fac_r['d'])
    x = ldl_kernel.ldl_solve_kernel(fac, torch.tensor(b)).numpy()
    for _ in range(5):
        r = b - np.einsum('bij,bj->bi', K, x)
        x = x + ldl_kernel.ldl_solve_kernel(fac, torch.tensor(r)).numpy()
    resid = b - np.einsum('bij,bj->bi', K, x)
    assert np.max(np.abs(resid)) < 1e-8


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the wrappers run the plain versions and leave their
    launch counts at 0; a tensor on another device raises."""
    for w in (ldl_kernel.ldl_factor_kernel, ldl_kernel.ldl_inverse_kernel,
              ldl_kernel.ldl_solve_kernel):
        monkeypatch.setattr(w, 'launches', 0)
    rng = np.random.default_rng(4)
    K, signs = _quasidefinite(3, 20, 6, rng)
    b = rng.standard_normal((3, 20))
    Kt, bt = torch.tensor(K), torch.tensor(b)
    fac = ldl_kernel.ldl_factor_kernel(Kt, signs, 1e-9)
    fac_p = ldl_kernel.ldl_factor_plain(Kt, signs, 1e-9)
    for key in ('L', 'd', 'Linv'):
        assert torch.equal(fac[key], fac_p[key])
    assert torch.equal(ldl_kernel.ldl_inverse_kernel(fac),
                       ldl_kernel.ldl_inverse_plain(fac_p))
    assert torch.equal(ldl_kernel.ldl_solve_kernel(fac, bt),
                       ldl_kernel.ldl_solve_plain(fac_p, bt))
    assert [w.launches for w in (ldl_kernel.ldl_factor_kernel,
                                 ldl_kernel.ldl_inverse_kernel,
                                 ldl_kernel.ldl_solve_kernel)] == [0, 0, 0]
    with pytest.raises(TypeError, match='no kernel'):
        ldl_kernel.ldl_factor_kernel(Kt.to('meta'), signs, 1e-9)


def test_small_n_panel_and_padding():
    """N below the panel makes the panel N (no padding); the factor of a
    padded N carries the identity tail."""
    rng = np.random.default_rng(5)
    K, signs = _quasidefinite(2, 7, 3, rng)
    fac = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, 1e-9)
    assert (fac['panel'], fac['Np'], tuple(fac['Linv'].shape)) == (7, 7,
                                                                   (2, 7, 7))
    K, signs = _quasidefinite(2, 18, 6, rng)
    fac = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, 1e-9)
    assert fac['Np'] == 32
    assert torch.equal(fac['d'][:, 18:], torch.ones(2, 14, dtype=torch.float64))
    assert torch.equal(fac['L'][:, 18:, 18:],
                       torch.eye(14, dtype=torch.float64).expand(2, 14, 14))


# ---------------------------------------------------------------------------
# kernel K6's layout (csrc/ldl_factor.cu)
# ---------------------------------------------------------------------------

def _tile_ij(q):
    """csrc/ldl_factor.cu::tile_ij: the float32 estimate, then the integer
    correction."""
    i = int((np.sqrt(np.float32(8 * q + 1), dtype=np.float32)
             - np.float32(1)) * np.float32(0.5))
    while (i + 1) * (i + 2) // 2 <= q:
        i += 1
    while i * (i + 1) // 2 > q:
        i -= 1
    return i, q - i * (i + 1) // 2


@pytest.mark.parametrize('N,Np,resident,per_sm', [(16, 16, True, 8),
                                                  (161, 176, True, 3),
                                                  (321, 336, False, 8)])
def test_factor_layout_rule(N, Np, resident, per_sm):
    """K6's tiles of the lower triangle: row-order offsets that cover the
    tiles once, back to back, and the kernel's q -> (I, J) map; the
    shared-memory path where the tiles fit (three blocks per SM at the
    entropy shape) and the device scratch at the n = 64 twin."""
    lay = ldl_kernel.factor_layout(N)
    nbp = Np // 16
    assert (lay['p'], lay['Np'], lay['nbp']) == (16, Np, nbp)
    assert lay['tiles'] == nbp * (nbp + 1) // 2
    # the kernel's row-order offsets, csrc/ldl_factor.cu::tile
    offs = [(I * (I + 1) // 2 + J) * 256 for I in range(nbp)
            for J in range(I + 1)]
    assert offs == [256 * q for q in range(lay['tiles'])]
    assert [_tile_ij(q) for q in range(lay['tiles'])] == [
        (I, J) for I in range(nbp) for J in range(I + 1)]
    # the kernel's swizzle of a tile's 16-byte chunks is a permutation
    sw = [r * 16 + ((((c >> 2) ^ (r >> 2)) & 3) << 2) + (c & 3)
          for r in range(16) for c in range(16)]
    assert sorted(sw) == list(range(256))
    assert lay['resident'] is resident
    assert lay['smem_bytes'] == (4 * lay['tile_words'] if resident else 0)
    assert lay['blocks_per_sm'] == per_sm


def _factor_tiled(K, signs, dd, p=16):
    """csrc/ldl_factor.cu's schedule on 16 x 16 tiles of the lower triangle
    (one instance, float64): the panel's elimination in the tile, L21 =
    A21 Minv in place, the trailing update of the lower tiles only, then L
    assembled from the tiles.  Returns L, d, Linv."""
    N = K.shape[0]
    nbp = -(-N // p)
    Np = nbp * p
    Kp = torch.eye(Np, dtype=K.dtype)
    Kp[:N, :N] = K
    sg = np.concatenate([signs, np.ones(Np - N)])
    tiles = {(I, J): Kp[I * p:I * p + p, J * p:J * p + p].clone()
             for I in range(nbp) for J in range(I + 1)}
    for I in range(nbp):
        tiles[I, I] = torch.tril(tiles[I, I])
    d = torch.zeros(Np, dtype=K.dtype)
    V = torch.zeros((Np, p), dtype=K.dtype)
    for k in range(nbp):
        T = tiles[k, k]
        dk = torch.zeros(p, dtype=K.dtype)
        for j in range(p):
            v = float(sg[k * p + j]) * T[j, j]
            dj = float(sg[k * p + j]) * (dd if v < dd else v)
            dk[j] = dj
            cr = T[:, j] / dj
            for r in range(j + 1, p):
                T[r, j + 1:r + 1] -= dj * cr[r] * cr[j + 1:r + 1]
            T[j + 1:, j] = cr[j + 1:]
            T[j, j] = 1.0
        X = torch.eye(p, dtype=K.dtype)
        for j in range(p):
            X[j + 1:] -= T[j + 1:, j:j + 1] * X[j]
        d[k * p:k * p + p] = dk
        V[k * p:k * p + p] = X
        minv = X.T / dk[None, :]
        for I in range(k + 1, nbp):
            tiles[I, k] = tiles[I, k] @ minv
        for I in range(k + 1, nbp):
            for J in range(k + 1, I + 1):
                upd = (tiles[I, k] * dk) @ tiles[J, k].T
                tiles[I, J] -= torch.tril(upd) if I == J else upd
    L = torch.zeros((Np, Np), dtype=K.dtype)
    for (I, J), T in tiles.items():
        L[I * p:I * p + p, J * p:J * p + p] = T
    return L, d, V


@pytest.mark.parametrize('N,nblk', [(12, 5), (40, 17)])
def test_tiled_factor_matches_plain(N, nblk):
    """K6's tile schedule gives ldl_factor_plain's L, d and Linv, float64
    (one panel at N=12, three at N=40)."""
    rng = np.random.default_rng(7)
    K, signs = _quasidefinite(2, N, nblk, rng)
    ref = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, 1e-9)
    for b in range(2):
        L, d, V = _factor_tiled(torch.tensor(K[b]), signs, 1e-9,
                                p=min(16, N))
        _close(L, ref['L'][b])
        _close(d, ref['d'][b])
        _close(V, ref['Linv'][b])


@pytest.mark.cuda
@pytest.mark.parametrize('N', [7, 12, 40, 161])
def test_factor_kernel_matches_plain_on_card(N):
    """On a card, K6 against its plain version on a quasidefinite batch:
    L, d and Linv within 1e-4 of max(1, |v|_inf) per instance."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 10)')
    K, signs = _quasidefinite(5, N, N // 3, np.random.default_rng(N))
    Kc = torch.tensor(K, dtype=torch.float32, device='cuda')
    fac = ldl_kernel.ldl_factor_kernel(Kc, signs, 1e-4)
    ref = ldl_kernel.ldl_factor_plain(Kc, signs, 1e-4)
    for key in ('L', 'd', 'Linv'):
        a, r = fac[key].double().flatten(1), ref[key].double().flatten(1)
        scale = torch.clamp(r.abs().amax(dim=1), min=1.0)
        assert float(((a - r).abs().amax(dim=1) / scale).max()) <= 1e-4, key


@pytest.mark.cuda
@pytest.mark.parametrize('N', [10, 40])
def test_factor_kernel_rounds_panel_steps_like_plain_on_card(N):
    """On a card, K6 on pairs (a, b) with a + b small, the pattern of the
    ADP family's Schur complement: a panel step's (d_j c_r) c_c is rounded
    before it is subtracted, as the plain version rounds it, so the pivot
    a - b^2 / a keeps the plain version's bits (an fmaf would keep c_r's
    rounding error).  One panel at N=10; at N=40 the pairs fall inside
    each panel."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 12)')
    rng = np.random.default_rng(N)
    B = 256
    K = np.zeros((B, N, N))
    for i in range(0, N - 1, 4):
        a = rng.uniform(1e4, 1e5, B)
        b = -(a - rng.uniform(0.01, 2.0, B))
        K[:, i, i] = K[:, i + 1, i + 1] = a
        K[:, i, i + 1] = K[:, i + 1, i] = b
    idx = np.arange(N)
    K[:, idx, idx] = np.where(K[:, idx, idx] == 0, 6.0, K[:, idx, idx])
    Kc = torch.tensor(K, dtype=torch.float32, device='cuda')
    signs = np.ones(N)
    fac = ldl_kernel.ldl_factor_kernel(Kc, signs, 1e-4)
    ref = ldl_kernel.ldl_factor_plain(Kc, signs, 1e-4)
    assert torch.equal(fac['d'], ref['d'])


# ---------------------------------------------------------------------------
# kernel K7's plan and schedule (csrc/ldl_inverse.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('N,Np,p,width,tiles,resident', [
    (7, 7, 7, 16, 1, True), (161, 176, 16, 32, 6, True),
    (321, 336, 16, 32, 11, True), (801, 816, 16, 32, 26, True),
    (1296, 1296, 16, 32, 41, True), (1297, 1312, 16, 32, 41, False),
    (3700, 3712, 16, 32, 116, False)])
def test_inverse_plan_rule(N, Np, p, width, tiles, resident):
    """K7's plan: one tile of 16 below the panel (N=7), tiles of 32 above;
    the tile's right-hand block in shared memory up to Np = 1296 and in a
    device scratch above, so that every N has a launch (the first design
    took Np up to about 3600); a stage holds at most 256 rows of L, so the
    shared memory of the kernel's layout fits the per-block limit at every
    width; a width the kernel does not take is refused."""
    plan = ldl_kernel.inverse_plan(N)
    assert (plan['p'], plan['Np'], plan['width'], plan['tiles'],
            plan['resident']) == (p, Np, width, tiles, resident)
    for w in (16, 32):
        pw = ldl_kernel.inverse_plan(N, width=w)
        stage = p * p + (min(Np - p, 256) * 20 if Np > p else 0)
        stage = -(-stage // 4) * 4
        rows = Np * (w + 4) if pw['resident'] else 0
        assert pw['smem_bytes'] == 4 * (rows + 16 * w + 2 * stage)
        assert pw['smem_bytes'] <= 232448
        assert pw['resident'] == (4 * (Np * (w + 4) + 16 * w + 2 * stage)
                                  <= 232448)
        assert pw['scratch_words'] == (0 if pw['resident'] else
                                       pw['tiles'] * Np * (w + 4))
    for w in (48, 64):
        with pytest.raises(ValueError, match='width'):
            ldl_kernel.inverse_plan(N, width=w)


def _inverse_tiled(fac, b, width, chunk=256):
    """csrc/ldl_inverse.cu's schedule for one instance (float64): per tile
    of ``width`` columns from j0, the forward sweep from panel j0 / p, the
    diagonal and the backward sweep down to that panel over the rows from
    j0 only, each panel's block of L applied ``chunk`` rows (columns) at a
    time; the lower triangle from the tiles and the upper one as its
    transpose."""
    L, d, V = fac['L'][b], fac['d'][b], fac['Linv'][b]
    p, N, Np = fac['panel'], fac['N'], fac['Np']
    nbp = Np // p
    Kinv = torch.full((N, N), float('nan'), dtype=L.dtype)
    for j0 in range(0, N, width):
        k0, lo = j0 // p, j0 // p * p
        R = torch.zeros((Np, width), dtype=L.dtype)
        for c in range(width):
            if j0 + c < Np:
                R[j0 + c, c] = 1.0
        for k in range(k0, nbp):
            o = k * p
            R[o:o + p] = V[o:o + p] @ R[o:o + p]
            for r in range(o + p, Np, chunk):
                e = min(r + chunk, Np)
                R[r:e] -= L[r:e, o:o + p] @ R[o:o + p]
        R[lo:] /= d[lo:, None]
        for k in reversed(range(k0, nbp)):
            o = k * p
            R[o:o + p] = V[o:o + p].T @ R[o:o + p]
            for r in range(lo, o, chunk):
                e = min(r + chunk, o)
                R[r:e] -= L[o:o + p, r:e].T @ R[o:o + p]
        wn = min(width, N - j0)
        Kinv[lo:N, j0:j0 + wn] = R[lo:N, :wn]
        Kinv[j0:j0 + wn, j0 + width:N] = R[j0 + width:N, :wn].T
    return Kinv


@pytest.mark.parametrize('N,nblk,width,chunk', [(7, 3, 16, 256),
                                                (40, 13, 16, 256),
                                                (40, 13, 32, 256),
                                                (70, 30, 32, 16)])
def test_inverse_schedule_matches_plain(N, nblk, width, chunk):
    """K7's schedule (exact zeros skipped, the lower triangle computed, the
    upper one mirrored, L applied in chunks: at N=70 chunks of 16 stand in
    for the kernel's 256 above Np = 272) gives ldl_inverse_plain's Kinv,
    float64, and covers every entry once."""
    K, signs = _quasidefinite(2, N, nblk, np.random.default_rng(N + width))
    fac = ldl_kernel.ldl_factor_plain(torch.tensor(K), signs, 1e-9)
    ref = ldl_kernel.ldl_inverse_plain(fac)
    for b in range(2):
        _close(_inverse_tiled(fac, b, width, chunk), ref[b], tol=1e-9)


def _well_conditioned(B, n, m, rng):
    """A quasidefinite batch with singular values near 1 at any size:
    [[A A' / n + I, C' / sqrt(n)], [C / sqrt(n), -I]]."""
    A = rng.standard_normal((B, n, n))
    C = rng.standard_normal((B, m, n)) / np.sqrt(n)
    K = np.zeros((B, n + m, n + m))
    K[:, :n, :n] = A @ np.swapaxes(A, 1, 2) / n + np.eye(n)
    K[:, n:, :n] = C
    K[:, :n, n:] = np.swapaxes(C, 1, 2)
    K[:, n:, n:] = -np.eye(m)
    return K, np.concatenate([np.ones(n), -np.ones(m)])


@pytest.mark.cuda
@pytest.mark.parametrize('N', [7, 40, 161, 801, 1601])
def test_inverse_kernel_matches_plain_on_card(N):
    """On a card, K7 at both tile widths against its plain version on K6's
    factor (1e-4 of max(1, |v|_inf) per instance); the widths agree to the
    bit on the lower triangle, and a second call is bitwise equal.  N=801
    applies L in chunks; N=1601 keeps R in the device scratch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the card: chip_smoke.py phase 10)')
    rng = np.random.default_rng(N)
    if N <= 161:
        K, signs = _quasidefinite(5, N, N // 3, rng)
    else:
        K, signs = _well_conditioned(2, N // 2, N - N // 2, rng)
    Kc = torch.tensor(K, dtype=torch.float32, device='cuda')
    fac = ldl_kernel.ldl_factor_kernel(Kc, signs, 1e-4)
    ref = ldl_kernel.ldl_inverse_plain(fac).double().flatten(1)
    lower = torch.tril(torch.ones(N, N, dtype=torch.bool, device='cuda'))
    first = ldl_kernel.ldl_inverse_kernel(fac)
    assert torch.equal(ldl_kernel.ldl_inverse_kernel(fac), first)
    for w in (16, 32):
        out = ldl_kernel._inverse_launch(fac, w)
        a = out.double().flatten(1)
        scale = torch.clamp(ref.abs().amax(dim=1), min=1.0)
        assert float(((a - ref).abs().amax(dim=1) / scale).max()) <= 1e-4
        assert torch.equal(out[:, lower], first[:, lower])
