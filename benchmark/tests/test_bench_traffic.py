"""The one generator: pools repeat for a seed, differ across seeds, pack as
the package packs one instance, follow the source's assign function, and
take the routes the mixes are for."""
import math

import numpy as np
import pytest
import torch

from harness import generate, spec
from harness.port import Port

CPU = torch.device('cpu')
CELLS = [w['name'] for w in spec.benchmark()['workloads']]


def _pool(name, seed, batch=6, pool=3):
    c = spec.Cell(name)
    return c, generate.make_pool(c, seed, CPU, batch, pool)


@pytest.mark.parametrize('name', CELLS)
def test_pool_repeats_for_a_seed_and_differs_across_seeds(name):
    _, a = _pool(name, 2 ** 31 + 77)
    _, b = _pool(name, 2 ** 31 + 77)
    _, c = _pool(name, 2 ** 31 + 78)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['x_init'], c['x_init'])


@pytest.mark.parametrize('name', CELLS)
def test_pack_matches_the_family_layout(name):
    c, values = _pool(name, 9)
    port = Port(c, CPU)
    theta = port.pack(values)
    fam = port.family
    for k, r in ((0, 0), (2, 5)):
        one = {n: v[0].numpy() for n, v in
               generate.rows(values, k, torch.tensor([r])).items()}
        want = fam.pack_theta(values=one)
        np.testing.assert_allclose(theta[k, r].double().numpy(), want,
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('name', CELLS)
def test_mix_takes_its_route(name):
    c, values = _pool(name, 3, batch=16)
    port = Port(c, CPU)
    theta = port.pack(values)
    assert all(port.route(theta[k]) == c.traffic['route']
               for k in range(theta.shape[0]))


def test_mpc_values_follow_assign_mpc():
    """tests/test_E2E_QP.py's assign_MPC, with the sampling time drawn."""
    c, v = _pool('mpc_h10.per_instance_dyn', 4, batch=7, pool=2)
    a_cont = np.zeros((6, 6))
    a_cont[:3, 3:] = np.eye(3)
    b_cont = np.concatenate((np.zeros((3, 3)), np.eye(3)))
    for k, r in ((0, 0), (1, 6)):
        one = {n: t[0].double().numpy() for n, t in
               generate.rows(v, k, torch.tensor([r])).items()}
        td = one['B'][3, 0]
        assert 0.05 <= td <= 0.15
        np.testing.assert_allclose(one['A'], np.eye(6) + td * a_cont,
                                   rtol=1e-6)
        np.testing.assert_allclose(one['B'], td * b_cont, rtol=1e-6)
        np.testing.assert_allclose(one['Rsqrt'], math.sqrt(0.1) * np.eye(3),
                                   rtol=1e-6)
        assert np.array_equal(one['Psqrt'], np.eye(6))
        assert np.array_equal(one['Qsqrt'], np.eye(6))
        assert np.all(np.abs(one['x_init']) <= 2)
    # the shared mix keeps assign_MPC's td = 0.1 on every row
    _, s = _pool('mpc_h10.shared_x0', 4, batch=7, pool=2)
    assert s['A'].shape[:2] == (1, 1)
    assert float(s['B'][0, 0, 3, 0]) == pytest.approx(0.1)


def test_a_draw_of_no_input_is_refused():
    c = spec.Cell('mpc_h10.shared_x0')
    c.traffic = dict(c.traffic, draws={'no_such_input': c.traffic['draws'][
        'x_init']})
    with pytest.raises(KeyError):
        generate.make_pool(c, 1, CPU, 2, 1)
