"""The plain reference writes each family's QP out again: on the same
parameter values its answers match the package's float64 oracle (called
here only, never by the reference)."""
import numpy as np
import pytest
import torch

from cvxpygen_tpu_torch.canon.canonicalizer import retrieve_primal
from cvxpygen_tpu_torch.solvers.oracle import solve_family_numpy
from harness import generate, judge, spec
from harness.port import Port

CPU = torch.device('cpu')


@pytest.mark.parametrize('name', [w['name'] for w in
                                  spec.benchmark()['workloads']])
def test_reference_matches_the_oracle(name):
    c = spec.Cell(name)
    values = generate.make_pool(c, 21, CPU, 3, 1)
    rows = generate.rows(values, 0, torch.arange(3))
    ref = judge.reference_answers(c.family, c.config['sizes'], rows)
    assert bool(ref['converged'].all())
    port = Port(c, CPU)
    fam = port.family
    theta = port.pack(values)[0].double().numpy()
    for i in range(3):
        res, _ = solve_family_numpy(fam, theta[i])
        tt = np.concatenate([theta[i], [1.0]])
        d = float(np.asarray(fam.d_map @ tt).ravel()[0])
        obj = port.sign * (res.obj + d)
        assert float(ref['obj'][i]) == pytest.approx(obj, rel=1e-6, abs=1e-6)
        primal = retrieve_primal(fam, res.x)
        for v in fam.user_vars:
            np.testing.assert_allclose(ref[v.name][i].numpy(),
                                       primal[v.vid], atol=2e-5)
