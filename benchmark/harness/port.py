"""The system under test: the family built in the package's modeling layer,
its canonicalization, and the solver and call that the mix's entry names
(``entries/<entry>.py``).  With the family and entry files, the only
modules of the benchmark that import the package."""
import torch

from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize

_DTYPES = {'float32': torch.float32, 'float64': torch.float64}


class Port:
    """One configuration compiled once: the family, the entry's solver, and
    the maps between the benchmark's parameter values and the solver's
    theta and answers."""

    def __init__(self, cell, device):
        problem = cell.family_module().build(cell.config['sizes'])
        self.family = canonicalize(problem)
        self.dtype = _DTYPES[cell.config['precision']]
        self.entry = cell.entry_module()
        self.solver = self.entry.make(self.family, cell.config, self.dtype,
                                      device)
        self.sign = -1.0 if self.family.is_maximization else 1.0

    def solve(self, theta):
        """The timed call on one batch."""
        return self.entry.solve(self.solver, theta)

    def route(self, theta):
        """The route ``solve`` takes for this batch."""
        return self.entry.route(self.solver, theta)

    def pack(self, values):
        """Parameter values (name -> (pool, B or 1, *shape)) -> theta
        (pool, B, p) in the configuration's precision, laid out as the
        family's ``pack_theta`` lays out one instance."""
        npool = max(v.shape[0] for v in values.values())
        B = max(v.shape[1] for v in values.values())
        dev = next(iter(values.values())).device
        theta = torch.empty((npool, B, self.family.p), dtype=self.dtype,
                            device=dev)
        for pi in self.family.param_info:
            v = values[pi.name].expand((npool, B) + tuple(pi.shape))
            if pi.coords is None:
                # column-major flattening, as numpy's order='F'
                flat = v.permute(0, 1, *range(v.dim() - 1, 1, -1)).reshape(
                    npool, B, -1)
            elif len(pi.shape) == 2:
                r, c = (torch.as_tensor(a, device=dev) for a in pi.coords)
                flat = v[:, :, r, c]
            else:
                flat = v[:, :, torch.as_tensor(pi.coords[0], device=dev)]
            theta[:, :, pi.offset:pi.offset + pi.flat_size] = flat
        return theta

    def answers(self, res, idx):
        """The judged part of one call's result at rows ``idx``: the user's
        objective value, each named variable (column-major, flat) and the
        status code (1 = solved)."""
        x = res['x'][idx]
        out = {'obj': self.sign * (res['obj'][idx] + res['d'][idx]),
               'status': res['status'][idx]}
        for v in self.family.user_vars:
            out[v.name] = x[:, v.offset:v.offset + v.size]
        return out
