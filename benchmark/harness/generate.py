"""The one traffic generator: a pool of parameter batches, made on the device
from the seed in a few large calls.

The configuration names its inputs (``inputs``: a shape and a fixed value
each); the mix's ``draws`` replace some of them by random draws:

    {"scope": "instance" | "batch", "dist": "uniform" | "normal",
     "low", "high" (uniform), "mean", "std" (normal)}

``instance`` draws one value per instance, ``batch`` one per batch of the
pool, shared by its rows.  The family's ``assign`` turns the inputs into
parameter values, as the source's assign function does; a draw that these
two distributions do not give is a transform there.  Draws are made in the
order of their names, so a seed gives the same pool on the same device.
"""
import torch


def make_pool(cell, seed, device, batch=None, pool=None):
    """-> dict name -> float32 tensor (pool, B or 1, *shape) on ``device``:
    every parameter's values in every batch of the pool (a dimension of 1
    where the rows of a batch share the value).  ``batch`` and ``pool``
    shrink the mix (tests and readings only)."""
    config, traffic = cell.config, cell.traffic
    B = batch or traffic['batch']
    npool = pool or traffic['pool']
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    unknown = set(traffic['draws']) - set(config['inputs'])
    if unknown:
        raise KeyError(f'draws {sorted(unknown)} are no inputs of '
                       f'{config["name"]}')
    kw = dict(dtype=torch.float32, device=device)
    inputs = {}
    for name in sorted(config['inputs']):
        shape = tuple(config['inputs'][name]['shape'])
        spec = traffic['draws'].get(name)
        if spec is None:
            inputs[name] = torch.full((1, 1) + shape,
                                      float(config['inputs'][name]['value']),
                                      **kw)
            continue
        lead = (npool, B if spec['scope'] == 'instance' else 1)
        if spec['dist'] == 'uniform':
            inputs[name] = spec['low'] + (spec['high'] - spec['low']) * \
                torch.rand(lead + shape, generator=gen, **kw)
        elif spec['dist'] == 'normal':
            inputs[name] = spec.get('mean', 0.0) + spec.get('std', 1.0) * \
                torch.randn(lead + shape, generator=gen, **kw)
        else:
            raise ValueError(f'unknown distribution {spec["dist"]!r}')
    return cell.family_module().assign(config['sizes'], inputs)


def rows(values, k, idx):
    """The parameter values of rows ``idx`` (a long tensor) of pool batch
    ``k``: name -> tensor (len(idx), *shape)."""
    out = {}
    for name, v in values.items():
        b = v[k if v.shape[0] > 1 else 0]
        out[name] = (b[idx] if b.shape[0] > 1
                     else b.expand((len(idx),) + tuple(b.shape[1:])))
    return out
