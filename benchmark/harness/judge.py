"""The comparison that decides ``correct``: the solver's answers on a sample
of the window's instances against the plain reference's
(``reference/<family>.py``), solved again from the same parameter values
in float64.

Numbers compared over the sampled instances that the solver reports solved:

- ``obj_gap_max``: the largest gap |objective - reference| / max(1,
  |reference|), which catches a wrong answer; its limit is the objective
  tolerance that the configuration states;
- ``obj_gap_median``: the median of those gaps, which catches a lower
  precision; its limit, in the mix's file, lies between the solver's
  readings and its control's;
- ``var_gap``: the largest gap of a named variable, the largest entry of
  |variable - reference| over max(1, that variable's largest reference
  entry), which catches a wrong variable map or a stale iterate under a
  sound objective; its limit, in the mix's file, lies between the solver's
  readings and those of a fault that hands out a neighbour's variables.

Instances the solver does not report solved are counted in ``failed``, not
judged.
"""
import math

import torch

from . import spec

_NOT_VARIABLES = ('obj', 'converged', 'status')


def reference_answers(family, sizes, values, dtype=torch.float64, block=512,
                      tol=1e-8):
    """Solve the instances of ``values`` (name -> (S, *shape)) with the
    family's plain reference in ``dtype``, ``block`` instances at a time.
    Returns the user's objective, each named variable and whether the
    reference converged, per instance."""
    ref = spec.reference_module(family)
    S = next(iter(values.values())).shape[0]
    parts = [ref.solve({k: v[lo:lo + block] for k, v in values.items()},
                       sizes, dtype=dtype, tol=tol)
             for lo in range(0, S, block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def compare(answers, ref, limits):
    """-> (correct, checks, notes): ``checks`` maps each compared number to
    {"value", "limit"}; ``notes`` says what else failed."""
    notes = []
    if not bool(ref['converged'].all()):
        notes.append(f"the reference did not converge on "
                     f"{int((~ref['converged']).sum())} sampled instances")
    solved = answers['status'] == 1
    values = dict.fromkeys(('obj_gap_max', 'obj_gap_median', 'var_gap'),
                           math.inf)
    if bool(solved.any()):
        o_r = ref['obj'][solved]
        gap = (answers['obj'][solved].double() - o_r).abs() / o_r.abs().clamp(
            min=1.0)
        v_gap = []
        for name in (k for k in ref if k not in _NOT_VARIABLES):
            v_r = ref[name][solved]
            v_gap.append(((answers[name][solved].double() - v_r).abs().amax(1)
                          / v_r.abs().amax(1).clamp(min=1.0)).max())
        values = {'obj_gap_max': float(gap.max()),
                  'obj_gap_median': float(gap.median()),
                  'var_gap': float(torch.stack(v_gap).max())}
    else:
        notes.append('no sampled instance was reported solved')
    checks = {}
    for k, v in values.items():
        checks[k] = {'value': v if math.isfinite(v) else math.inf,
                     'limit': limits.get(k)}
        if checks[k]['limit'] is None:
            notes.append(f'{k} has no limit in this cell')
    correct = not notes and all(c['value'] <= c['limit']
                                for c in checks.values())
    return correct, checks, notes
