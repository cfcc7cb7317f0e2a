"""Scenario-consensus ADMM: couple a sharded scenario batch through
shared first-stage decisions.

Port of the JAX package's ``parallel/consensus.py``.  The classic
two-stage stochastic program

    min  sum_b f_b(x_b)   s.t.  x_b in C_b,   x_b[sel] equal for all b

(non-anticipativity: every scenario b shares the same first-stage
decision, e.g. the first control move of a stochastic MPC), solved by
global-variable consensus ADMM (Boyd et al. 2011, section 7.2):

    x_b^{k+1} = argmin_b f_b(x_b) + (rho_c/2)||x_b[sel] - zbar^k + u_b^k||^2
    zbar^{k+1} = mean_b(x_b^{k+1}[sel])
    u_b^{k+1}  = u_b^k + x_b^{k+1}[sel] - zbar^{k+1}

- the per-scenario argmin is a QP differing from the family QP only in a
  constant diagonal P shift (+rho_c on the consensus entries, shared by
  every scenario and every outer iteration) and a per-iteration q update:
  the shared-KKT solve (solvers/admm_shared.py, kernel K1 on the card),
  warm-started from the previous outer iterate;
- ``mean_b`` is the ONLY cross-scenario coupling.  With the batch sharded
  over a mesh (parallel/mesh.py) each outer iteration makes one all-reduce
  for it: the sums of x_b[sel] and of |x_b[sel] - zbar^k|^2, from which the
  mean and the consensus residual follow.

Requires canonical P/A shared across the batch (scenario uncertainty in
the vector parameters -- demands, prices, initial states), which is the
standard stochastic-program shape; raises otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..canon.canonicalizer import Family
from ..runtime.solver import pa_theta_mask, use_shared_path
from ..runtime.torch_family import (TorchFamily, canon_batch_shared,
                                    qp_bounds_batch)
from ..solvers.admm import ADMMSettings
from ..solvers.admm_shared import admm_solve_shared
from ..solvers.collectives import gather_blocks, group_sum


def consensus_indices(family: Family, consensus_vars):
    """Canonical-x indices of the consensus variables.

    ``consensus_vars``: iterable of variable names (whole variable) or
    ``(name, local_flat_indices)`` pairs."""
    by_name = {vi.name: vi for vi in family.var_info if vi.is_user}
    idx = []
    for item in consensus_vars:
        if isinstance(item, str):
            name, local = item, None
        else:
            name, local = item
        if name not in by_name:
            raise ValueError(f'unknown variable {name!r}')
        vi = by_name[name]
        loc = np.arange(vi.size) if local is None else np.asarray(local)
        if loc.size and (loc.min() < 0 or loc.max() >= vi.size):
            raise ValueError(f'{name}: consensus indices out of range')
        idx.extend((vi.offset + loc).tolist())
    return np.asarray(sorted(set(idx)), dtype=int)


def consensus_solve(family: Family, thetas, consensus_vars,
                    rho_c=1.0, outer_iters=50, eps_consensus=1e-4,
                    inner_settings: ADMMSettings = None, dtype=None,
                    mesh=None, device=None):
    """Solve the scenario-consensus program over a (B, p) theta batch.

    Returns dict(x (B, n), y, z_consensus (k,), u (B, k), obj (B,),
    outer_iters, consensus_residual, consensus_dual_residual, solved).
    ``obj`` is each scenario's objective at the consensus-feasible point (x
    with x[sel] = zbar); mean(obj) is the sample-average objective.

    With ``mesh`` given, every rank passes the whole batch, solves its rows
    (the mesh's 'batch' axis) and returns the whole batch's result.  Runs on
    CUDA unless ``device`` says otherwise."""
    tf = TorchFamily.from_family(family, dtype=dtype, device=device)
    sel = consensus_indices(family, consensus_vars)
    if sel.size == 0:
        raise ValueError('no consensus variables given')
    thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
    if not use_shared_path(pa_theta_mask(family), thetas, 'auto'):
        raise ValueError(
            'consensus_solve requires canonical P/A shared across the '
            'scenario batch (vector-parameter uncertainty only)')
    st = inner_settings or ADMMSettings(eps_abs=0.1 * eps_consensus,
                                        eps_rel=0.1 * eps_consensus,
                                        max_iter=2000)
    group = None
    if mesh is not None:
        from .mesh import shard_theta
        group = mesh.get_group('batch')
        thetas_local = shard_theta(thetas, mesh)
    else:
        thetas_local = thetas
    out = _consensus(tf, thetas_local, thetas.shape[0],
                     torch.as_tensor(sel, device=tf.maps.device),
                     float(rho_c), int(outer_iters), float(eps_consensus),
                     st, group)
    B = thetas.shape[0]
    for key in ('x', 'y', 'u', 'obj'):
        out[key] = gather_blocks(out[key], B, 0, group)
    return out


def _consensus(tf: TorchFamily, theta, B_all, sel, rho_c, outer_iters, eps,
               settings: ADMMSettings, group):
    data = canon_batch_shared(tf, theta)
    P, q, A = data['P'], data['q'], data['A']
    l, u_b = qp_bounds_batch(tf, data['b'])
    B, n = q.shape
    k = sel.shape[0]
    dtype, dev = q.dtype, q.device
    # constant consensus-penalty shift: shared by all scenarios and all
    # outer iterations, so the shared-KKT factorization is reused
    P_aug = P.clone()
    P_aug[sel, sel] += rho_c

    x = torch.zeros((B, n), dtype=dtype, device=dev)
    y = torch.zeros((B, A.shape[0]), dtype=dtype, device=dev)
    u = torch.zeros((B, k), dtype=dtype, device=dev)
    zbar = torch.zeros((k,), dtype=dtype, device=dev)
    rp = rd = torch.tensor(float('inf'), dtype=dtype, device=dev)
    done = False
    it = 0
    while not done and it < outer_iters:
        q_mod = q.clone()
        q_mod[:, sel] += rho_c * (u - zbar[None, :])
        res = admm_solve_shared(P_aug, q_mod, A, l, u_b, tf.n_zero,
                                settings, x0=x, y0=y, group=group)
        xs = res['x'][:, sel]
        # the consensus collective: the scenario sums behind the mean and
        # the residual; sum_b |xs_b - c|^2 = sum_b |xs_b - mean|^2
        # + B |mean - c|^2 about the previous mean c, which stays close to
        # the new one, so the residual keeps its precision
        sums = group_sum(torch.cat([
            torch.sum(xs, dim=0),
            torch.sum((xs - zbar[None, :]) ** 2).reshape(1)]), group)
        zbar_new = sums[:k] / B_all
        rp = torch.sqrt(torch.clamp(
            sums[k] / B_all - torch.sum((zbar_new - zbar) ** 2), min=0.0))
        u = u + xs - zbar_new[None, :]
        rd = rho_c * torch.linalg.norm(zbar_new - zbar)
        zbar = zbar_new
        x, y = res['x'], res['y']
        it += 1
        done = bool((rp < eps) & (rd < eps))

    # scenario objectives at the consensus-feasible point
    x_cons = x.clone()
    x_cons[:, sel] = zbar[None, :]
    Px = torch.einsum('ij,bj->bi', P, x_cons)
    obj = (0.5 * torch.sum(x_cons * Px, dim=1) + torch.sum(q * x_cons, dim=1)
           + data['d'])
    return dict(x=x_cons, y=y, z_consensus=zbar, u=u, obj=obj,
                outer_iters=it, consensus_residual=rp,
                consensus_dual_residual=rd, solved=done)
