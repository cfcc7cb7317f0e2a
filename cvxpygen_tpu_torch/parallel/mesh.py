"""Multi-GPU scaling: scenario-batch sharding over a device mesh.

Port of the JAX package's ``parallel/mesh.py`` to ``torch.distributed``:

- the primary axis is the parameter/scenario batch ('batch'): every rank
  solves its rows of theta (B, p), and the solvers reduce each batch-wide
  quantity over the batch group (solvers/collectives.py) -- the loop's end,
  the Ruiz cost scaling's |q| envelope, the batch-shared adaptive rho -- so
  a sharded solve gives the single-process answer, as XLA's collectives do
  for the reference;
- an optional 'model' axis shards the canonical P and A by rows within
  instances: the KKT products and Newton-Schulz sweeps exchange their
  partial results over the model group (``make_sharded_qp_solve``).

The caller initialises ``torch.distributed`` first (as the reference asks
for ``jax.distributed.initialize()``), with the backend that suits its
devices: NCCL for one GPU per rank, gloo on the CPU or for ranks that share
a card.  Every exchange is an ``all_reduce``, which both offer for CUDA
tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..runtime.solver import CompiledConicSolver, CompiledQPSolver
from ..runtime.torch_family import (canon_batch, qp_bounds_batch,
                                    resolve_device)
from ..solvers.collectives import (RowShard, block_bounds, gather_blocks,
                                   group_rank, group_size)


def make_mesh(n_devices=None, axes=('batch',), shape=None, device=None):
    """A DeviceMesh with the named ``axes`` over the process group's ranks.

    axes=('batch',) gives pure data parallelism; axes=('batch', 'model')
    with shape=(b, m) adds within-instance sharding.  ``n_devices``, when
    given, must be the world size: every rank of the world takes part.
    Runs on CUDA unless ``device`` says otherwise."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f'make_mesh: {n_devices} devices asked for, the '
                         f'process group has {world} ranks')
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != world or len(shape) != len(axes):
        raise ValueError(f'make_mesh: shape {tuple(shape)} over axes {axes} '
                         f'does not cover {world} ranks')
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def shard_theta(theta, mesh):
    """This rank's rows of a (B, p) theta batch: the batch axis split over
    the mesh's 'batch' axis into equal blocks."""
    theta = np.atleast_2d(np.asarray(theta)) if not isinstance(
        theta, torch.Tensor) else torch.atleast_2d(theta)
    group = mesh.get_group('batch')
    rank, size = group_rank(group), group_size(group)
    B = theta.shape[0]
    if B % size:
        raise ValueError(f'batch {B} must divide the batch axis ({size} '
                         'ranks)')
    lo, hi = block_bounds(B, rank, size)
    return theta[lo:hi]


def sharded_solve(solver, theta, mesh, settings=None, shared_PA='auto'):
    """Run a compiled solver's batched solve with the batch sharded over the
    mesh's 'batch' axis.  Works for CompiledQPSolver (both branches;
    ``shared_PA`` as in its solve_batch, decided on the whole batch) and
    CompiledConicSolver.  Every rank passes the whole theta, solves its rows
    with the batch group and returns the whole batch's result."""
    if not isinstance(solver, (CompiledQPSolver, CompiledConicSolver)):
        raise TypeError(f'sharded_solve: {type(solver).__name__} has no '
                        'sharded solve')
    group = mesh.get_group('batch')
    kw = {}
    if isinstance(solver, CompiledQPSolver):
        kw['shared_PA'] = solver._use_shared(theta, shared_PA)
    local = shard_theta(theta, mesh)
    out = solver.solve_batch(local, settings=settings, group=group, **kw)
    B = local.shape[0] * group_size(group)
    return {k: gather_blocks(v, B, 0, group) for k, v in out.items()}


def make_sharded_qp_solve(tf, mesh, settings):
    """Batched QP solve with BOTH axes of parallelism:
    - 'batch': theta instances sharded (data parallel, primary axis);
    - 'model': the canonical P and A sharded by rows within instances, so
      the dense KKT products (Newton-Schulz sweeps, iteration matvecs)
      split over ranks -- the axis for very large single instances.

    The per-instance solve (solvers/admm.py) exchanges each product's
    partial results over the model group and reduces its termination over
    the batch group.  The fused kernels assume whole operands, so this path
    pins use_pallas='never'.  Returns run(theta) -> the whole batch's
    result on every rank."""
    from ..solvers.admm import admm_solve

    settings = dataclasses.replace(settings, use_pallas='never')
    if tf.m == 0:
        raise ValueError('make_sharded_qp_solve: the family has no '
                         'constraint rows to shard')
    batch_group = mesh.get_group('batch')
    shard = RowShard(mesh.get_group('model'))

    def run(theta):
        local = shard_theta(theta, mesh)
        data = canon_batch(tf, local)
        P = shard.rows(data['P'], tf.n, dim=1).contiguous()
        A = shard.rows(data['A'], tf.m, dim=1).contiguous()
        l, u = qp_bounds_batch(tf, data['b'])
        res = admm_solve(P, data['q'], A, l, u, tf.n_zero, settings,
                         group=batch_group, shard=shard)
        res['d'] = data['d']
        B = local.shape[0] * group_size(batch_group)
        return {k: gather_blocks(v, B, 0, batch_group)
                for k, v in res.items()}

    return run
