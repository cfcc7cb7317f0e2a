"""AOT artifacts: export the batched QP solve and load it without the
family.

Port of the JAX package's ``runtime/aot.py``: there the artifact is a
serialized StableHLO export of the jitted solve for a fixed (family,
batch shape); here it is a ``torch.export`` program saved as ``.pt2``.  It
holds canonicalization (the map tensors are buffers of the program) and the
per-instance ADMM solve, so a serving process loads it and calls it on
theta with no ``Family`` and no canonicalizer.

The solve's data-dependent control flow (its end, the adaptive-rho
refactorization, the Newton-Schulz rescue) is recorded as ``while_loop``
and ``torch.cond`` from the same loop body that the eager solve runs
(solvers/admm.py, ``flow=TRACED``), and kernel K3 as the operator
``torch.ops.cvxpygen_tpu_torch.admm_iterate``: the program launches K3 on
the card, as the reference's export carries its Pallas kernel on a TPU.
Kernel K2 (``use_pallas='full'``) cannot be recorded, and raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import torch

from ..solvers.admm import TRACED, ADMMSettings, admm_solve, full_f32_matmul
from .torch_family import TorchFamily, canon_batch, qp_bounds_batch


def family_fingerprint(tf: TorchFamily):
    """16 hex digits of the maps' bytes and the family's dimensions (the
    JAX package's fingerprint for maps of the same dtype and layout)."""
    h = hashlib.sha256()
    h.update(tf.maps.detach().cpu().contiguous().numpy().tobytes())
    h.update(str((tf.n, tf.m, tf.p, tf.n_zero, tf.n_nonneg,
                  tf.soc_dims)).encode())
    return h.hexdigest()[:16]


class _QPStep(torch.nn.Module):
    """theta -> (x, -y, obj + d, iters, solved), with the family's tensors
    as buffers."""

    _TENSORS = ('maps', 'd_quad', 'P_ij', 'A_ij')

    def __init__(self, tf: TorchFamily, settings: ADMMSettings):
        super().__init__()
        for name in self._TENSORS:
            if getattr(tf, name) is not None:
                self.register_buffer(name, getattr(tf, name))
        self.tf = tf
        self.settings = settings

    def forward(self, theta):
        tf = dataclasses.replace(self.tf, **{
            name: getattr(self, name) for name in self._TENSORS
            if getattr(self.tf, name) is not None})
        data = canon_batch(tf, theta)
        l, u = qp_bounds_batch(tf, data['b'])
        res = admm_solve(data['P'], data['q'], data['A'], l, u, tf.n_zero,
                         self.settings, flow=TRACED)
        return (res['x'], -res['y'], res['obj'] + data['d'], res['iters'],
                res['solved'])


def export_qp_solver(tf: TorchFamily, batch_size: int,
                     settings: ADMMSettings = None, cache_dir=None):
    """Export the batched QP solve for a fixed batch size on the family's
    device and dtype; returns (path, exported).  Writes
    <cache_dir>/<fingerprint>_B<batch>.pt2 when ``cache_dir`` is given."""
    settings = settings or ADMMSettings()
    theta = torch.zeros((batch_size, tf.p), dtype=tf.maps.dtype,
                        device=tf.maps.device)
    with full_f32_matmul():
        exported = torch.export.export(_QPStep(tf, settings), (theta,),
                                       strict=False)
    path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(
            cache_dir, f'{family_fingerprint(tf)}_B{batch_size}.pt2')
        torch.export.save(exported, path)
    return path, exported


def load_exported(path):
    """Load an exported solve; returns a callable(theta) -> (x, -y, obj + d,
    iters, solved) on the program's device, in full float32 matmuls."""
    from ..ops import admm_kernel  # noqa: F401  (registers K3's operator)
    exported = torch.export.load(path)
    maps = exported.state_dict['maps']
    module = exported.module()

    def call(theta):
        theta = torch.as_tensor(theta, device=maps.device).to(maps.dtype)
        with full_f32_matmul():
            return module(theta)

    return call
