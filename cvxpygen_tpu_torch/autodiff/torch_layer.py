"""Torch layer over the differentiable batched solve (cvxpylayers
parity).

Port of the JAX package's ``autodiff/torch_layer.py``, routed as its
``autodiff/jax_layer.py`` routes: a layer object that maps parameter
tensors to variable tensors with autograd support, batched over a leading
axis.  The reference crosses from torch to JAX through NumPy on the host;
here the tensors stay on the device and the solve is one of three
``torch.autograd.Function``s:

- cone families: autodiff/conic_diff.py (the conic ADMM forward for
  exp/PSD/pow cones, the IPM for SOC-only ones);
- QP families with n + m > 1500 and a block-banded KKT (``banded='auto'``;
  ``True`` forces the banded route, ``False`` the dense one):
  autodiff/qp_diff_banded.py;
- other QP families: autodiff/qp_diff.py, the shared-KKT forward (kernel
  K1 on the card) for a batch whose rows share P and A.

The cone check comes before the band check: the reference's torch layer
skips it and would solve a banded conic family as a box QP.
"""
from __future__ import annotations

import numpy as np
import torch

from ..canon.canonicalizer import canonicalize
from ..runtime.solver import pa_theta_mask
from ..runtime.torch_family import (TorchFamily, default_dtype,
                                     resolve_device)
from ..solvers.admm import ADMMSettings
from .qp_diff import make_diff_solve


class TorchLayer:
    """``layer = TorchLayer(problem, parameters=[...], variables=[...])``;
    ``*vals = layer(*param_tensors)`` -- the call contract of
    cvxpylayers.torch.CvxpyLayer.

    Parameter tensors may carry one leading batch dimension (all batched
    tensors must agree; unbatched ones broadcast).  Gradients flow through
    the implicit differentiation of the batched solve (see the module
    docstring for the routes; ``_conic`` and ``_banded`` say which was
    taken).  ``settings`` are the forward engine's.  Runs on CUDA unless
    ``device`` says otherwise, in the compiled solvers' dtype (float32 on
    CUDA, float64 on the CPU)."""

    def __init__(self, problem, parameters, variables, settings=None,
                 device=None, banded='auto'):
        fam = canonicalize(problem)
        self._fam = fam

        prob_pids = [pi.pid for pi in fam.param_info]
        given_pids = [p.id for p in parameters]
        if sorted(prob_pids) != sorted(given_pids):
            raise ValueError('parameters must exactly cover the '
                             'problem\'s parameters')
        by_pid = {pi.pid: pi for pi in fam.param_info}
        self._pinfos = [by_pid[p.id] for p in parameters]

        by_vid = {vi.vid: vi for vi in fam.var_info if vi.is_user}
        self._vinfos = []
        for v in variables:
            if v.id not in by_vid:
                raise ValueError(f'variable {v.name()} not in problem')
            self._vinfos.append(by_vid[v.id])

        device = resolve_device(device)
        self._conic = bool(fam.soc_dims or fam.n_exp or fam.psd_dims
                           or fam.pow_alphas)
        self._banded = False
        if self._conic:
            from .conic_diff import make_conic_diff_solve
            self._solve = make_conic_diff_solve(
                TorchFamily.from_family(fam, device=device), settings)
            return
        # gradient-quality tolerances by default (the reference's bar is
        # atol 1e-4 against cvxpylayers, its tests/test_diff.py:49,106);
        # float32 cannot reach 1e-8 residuals
        tight = 1e-8 if default_dtype(device) == torch.float64 else 1e-6
        settings = settings or ADMMSettings(eps_abs=tight, eps_rel=tight,
                                            max_iter=20000)
        # the dense backward's (B, n+m, n+m) reduced KKT is about 830 MB per
        # instance at charging T=1440, so long-horizon banded families take
        # the banded vjp
        struct = None
        if banded is True or (banded == 'auto' and fam.n + fam.m > 1500):
            from ..solvers.admm_banded import build_banded_structure
            struct = build_banded_structure(fam.P_idx, fam.A_idx, fam.n,
                                            fam.m)
            if struct is None and banded is True:
                raise ValueError('banded=True: family KKT pattern is not '
                                 'block-banded')
        if struct is not None:
            from .qp_diff_banded import make_diff_solve_banded
            self._banded = True
            self._solve = make_diff_solve_banded(
                TorchFamily.from_family(fam, device=device,
                                        force_scatter=True),
                struct, settings)
        else:
            self._solve = make_diff_solve(
                TorchFamily.from_family(fam, device=device), settings,
                shared_PA='auto', pa_mask=pa_theta_mask(fam))

    def _flatten_param(self, t, pi):
        if pi.coords is None:
            if len(pi.shape) == 2:
                return t.transpose(-1, -2).reshape(*t.shape[:-2], -1)
            return t.reshape(*t.shape[:max(t.dim() - len(pi.shape), 0)], -1)
        r, c = pi.coords
        if len(pi.shape) == 2:
            return t[..., list(r), list(c)]
        return t[..., list(r)]

    def __call__(self, *param_tensors):
        if len(param_tensors) != len(self._pinfos):
            raise ValueError(f'expected {len(self._pinfos)} parameter '
                             f'tensors, got {len(param_tensors)}')
        # batch detection (cvxpylayers semantics)
        batch = None
        for t, pi in zip(param_tensors, self._pinfos):
            extra = t.dim() - len(pi.shape)
            if extra == 1:
                if batch is not None and batch != t.shape[0]:
                    raise ValueError('inconsistent batch sizes')
                batch = t.shape[0]
            elif extra != 0:
                raise ValueError(f'parameter {pi.name}: tensor rank '
                                 f'{t.dim()} does not match shape {pi.shape}')
        squeeze = batch is None
        B = 1 if batch is None else batch

        segs = [None] * len(self._pinfos)
        order = sorted(range(len(self._pinfos)),
                       key=lambda i: self._pinfos[i].offset)
        dtype = param_tensors[0].dtype
        for i, (t, pi) in enumerate(zip(param_tensors, self._pinfos)):
            if t.dim() == len(pi.shape):
                t = t.unsqueeze(0).expand(B, *t.shape)
            flat = self._flatten_param(t, pi).reshape(B, -1)
            if flat.shape[1] != pi.flat_size:
                raise ValueError(f'parameter {pi.name}: got {flat.shape[1]} '
                                 f'entries, expected {pi.flat_size}')
            segs[i] = flat
        theta = torch.cat([segs[i] for i in order], dim=1)

        x = self._solve(theta)['x']

        outs = []
        for vi in self._vinfos:
            free = x[:, vi.offset:vi.offset + vi.size]
            if vi.expand is not None:
                rows, cols = vi.expand
                full = x.new_zeros((B, int(np.prod(vi.shape))))
                full[:, list(rows)] = free[:, list(cols)]
            else:
                full = free
            if len(vi.shape) == 2:
                r, c = vi.shape
                full = full.reshape(B, c, r).transpose(1, 2)
            elif len(vi.shape) == 1:
                full = full.reshape(B, vi.shape[0])
            else:
                full = full.reshape(B)
            outs.append((full[0] if squeeze else full).to(dtype))
        return tuple(outs)
