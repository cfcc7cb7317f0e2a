"""Grouped block-banded layout for the shared-KKT banded engine, in torch.

Port of the JAX package's ``ops/banded_grouped.py``.  Offline (family
compile time, NumPy) the family's sparse A is reorganized into DENSE
per-block-window tensors, so that kernel K5 (ops/banded_shared_kernel.py)
runs every matvec as a fixed sequence of multiply-adds with no gathers.

Key fact (follows from the RCM block-tridiagonality of
M = P + sigma I + A' R A, see solvers/admm_banded.py analyze_banded):
every constraint row's support lies within TWO ADJACENT variable blocks
[g, g+1] -- if two columns of a row were further apart, their A'A pair
would fall outside the block-tridiagonal band.  So each row r is assigned
to group g(r) = min_block(support(r)) and its coefficients split into

    B0[g, r_local, :]  -- coefficients on block g      (s entries)
    B1[g, r_local, :]  -- coefficients on block g + 1  (s entries)

with rows of each group padded to a common r_max.  The row-space state
(z, y, l, u, rho) lives in the same (nb, r_max, B) layout; padded slots
get l = -1e30, u = +1e30, A = 0 -- they fix z = w, y = 0 and drop out of
every residual (E entries are zeroed on pads).

``GroupedA`` and ``build_grouped_a`` are NumPy, copied from the JAX
package; ``scatter_grouped``, ``group_rows``, ``ungroup_rows`` and
``pack_cr_levels`` run on torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class GroupedA:
    """Static grouped layout for one banded family (shared-A path)."""
    nb: int                 # variable blocks
    s: int                  # block size
    r_max: int              # padded rows per group (multiple of 8)
    m: int                  # real constraint rows
    # scatter indices: flat position in (nb, r_max, s) for each A nnz,
    # split by which window half the column falls in
    b0_pos: np.ndarray      # (nA,) flat index into B0, or -1
    b1_pos: np.ndarray      # (nA,) flat index into B1, or -1
    # row placement: original row -> (group, local row)
    row_group: np.ndarray   # (m,)
    row_local: np.ndarray   # (m,)
    # permutation original row -> flat grouped slot g * r_max + r_local
    row_slot: np.ndarray    # (m,)

    @property
    def m_pad(self):
        return self.nb * self.r_max


def build_grouped_a(a_row, a_col, m, s, nb, r_pad_to=8):
    """Grouped layout from the (already RCM-permuted) A indices.

    a_row (nA,) constraint row per nnz; a_col (nA,) PERMUTED variable
    column per nnz.  Returns GroupedA or None if any row's support spans
    more than two adjacent blocks (family not groupable)."""
    a_row = np.asarray(a_row, np.int64)
    a_col = np.asarray(a_col, np.int64)
    blk = a_col // s

    # group of each row = min block of its support
    big = np.int64(1 << 60)
    row_group = np.full(m, big, np.int64)
    np.minimum.at(row_group, a_row, blk)
    row_group[row_group == big] = 0         # empty rows -> group 0
    row_max = np.full(m, 0, np.int64)
    np.maximum.at(row_max, a_row, blk)
    if np.any(row_max - row_group > 1):
        return None

    # local row index within each group (stable order)
    order = np.argsort(row_group, kind='stable')
    row_local = np.empty(m, np.int64)
    counts = np.zeros(nb, np.int64)
    for rr in order:
        g = row_group[rr]
        row_local[rr] = counts[g]
        counts[g] += 1
    r_max = int(max(1, counts.max()))
    r_max = -(-r_max // r_pad_to) * r_pad_to

    half = blk - row_group[a_row]           # 0 or 1: window half per nnz
    base = (row_group[a_row] * r_max + row_local[a_row]) * s + (a_col % s)
    b0_pos = np.where(half == 0, base, -1)
    b1_pos = np.where(half == 1, base, -1)
    row_slot = row_group * r_max + row_local
    return GroupedA(nb=nb, s=s, r_max=r_max, m=m,
                    b0_pos=b0_pos, b1_pos=b1_pos,
                    row_group=row_group, row_local=row_local,
                    row_slot=row_slot)


def _index(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def scatter_grouped(ga: GroupedA, avals, b0_pos=None, b1_pos=None):
    """Scaled A nnz values (nA,) -> dense B0, B1 (nb, r_max, s).  Each real
    slot receives exactly one value; -1 positions route to a discard slot.
    ``b0_pos``/``b1_pos`` are the discard-routed index tensors on the
    values' device (built here when not given)."""
    size = ga.nb * ga.r_max * ga.s
    if b0_pos is None:
        b0_pos, b1_pos = grouped_positions(ga, avals.device)
    shape = (ga.nb, ga.r_max, ga.s)
    out = []
    for pos in (b0_pos, b1_pos):
        # index_add_ takes atomics on CUDA, but no real slot receives two
        # values (only the discarded last one does), so B0 and B1 repeat
        # bitwise; the banded solvers' segment sums, where entries do
        # collide, take the order-fixed _seg_sum of solvers/admm_banded.py
        flat = torch.zeros(size + 1, dtype=avals.dtype, device=avals.device)
        flat.index_add_(0, pos, avals)
        out.append(flat[:size].reshape(shape))
    return out[0], out[1]


def grouped_positions(ga: GroupedA, device):
    """B0/B1 scatter positions with -1 routed to the discard slot."""
    size = ga.nb * ga.r_max * ga.s
    return (_index(np.where(ga.b0_pos >= 0, ga.b0_pos, size), device),
            _index(np.where(ga.b1_pos >= 0, ga.b1_pos, size), device))


def group_rows(ga: GroupedA, v, fill=0.0, row_slot=None):
    """Row-space vector(s) (..., m) -> grouped (..., nb, r_max) with pad
    slots = fill."""
    if row_slot is None:
        row_slot = _index(ga.row_slot, v.device)
    lead = v.shape[:-1]
    out = torch.full(lead + (ga.m_pad + 1,), fill, dtype=v.dtype,
                     device=v.device)
    out[..., row_slot] = v
    return out[..., :ga.m_pad].reshape(lead + (ga.nb, ga.r_max))


def ungroup_rows(ga: GroupedA, vg, row_slot=None):
    """Inverse of group_rows: (..., nb, r_max) -> (..., m)."""
    if row_slot is None:
        row_slot = _index(ga.row_slot, vg.device)
    flat = vg.reshape(vg.shape[:-2] + (ga.m_pad,))
    return flat[..., row_slot]


def pack_cr_levels(fac):
    """Flatten a cr_factor(...) output (B=1) into ONE (NB_TOT, s, s)
    tensor + static slicing metadata, the factor layout of kernels K4 and
    K5.

    Layout per level: [Dinv_odd (n2), A (na), C (n2), L_left (nl),
    L_even (ne)], then root_inv (1).  Returns (packed, meta) with
    meta = list of dicts of (offset, count) per tensor + 'root' offset.
    The 'lleft' offsets index the reference's separate L_left pack (its
    ``pack_lleft``), which only its fused-iterate kernel reads; the port's
    counterpart, kernel K11 (ops/banded_shared_kernel. banded_iterate), reads
    L_left from this packed factor through csrc/cr_group.cuh, so ``pack_lleft``
    has no port.  The offsets are kept so that the metadata equals the
    reference's."""
    parts = []
    meta = []
    off = 0

    def add(name, x, entry):
        nonlocal off
        x2 = x[0]                      # strip B=1
        parts.append(x2)
        entry[name] = (off, x2.shape[0])
        off += x2.shape[0]

    ll_off = 0
    for lv in fac['levels']:
        entry = {}
        add('Dinv_odd', lv['Dinv_odd'], entry)
        add('A', lv['A'], entry)
        add('C', lv['C'], entry)
        add('L_left', lv['L_left'], entry)
        add('L_even', lv['L_even'], entry)
        entry['lleft'] = ll_off
        ll_off += lv['L_left'].shape[1]
        meta.append(entry)
    root = off
    parts.append(fac['root_inv'])
    off += 1
    packed = torch.cat(parts, dim=0)
    return packed, dict(levels=meta, root=root, total=off,
                        lleft_total=ll_off)
