"""Batch-wide reductions and row-block products across the ranks of a
process group (``torch.distributed``).

The JAX package shards a batch over a device mesh and lets XLA turn every
batch-wide reduction of its solvers into a collective.  The port's solvers
reduce over the batch rows they hold, so a solver given a ``group`` reduces
each batch-wide quantity over the group's ranks with these helpers; with
``group=None`` they make no collective and return what a single process
computes.

Every exchange is an ``all_reduce`` (an all-gather is a zero-padded SUM,
which is exact): gloo offers no other collective for CUDA tensors, and the
same code runs under NCCL on a multi-GPU host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _reduced(t, op, group):
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def group_max(t, group):
    """Elementwise maximum of ``t`` over the group's ranks."""
    return t if group is None else _reduced(t, dist.ReduceOp.MAX, group)


def group_sum(t, group):
    """Elementwise sum of ``t`` over the group's ranks."""
    return t if group is None else _reduced(t, dist.ReduceOp.SUM, group)


def group_all(b, group):
    """``b.all()`` over every rank's ``b``: a 0-d bool tensor."""
    if group is None:
        return b.all()
    return _reduced(b.all().to(torch.int32), dist.ReduceOp.MIN,
                    group).bool()


def group_any(b, group):
    """``b.any()`` over every rank's ``b``: a 0-d bool tensor."""
    if group is None:
        return b.any()
    return _reduced(b.any().to(torch.int32), dist.ReduceOp.MAX,
                    group).bool()


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group):
    return 0 if group is None else dist.get_rank(group)


def block_bounds(d, rank, size):
    """Rows [lo, hi) of a d-row axis that ``rank`` of ``size`` holds: blocks
    of ceil(d / size) rows, the last one shorter (XLA's split of an uneven
    axis)."""
    c = -(-d // size)
    return min(d, rank * c), min(d, (rank + 1) * c)


def gather_blocks(t, d, dim, group):
    """The whole d-long axis ``dim`` from every rank's block of it
    (``block_bounds``), on every rank: a zero-padded all-reduce SUM."""
    if group is None:
        return t
    if t.dtype == torch.bool:
        return gather_blocks(t.to(torch.uint8), d, dim, group).bool()
    lo, hi = block_bounds(d, group_rank(group), group_size(group))
    shape = list(t.shape)
    shape[dim] = d
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(dim, lo, hi - lo).copy_(t)
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


class RowShard:
    """The model axis of a batched solve: rank r of ``group`` holds rows
    ``block_bounds(d, r, size)`` of every row-sharded (B, d, k) matrix (P,
    A, M and M^-1), and whole vectors.  A product with a row block is
    exchanged into the whole result (``mv``: gathered; ``vm``: summed).
    With ``group=None`` (``NO_SHARD``) every method is the plain product or
    the identity."""

    def __init__(self, group=None):
        self.group = group

    def bounds(self, d):
        """Rows [lo, hi) of a d-row axis that this rank holds."""
        return block_bounds(d, group_rank(self.group), group_size(self.group))

    def rows(self, v, d, dim=-1):
        """This rank's block of the d-long axis ``dim`` of ``v``."""
        if self.group is None:
            return v
        lo, hi = self.bounds(d)
        return v.narrow(dim, lo, hi - lo)

    def gather(self, t, d, dim=-1):
        return gather_blocks(t, d, dim, self.group)

    def max(self, t):
        return group_max(t, self.group)

    def sum(self, t):
        return group_sum(t, self.group)

    def mv(self, W, v, d):
        """W v for a row-sharded W (B, d, k) and whole v (B, k): (B, d)."""
        return self.gather(torch.matmul(W, v[..., None])[..., 0], d)

    def vm(self, v, W, d):
        """v' W for a whole v (B, d) and a row-sharded W (B, d, k): (B, k)."""
        return self.sum(torch.matmul(self.rows(v, d)[:, None, :], W)[:, 0])

    def matmul(self, W, X, d):
        """W X for a row-sharded W (B, d, k) and whole X (B, k, j)."""
        return self.gather(torch.matmul(W, X), d, dim=-2)


NO_SHARD = RowShard()
