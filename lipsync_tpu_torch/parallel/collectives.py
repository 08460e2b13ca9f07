"""Collectives with a gradient, for training over a process group.

Each rank of a data-parallel step computes the *global* loss ``L`` from
tensors gathered over the group and backpropagates ``L / world``. The sum
of those objectives over the ranks is ``L``, so with the adjoints below a
rank's gradient for its own inputs is its share of ``dL``, and the sum of
every rank's parameter gradients (:func:`all_reduce_grads`) is ``dL/dθ``
for the global batch: the JAX package's one program over the mesh.

``all_gather_rows`` forwards the ranks' equal blocks concatenated in rank
order; its adjoint is this rank's block of the summed output gradients.
It runs on ``all_reduce`` alone (of a zero-filled buffer holding this
rank's block), which gloo and NCCL both have.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist


def _sum(x: torch.Tensor) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        world, rank = dist.get_world_size(), dist.get_rank()
        n = x.shape[0]
        ctx.rows = (rank * n, (rank + 1) * n)
        full = x.new_zeros((world * n,) + tuple(x.shape[1:]))
        full[rank * n:(rank + 1) * n] = x
        dist.all_reduce(full, op=dist.ReduceOp.SUM)
        return full

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return _sum(grad)[lo:hi]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along axis 0 in rank
    order, on every rank, with a gradient."""
    return _AllGatherRows.apply(x)


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum the ``.grad`` of every parameter that has one over the ranks, in
    one flat buffer. Every rank runs the same model on the same step, so
    the same parameters have gradients on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
