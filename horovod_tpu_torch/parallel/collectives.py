"""Differentiable collectives over a mesh line: the ``lax.ppermute``,
``lax.all_to_all``, ``lax.all_gather`` and ``lax.psum`` that the JAX
package's sequence- and expert-parallel code runs inside ``shard_map``
(``horovod_tpu/parallel/ring.py``, ``ulysses.py``, and the Switch-MoE FFN
under GSPMD), as ``torch.autograd.Function``s over ``torch.distributed``.

``axis`` is a mesh axis name, a tuple of them (resolved on the current
mesh, ``parallel/mesh.py``) or a ``Comm``. Each backward is the adjoint of
its forward, with every rank's objective counted once: the training step
sums the ranks' losses (``parallel/train.py``), so a value that several
ranks consume differently gets the sum of their cotangents.

* ``ppermute(x, axis, perm)``: ``perm`` is a list of (source, destination)
  indices along the line; a rank no pair sends to gets zeros, as in JAX.
  Backward: the inverse permutation. Sends and receives go out together
  through ``dist.batch_isend_irecv``.
* ``all_to_all(x, axis, split_dim, concat_dim)``, tiled: ``x`` cut into
  ``n`` chunks along ``split_dim``, chunk j to member j, the received
  chunks concatenated along ``concat_dim`` in member order. One
  ``all_to_all_single`` on a contiguous (n, ...) buffer; the result is
  contiguous. Backward: the inverse all-to-all.
* ``all_gather(x, axis, dim)``, tiled along ``dim``. Backward: the
  reduce-scatter (every member consumes the whole in its own way: sum the
  cotangents, keep this member's block).
* ``psum(x, axis, grad=...)``: SUM all-reduce. Backward ``"sum"`` (a sum
  of partials that the members consume differently) or ``"identity"`` (a
  sum that completes a value every member then consumes alike).
* ``pvary(x, axis)``: the identity, whose backward sums the cotangents
  over the line: where a replicated value enters a region that each
  member computes a part of.

A line of one member runs no collective. Each call runs inside a profiler
range named by ``name`` (``profile_step`` reads them).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import ops
from .mesh import Comm, resolve_comm


def as_comm(axis) -> Comm:
    return axis if isinstance(axis, Comm) else resolve_comm(axis)


def _ppermute(x: torch.Tensor, comm: Comm, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    x = x.contiguous()
    if comm.size == 1:
        return x.clone() if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    out = torch.zeros_like(x)
    p2p = [dist.P2POp(dist.isend, x, comm.ranks[d], comm.group)
           for s, d in perm if s == comm.rank]
    p2p += [dist.P2POp(dist.irecv, out, comm.ranks[s], comm.group)
            for s, d in perm if d == comm.rank]
    if p2p:
        for req in dist.batch_isend_irecv(p2p):
            req.wait()
    return out


def _all_to_all(x: torch.Tensor, comm: Comm, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = comm.size
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of shape {tuple(x.shape)} does "
                         f"not split over {n} members")
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, dim=split_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=comm.group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _all_gather(x: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    if comm.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(comm.size)]
    dist.all_gather(parts, x, group=comm.group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    out = x.clone()
    if comm.size > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=comm.group)
    return out


def _reduce_scatter(g: torch.Tensor, comm: Comm, dim: int) -> torch.Tensor:
    """The SUM over the members of ``g``, this member's block along ``dim``."""
    n = comm.size
    if n == 1:
        return g
    if dist.get_backend(comm.group) == "nccl":
        send = torch.stack(g.chunk(n, dim=dim))
        out = torch.empty_like(send[0])
        dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM, group=comm.group)
        return out
    return _all_reduce(g, comm).chunk(n, dim=dim)[comm.rank].contiguous()


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, perm, name):
        ctx.comm, ctx.perm, ctx.name = comm, perm, name
        with ops.span(name):
            return _ppermute(x, comm, perm)

    @staticmethod
    def backward(ctx, g):
        with ops.span(ctx.name + ".bwd"):
            return _ppermute(g, ctx.comm, [(d, s) for s, d in ctx.perm]), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim, name):
        ctx.args = (comm, concat_dim, split_dim)
        ctx.name = name
        with ops.span(name):
            return _all_to_all(x, comm, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        with ops.span(ctx.name + ".bwd"):
            return _all_to_all(g.contiguous(), *ctx.args), None, None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, name):
        ctx.comm, ctx.dim, ctx.name = comm, dim, name
        with ops.span(name):
            return _all_gather(x, comm, dim)

    @staticmethod
    def backward(ctx, g):
        with ops.span(ctx.name + ".bwd"):
            return _reduce_scatter(g.contiguous(), ctx.comm, ctx.dim), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, grad, name):
        ctx.comm, ctx.grad, ctx.name = comm, grad, name
        with ops.span(name):
            return _all_reduce(x, comm)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "identity":
            return g, None, None, None
        with ops.span(ctx.name + ".bwd"):
            return _all_reduce(g, ctx.comm), None, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, name):
        ctx.comm, ctx.name = comm, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with ops.span(ctx.name + ".bwd"):
            return _all_reduce(g, ctx.comm), None, None


def ppermute(x: torch.Tensor, axis, perm: List[Tuple[int, int]],
             name: str = "hvd.ppermute") -> torch.Tensor:
    return _PPermute.apply(x, as_comm(axis), [tuple(p) for p in perm], name)


def all_to_all(x: torch.Tensor, axis, split_dim: int, concat_dim: int,
               name: str = "hvd.all_to_all") -> torch.Tensor:
    return _AllToAll.apply(x, as_comm(axis), split_dim, concat_dim, name)


def all_gather(x: torch.Tensor, axis, dim: int = 0,
               name: str = "hvd.all_gather") -> torch.Tensor:
    return _AllGather.apply(x, as_comm(axis), dim, name)


def psum(x: torch.Tensor, axis, grad: str = "sum", name: str = "hvd.psum") -> torch.Tensor:
    if grad not in ("sum", "identity"):
        raise ValueError(f"grad={grad!r}: 'sum' or 'identity'")
    comm = as_comm(axis)
    if comm.size == 1:
        return x
    return _PSum.apply(x, comm, grad, name)


def pvary(x: torch.Tensor, axis, name: str = "hvd.pvary") -> torch.Tensor:
    comm = as_comm(axis)
    if comm.size == 1:
        return x
    return _PVary.apply(x, comm, name)
