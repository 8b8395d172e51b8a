"""Pipeline parallelism: the GPipe schedule over the pp mesh axis
(counterpart of ``horovod_tpu/parallel/pipeline.py``).

The JAX ``gpipe`` runs a ``lax.scan`` of M + S - 1 ticks inside a
``shard_map`` manual over pp: at every tick every stage applies its layers
to what it holds, passes the result on with ``ppermute``, and the ticks of
the fill and the drain compute values that masks then discard. Here each
pp rank is one stage and runs its layers only on real microbatches:

* stage 0 takes microbatch t of the input, stage s > 0 receives it from
  stage s - 1 (``irecv``); the stage applies ``stage_fn`` and sends the
  result to stage s + 1 (``isend``), or, on the last stage, banks it;
* the last stage's outputs, in f32, are broadcast to every pp rank, the
  value the masked ``psum`` of JAX gives every stage;
* the input crosses in f32 and the output leaves in f32, as JAX keeps the
  ``shard_map`` boundary (``pipeline.py:55-60``).

Backward runs the same schedule in reverse: the last stage takes its own
cotangent of the output once (the broadcast's adjoint as seen by one
objective: ``psum(grad="identity")``, never the sum over the pp ranks,
which would multiply the gradients by S), microbatch t's cotangent goes
from stage s + 1 back to stage s, and the input's cotangent (stage 0's,
zeros elsewhere) is summed over pp in f32, the transpose of JAX's
``pvary``, so that every pp rank ends with the same gradient of what
produced the input. Each rank keeps every microbatch's graph between
forward and backward (GPipe's activation memory; ``remat`` cuts it to the
blocks' inputs) and returns its stage parameters' gradients summed over
the microbatches. The sends and receives of one rank run in one order on
every rank of its pp line, so they pair up. Where ``stage_fn`` exchanges
over another line (the tp sums of ``PipelinedLM``'s stages; under sp the
ring's rotations, Ulysses' all-to-alls or the sp gathers and their
reduce-scatters; in backward also their remat recomputation), that line
lies at one pp coordinate and every rank of it runs the same microbatches
in the same order: microbatch t's exchanges are issued after its pp
receive and before its pp send, in forward and in backward alike. So every
rank issues its exchanges on each communicator in one order, and a pp send
left open while the next microbatch's exchanges start on another
communicator waits only on a receive its peer has issued or will issue
next. The profiler ranges are ``hvd.pp.send``, ``hvd.pp.recv``,
``hvd.pp.replicate`` and ``hvd.pp.psum``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .. import ops
from .mesh import Comm, Mesh


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``n_stages`` holds, the rows
    ``stack_stage_params`` gives it: ``[stage·L/S, (stage+1)·L/S)``."""
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def stack_stage_params(layer_params: Any, n_stages: int) -> Any:
    """Layer-stacked parameters (leading dim L) as stage-stacked ones
    (leading dims (S, L/S)), as the JAX function reshapes them."""
    def reshape(a):
        L = a.shape[0]
        if L % n_stages != 0:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return _tree_map(reshape, layer_params)


def _send(t: torch.Tensor, comm: Comm, dst: int):
    """The send's work and the tensor it reads, to hold until it is waited."""
    t = t.contiguous()
    with ops.span("hvd.pp.send"):
        return dist.isend(t, comm.ranks[dst], group=comm.group), t


def _recv(like: torch.Tensor, comm: Comm, src: int) -> torch.Tensor:
    buf = torch.empty_like(like)
    with ops.span("hvd.pp.recv"):
        dist.irecv(buf, comm.ranks[src], group=comm.group).wait()
    return buf


class _GPipe(torch.autograd.Function):
    """One rank's stage of the schedule (see the module docstring):
    ``xs`` (M, mb, ...) f32 in, the replicated (M, mb, ...) f32 out."""

    @staticmethod
    def forward(ctx, xs, stage_fn, stage_params, comm, act_dtype, build, *params):
        S, s, M = comm.size, comm.rank, xs.shape[0]
        ctx.comm, ctx.params = comm, params
        ctx.saved = []
        sends = []
        like = torch.empty(xs.shape[1:], dtype=act_dtype, device=xs.device)
        ys = []
        for t in range(M):
            a = xs[t].to(act_dtype) if s == 0 else _recv(like, comm, s - 1)
            a = a.detach().requires_grad_(build)
            with torch.enable_grad() if build else torch.no_grad():
                y = stage_fn(stage_params, a)
            if y.shape != a.shape or y.dtype != a.dtype:
                raise ValueError(f"stage_fn must keep the activation's shape and dtype: "
                                 f"{tuple(a.shape)} {a.dtype} -> {tuple(y.shape)} {y.dtype}")
            if build:
                ctx.saved.append((a, y))
            if s < S - 1:
                sends.append(_send(y.detach(), comm, s + 1))
            else:
                ys.append(y.detach().float())
        for work, _ in sends:
            work.wait()
        out = torch.stack(ys) if s == S - 1 else torch.empty_like(xs)
        with ops.span("hvd.pp.replicate"):
            dist.broadcast(out, comm.ranks[S - 1], group=comm.group)
        return out

    @staticmethod
    def backward(ctx, g_out):
        comm, params = ctx.comm, ctx.params
        S, s, M = comm.size, comm.rank, g_out.shape[0]
        used = [p for p in params if p.requires_grad]
        grads = [None] * len(used)
        g_xs = torch.zeros_like(g_out)
        sends = []
        for t in reversed(range(M)):
            a, y = ctx.saved.pop()
            # The last stage's own cotangent, once: not summed over pp.
            gy = g_out[t].to(y.dtype) if s == S - 1 else _recv(y, comm, s + 1)
            got = torch.autograd.grad(y, [a] + used, gy, allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            ga = torch.zeros_like(a) if got[0] is None else got[0]
            if s > 0:
                sends.append(_send(ga, comm, s - 1))
            else:
                g_xs[t] = ga.float()
        for work, _ in sends:
            work.wait()
        with ops.span("hvd.pp.psum"):
            dist.all_reduce(g_xs, op=dist.ReduceOp.SUM, group=comm.group)
        it = iter(grads)
        out = [next(it) if p.requires_grad else None for p in params]
        return (g_xs, None, None, None, None, None, *out)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
          x: torch.Tensor, *, mesh: Mesh, axis: str = "pp",
          num_microbatches: Optional[int] = None) -> torch.Tensor:
    """Run ``x`` through the S stages of ``axis``.

    ``stage_fn(stage_params, act) -> act`` applies this rank's stage and
    keeps the activation's shape and dtype; ``stage_params`` is this rank's
    stage (a module, or a tree of tensors: row ``mesh.coords[axis]`` of
    ``stack_stage_params``' output), whose tensors that require grad
    receive their gradients. ``x`` is the full batch (B, ...), the same on
    every rank of the pp line; B must split into ``num_microbatches``
    (default S) microbatches. Returns the full batch's output, replicated
    on every pp rank, in x's dtype. S = 1 is ``stage_fn(stage_params, x)``."""
    comm = mesh.comm(axis)
    S = comm.size
    if S == 1:
        return stage_fn(stage_params, x)
    M = num_microbatches or S
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    xs = x.float().reshape(M, B // M, *x.shape[1:])
    params = _leaves(stage_params)
    build = torch.is_grad_enabled()
    out = _GPipe.apply(xs, stage_fn, stage_params, comm, x.dtype, build, *params)
    return out.reshape(x.shape).to(x.dtype)
