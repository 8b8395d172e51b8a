"""wrap_step: run a step function SPMD over a mesh axis (counterpart of
``horovod_tpu/parallel/step.py``).

The user writes a one-rank step that calls ``hvd.allreduce`` (or steps a
``DistributedOptimizer``); ``wrap_step`` hands each rank its slice of the
sharded arguments along dim 0, the slice of its index along the axis, and
runs ``fn`` with the port's collectives bound to that axis by default, as
the JAX decorator ``shard_map``s the step over the axis and binds the hvd
collectives to it. Gradients stay rank-local until the explicit
all-reduce, Horovod's semantics (ref: horovod/torch/optimizer.py:114-149).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from .. import ops
from .mesh import Mesh, create_mesh, current_mesh, default_axis


def _default_axis(mesh: Mesh) -> str:
    if "dp" in mesh.axis_names:
        return "dp"
    if len(mesh.axis_names) == 1:
        return mesh.axis_names[0]
    raise ValueError(f"wrap_step: pass axis_name= (mesh axes {mesh.axis_names})")


def wrap_step(fn: Callable = None, *, mesh: Optional[Mesh] = None,
              axis_name=None, sharded_argnums: Optional[Sequence[int]] = None,
              replicated_argnums: Sequence[int] = (0,), out_replicated: bool = True):
    """Decorate a step function for SPMD execution over ``axis_name`` of
    ``mesh`` (the current mesh, or ``{"dp": size()}`` when there is none;
    the axis defaults to ``dp``).

    Argument 0 is replicated and every other one is sharded along its
    leading dim by default (``sharded_argnums`` names the sharded ones
    instead); tensors inside a sharded argument's pytree are cut, other
    leaves pass through. Inside ``fn`` the collectives and optimizers
    given no ``axis_name`` bind to the axis. The output is returned as is
    (``out_replicated=True``: the step's collectives made it equal on every
    rank), or with ``out_replicated=False`` each tensor of it is gathered
    along dim 0 over the axis in rank order, as JAX's ``P(axis)`` output.

    Usage::

        @hvd.wrap_step
        def train_step(w, xb): ...
    """
    if fn is None:
        return functools.partial(wrap_step, mesh=mesh, axis_name=axis_name,
                                 sharded_argnums=sharded_argnums,
                                 replicated_argnums=replicated_argnums,
                                 out_replicated=out_replicated)

    @functools.wraps(fn)
    def wrapped(*args):
        m = mesh or current_mesh() or create_mesh()
        an = axis_name if axis_name is not None else _default_axis(m)
        comm = m.comm(an)
        repl = set(replicated_argnums)
        if sharded_argnums is not None:
            repl = set(range(len(args))) - set(sharded_argnums)

        def cut(x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0:
                return x
            if x.shape[0] % comm.size:
                raise ValueError(f"wrap_step: dim 0 ({x.shape[0]}) does not split over "
                                 f"{an}={comm.size}")
            per = x.shape[0] // comm.size
            return x[comm.rank * per:(comm.rank + 1) * per]

        local = [a if i in repl else pytree.tree_map(cut, a) for i, a in enumerate(args)]
        with default_axis(an, m):
            out = fn(*local)
        if out_replicated:
            return out
        return pytree.tree_map(
            lambda t: ops.allgather(t, axis_name=comm) if isinstance(t, torch.Tensor) else t,
            out)

    return wrapped
