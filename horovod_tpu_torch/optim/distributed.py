"""DistributedOptimizer, DistributedGradientTape and
distributed_value_and_grad (counterpart of
``horovod_tpu/optim/distributed.py``).

``DistributedOptimizer`` wraps a ``torch.optim.Optimizer``: before the
inner optimizer steps, every gradient is all-reduced across the ranks, in
one grouped collective (flatten, one all-reduce, split), with AVERAGE as
SUM then 1/size and the pre/postscale factors of the JAX package. With
``compression`` each gradient is compressed first, all-reduced in the
compressed dtype (a bf16 sum for ``Compression.fp16``, as the JAX package
sums) and then decompressed.

``backward_passes_per_step=k`` follows ``optax.MultiSteps``, which the JAX
wrapper uses: ``step()`` is called after every backward pass, the wrapper
keeps the running mean of the k gradients, and on every k-th call it
all-reduces that mean and lets the inner optimizer step; on the other calls
the parameters do not change.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch

from .. import ops
from ..common.types import ReduceOp
from ..ops.compression import Compression

_GRAD_OPS = (ReduceOp.AVERAGE, ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX)


def _check_op(op: ReduceOp):
    if op not in _GRAD_OPS:
        raise NotImplementedError(f"reduce op {ReduceOp(op).name} is not ported yet")


def _allreduce_grads(grads: List[torch.Tensor], op: ReduceOp,
                     prescale_factor: float, postscale_factor: float,
                     compression, fuse: bool) -> List[torch.Tensor]:
    """Compress, all-reduce (one grouped collective when ``fuse``, else one
    per gradient) and decompress (ref: the JAX ``_allreduce_grads``)."""
    comp = compression or Compression.none
    packed = [comp.compress(g) for g in grads]
    wire = [c for c, _ in packed]
    if fuse:
        red = ops.grouped_allreduce(wire, op=op, prescale_factor=prescale_factor,
                                    postscale_factor=postscale_factor)
    else:
        red = [ops.allreduce(c, op=op, prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor) for c in wire]
    return [comp.decompress(r, ctx) for r, (_, ctx) in zip(red, packed)]


class DistributedOptimizer(torch.optim.Optimizer):
    """Wraps ``optimizer``; ``param_groups`` and ``state`` are the inner
    optimizer's own, so schedulers and ``state_dict`` see through."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 compression=None, zero=None, error_feedback=None):
        if zero:
            raise NotImplementedError("ZeRO-sharded optimizer state is not ported yet")
        if error_feedback:
            raise NotImplementedError("error feedback is not ported yet")
        _check_op(op)
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        # No Optimizer.__init__: the wrapper owns no parameters of its own.
        self._inner = optimizer
        self.op = op
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._passes = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}

    # The inner optimizer's groups, state and defaults, shared not copied.
    @property
    def param_groups(self):
        return self._inner.param_groups

    @property
    def state(self):
        return self._inner.state

    @property
    def defaults(self):
        return self._inner.defaults

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, state_dict):
        self._inner.load_state_dict(state_dict)

    def zero_grad(self, set_to_none: bool = True):
        self._inner.zero_grad(set_to_none=set_to_none)

    def __repr__(self):
        return f"DistributedOptimizer({self._inner!r}, op={self.op.name})"

    def _params_with_grad(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]
                if p.grad is not None]

    def synchronize(self) -> None:
        """All-reduce every ``.grad`` in place, in one grouped collective."""
        params = self._params_with_grad()
        if not params:
            return
        reduced = _allreduce_grads([p.grad for p in params], self.op,
                                   self.prescale_factor, self.postscale_factor,
                                   self.compression, fuse=True)
        with torch.no_grad():
            for p, r in zip(params, reduced):
                p.grad.copy_(r)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("step(closure) is not supported")
        k = self.backward_passes_per_step
        if k > 1:
            self._passes += 1
            for p in self._params_with_grad():
                acc = self._acc.get(p)
                if acc is None:
                    self._acc[p] = p.grad.detach().clone()
                else:
                    acc.add_(p.grad)
            if self._passes % k:
                return None
            for p, acc in self._acc.items():
                p.grad = acc.div_(k)
            self._acc = {}
        self.synchronize()
        return self._inner.step()


# ---------------------------------------------------------------------------
# The functional spelling: gradients of fun(params, *args) with respect to a
# dict of tensors, the torch form of jax.value_and_grad.
def _check_axis(axis_name: Optional[str]):
    # The port's mesh knows only dp (parallel/mesh.py), whose collectives
    # run over the world group.
    if axis_name not in (None, "dp"):
        raise ValueError(f"axis_name={axis_name!r}: the port's mesh has only 'dp'")


def _value_and_grad(fun: Callable, has_aux: bool, params: Mapping[str, torch.Tensor],
                    *args, **kwargs):
    """``fun(params, *args, **kwargs)`` and its gradients with respect to
    ``params``, a dict of name -> tensor (a model's ``named_parameters`` or
    ``state_dict``, fed to ``torch.func.functional_call`` inside ``fun``).
    The value (and aux) come back detached, the gradients as a dict of the
    same keys; a tensor the value does not depend on gets zeros."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        out = fun(leaves, *args, **kwargs)
        value, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    value = value.detach()
    return ((value, aux) if has_aux else value), grads


def _reduce_dict(grads: Dict[str, torch.Tensor], op, compression, fuse):
    red = _allreduce_grads(list(grads.values()), op, 1.0, 1.0, compression, fuse)
    return dict(zip(grads, red))


class DistributedGradientTape:
    """TF's DistributedGradientTape in the JAX package's shape
    (ref: horovod/tensorflow/__init__.py:507-572): ``gradient(params,
    *args)`` returns ``fun``'s value and its gradients with respect to
    ``params``, each gradient all-reduced on its own (no fusion)."""

    def __init__(self, fun: Callable, op: ReduceOp = ReduceOp.AVERAGE,
                 compression=None, axis_name: Optional[str] = None,
                 has_aux: bool = False):
        _check_op(op)
        _check_axis(axis_name)
        self._fun = fun
        self._op = op
        self._compression = compression
        self._has_aux = has_aux

    def gradient(self, *args, **kwargs):
        val, grads = _value_and_grad(self._fun, self._has_aux, *args, **kwargs)
        return val, _reduce_dict(grads, self._op, self._compression, False)


def distributed_value_and_grad(fun: Callable, op: ReduceOp = ReduceOp.AVERAGE,
                               axis_name: Optional[str] = None,
                               has_aux: bool = False, fuse: bool = True,
                               compression=None) -> Callable:
    """``jax.value_and_grad`` plus the gradient all-reduce in one transform:
    the returned function takes ``(params, *args)`` and returns
    ``(value, grads)``, the gradients all-reduced in one grouped collective
    when ``fuse`` is set, else one each."""
    _check_op(op)
    _check_axis(axis_name)

    def wrapped(*args, **kwargs):
        val, grads = _value_and_grad(fun, has_aux, *args, **kwargs)
        return val, _reduce_dict(grads, op, compression, fuse)

    return wrapped
