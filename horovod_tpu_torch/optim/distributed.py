"""DistributedOptimizer as a ``torch.optim.Optimizer`` wrapper.

Counterpart of ``horovod_tpu/optim/distributed.py:112-198``: before the
inner optimizer steps, every gradient is all-reduced across the ranks, in
one grouped collective (flatten, one all-reduce, split), with AVERAGE as
SUM then 1/size and the pre/postscale factors of the JAX package.

``backward_passes_per_step=k`` follows ``optax.MultiSteps``, which the JAX
wrapper uses: ``step()`` is called after every backward pass, the wrapper
keeps the running mean of the k gradients, and on every k-th call it
all-reduces that mean and lets the inner optimizer step; on the other calls
the parameters do not change.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .. import ops
from ..common.types import ReduceOp


class DistributedOptimizer(torch.optim.Optimizer):
    """Wraps ``optimizer``; ``param_groups`` and ``state`` are the inner
    optimizer's own, so schedulers and ``state_dict`` see through."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 compression=None, zero=None, error_feedback=None):
        if compression is not None:
            raise NotImplementedError("gradient compression is not ported yet")
        if zero:
            raise NotImplementedError("ZeRO-sharded optimizer state is not ported yet")
        if error_feedback:
            raise NotImplementedError("error feedback is not ported yet")
        if op not in (ReduceOp.AVERAGE, ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX):
            raise NotImplementedError(f"reduce op {op!r} is not ported yet")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        # No Optimizer.__init__: the wrapper owns no parameters of its own.
        self._inner = optimizer
        self.op = op
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
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
        reduced = ops.grouped_allreduce(
            [p.grad for p in params], self.op, self.prescale_factor,
            self.postscale_factor)
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
