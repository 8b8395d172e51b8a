"""Batch normalisation over the whole data-parallel batch (counterpart of
``horovod_tpu/ops/sync_batch_norm.py``; ``SyncBatchNorm`` follows
``horovod_tpu/torch/sync_batch_norm.py``; ref:
horovod/torch/sync_batch_norm.py:30-199).

Every rank holds a slice of the batch. The per-channel Σx, Σx² and the
element count go through one differentiable SUM all-reduce (the backward
all-reduces the cotangent, since every rank's loss depends on every
rank's slice), so each rank normalises with the global statistics and
gets the gradient the whole batch would give it. The count stays a
tensor: nothing on the path reads a value back to the host. The mean is
Σx/N and the variance E[x²] − E[x]², unclamped, in f32, as the JAX
``sync_batch_stats`` computes them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.modules.batchnorm import _BatchNorm

from ..common import basics


def _world() -> int:
    return basics.size() if basics.is_initialized() else 1


class _GlobalSum(torch.autograd.Function):
    """All-reduce SUM over the ranks; the gradient is all-reduced likewise
    (every rank's loss depends on every rank's contribution)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def _global_moments(x: torch.Tensor, dims: Sequence[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, var, count) over ``dims`` of every rank's ``x``, in f32."""
    xf = x.to(torch.float32)
    s1, s2 = xf.sum(dims), (xf * xf).sum(dims)
    local = 1
    for d in dims:
        local *= x.shape[d]
    count = torch.full((1,), float(local), device=x.device)
    if _world() > 1:
        c = s1.numel()
        packed = _GlobalSum.apply(torch.cat([s1.reshape(-1), s2.reshape(-1), count]))
        s1, s2, count = (packed[:c].view(s1.shape), packed[c:2 * c].view(s2.shape),
                         packed[2 * c:])
    mean = s1 / count
    return mean, s2 / count - mean * mean, count


def sync_batch_stats(x: torch.Tensor, reduce_dims: Optional[Sequence[int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance over ``reduce_dims`` (all but the last, the
    features, by default) and over the ranks (ref: the JAX
    ``sync_batch_stats``); differentiable."""
    if reduce_dims is None:
        reduce_dims = tuple(range(x.dim() - 1))
    mean, var, _ = _global_moments(x, tuple(reduce_dims))
    return mean, var


class SyncBatchNorm(_BatchNorm):
    """Drop-in for ``torch.nn.BatchNorm{1,2,3}d`` (channels at dim 1) whose
    training statistics cover every rank's slice of the batch. torch's
    conventions hold: ``momentum`` weighs the new statistic (``None`` is
    the cumulative average), the running variance is the unbiased one, eval
    mode uses the running statistics when it tracks them."""

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(input)
        if not self.training and self.track_running_stats:
            return F.batch_norm(input, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0, *range(2, input.dim())]
        mean, var, count = _global_moments(input, dims)
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
            factor = (1.0 / self.num_batches_tracked.to(torch.float32)
                      if self.momentum is None else self.momentum)
            with torch.no_grad():
                unbiased = var * (count / (count - 1).clamp_min(1))
                self.running_mean.mul_(1 - factor).add_(mean.detach() * factor)
                self.running_var.mul_(1 - factor).add_(unbiased * factor)
        shape = [1, -1] + [1] * (input.dim() - 2)
        out = (input.to(torch.float32) - mean.view(shape)) * torch.rsqrt(
            var.view(shape) + self.eps)
        if self.affine:
            out = out * self.weight.view(shape) + self.bias.view(shape)
        return out.to(input.dtype)
