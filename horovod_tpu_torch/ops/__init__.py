"""Collectives over the process group (counterpart of the
``horovod_tpu/ops/__init__.py`` entry points and ``ops/traced.py:127-210``).

``torch.distributed`` plays the part XLA's psum plays in the JAX package:
NCCL between cards, gloo on the CPU. AVERAGE is SUM followed by a 1/size
postscale; prescale and postscale multiply in the tensor's own dtype, and
integer tensors scale through f32 so 1/size does not truncate to zero
(ref: ScaleBuffer, collective_operations.h:89-125).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common import basics
from ..common.types import ReduceOp

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    if factor is None or factor == 1.0:
        return x
    if not (x.is_floating_point() or x.is_complex()):
        return (x.to(torch.float32) * factor).to(x.dtype)
    return x * factor


def _check_device(t: torch.Tensor, what: str):
    dev = basics.device()
    if t.device.type != dev.type:
        raise ValueError(f"{what}: tensor on {t.device}, this rank runs on {dev}")


def _reduce_inplace(x: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    if op not in _DIST_OPS:
        raise NotImplementedError(f"reduce op {op!r} is not ported yet")
    dist.all_reduce(x, op=_DIST_OPS[op])
    if op == ReduceOp.AVERAGE:
        x = _scale(x, 1.0 / basics.size())
    return x


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """All-reduce across ranks; returns a new tensor, the input is kept."""
    _check_device(tensor, "allreduce")
    x = _scale(tensor, prescale_factor)
    x = x.clone() if x is tensor else x
    return _scale(_reduce_inplace(x, op), postscale_factor)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Fused all-reduce of a list: flatten into one buffer of the widest
    dtype, one collective, split back (ref: the fusion buffer,
    controller.cc:686-809; ``ops/traced.py`` grouped_allreduce)."""
    if not tensors:
        return []
    for t in tensors:
        _check_device(t, "grouped_allreduce")
    widest = tensors[0].dtype
    for t in tensors[1:]:
        widest = torch.promote_types(widest, t.dtype)
    flat = torch.cat([t.reshape(-1).to(widest) for t in tensors])
    red = allreduce(flat, op, prescale_factor, postscale_factor)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(red[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return out


def broadcast(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """A copy of root's tensor on every rank."""
    _check_device(tensor, "broadcast")
    out = tensor.clone()
    dist.broadcast(out, src=root_rank)
    return out


def broadcast_(tensor: torch.Tensor, root_rank: int = 0) -> torch.Tensor:
    """In-place broadcast from root."""
    _check_device(tensor, "broadcast_")
    dist.broadcast(tensor, src=root_rank)
    return tensor


def barrier() -> None:
    basics._require_init()
    dist.barrier()
