"""``horovod_tpu_torch.torch``: the ``horovod.torch`` surface (counterpart of
``horovod_tpu/torch/__init__.py``; ref: horovod/torch/mpi_ops.py,
horovod/torch/optimizer.py, horovod/torch/functions.py).

    import horovod_tpu_torch.torch as hvd
    hvd.init()
    optimizer = hvd.DistributedOptimizer(optimizer,
                                         named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

Tensors ride the port's eager engine (``horovod_tpu_torch.engine``) on the
rank's device: a CUDA tensor is reduced by NCCL where it lies and never
passes through host memory. Beside the port's collectives this module has
the in-place forms (``allreduce_``, ``allreduce_async_``, ``broadcast_``,
``broadcast_async_``, whose ``synchronize`` writes the result into the
tensor), the differentiable ``allreduce`` (its backward all-reduces the
cotangent with the same op), and the hook ``DistributedOptimizer``
(``torch/optimizer.py``). The top-level
``horovod_tpu_torch.DistributedOptimizer`` is another class: the port's
bucketed, overlapped data-parallel optimizer. ``TorchState``
(``torch/elastic.py``) is the elastic state of a model and its optimizer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..common.basics import (  # noqa: F401  (re-exported API surface)
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    gloo_built,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    nccl_built,
    rank,
    rocm_built,
    shutdown,
    size,
)
from ..common.functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from ..common.types import Adasum, Average, Max, Min, Product, ReduceOp, Sum  # noqa: F401
from .. import ops as _ops
from ..ops import (  # noqa: F401
    allgather,
    allgather_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    join,
    poll,
)
from ..ops.compression import Compression  # noqa: F401
from .elastic import TorchState  # noqa: F401
from .optimizer import DistributedOptimizer  # noqa: F401

# handle -> (kind, tensor) of the in-place forms, whose synchronize writes
# the result back into the caller's tensor.
_inplace: Dict[int, Tuple[str, torch.Tensor]] = {}


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0) -> int:
    """(ref: horovod/torch/mpi_ops.py:117-161)"""
    return _ops.allreduce_async(tensor, average=average, name=name, op=op,
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor)


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0) -> int:
    """In-place form: ``synchronize`` writes the result into ``tensor``."""
    h = allreduce_async(tensor, average, name, op, prescale_factor, postscale_factor)
    _inplace[h] = ("allreduce_", tensor)
    return h


def broadcast_async_(tensor, root_rank, name=None) -> int:
    h = _ops.broadcast_async(tensor, root_rank, name=name)
    _inplace[h] = ("broadcast_", tensor)
    return h


def synchronize(handle: int):
    """The result of the collective behind ``handle``; an in-place form's
    tensor, now holding it (ref: mpi_ops.py synchronize)."""
    kind, tensor = _inplace.pop(handle, (None, None))
    out = _ops.synchronize(handle)
    if kind is None:
        return out
    with torch.no_grad():
        tensor.copy_(out.reshape(tensor.shape))
    return tensor


def _allreduce_impl(tensor, name, rop, prescale_factor, postscale_factor):
    return _ops.allreduce(tensor, name=name, op=rop, prescale_factor=prescale_factor,
                          postscale_factor=postscale_factor)


class _HorovodAllreduce(torch.autograd.Function):
    """Backward of allreduce is allreduce of the cotangent with the same op
    (ref: torch/mpi_ops.py:161-177 HorovodAllreduce)."""

    @staticmethod
    def forward(ctx, tensor, name, rop, pre, post):
        ctx.hvd_args = (name, rop, pre, post)
        return _allreduce_impl(tensor, name, rop, pre, post)

    @staticmethod
    def backward(ctx, grad_output):
        name, rop, pre, post = ctx.hvd_args
        g = _allreduce_impl(grad_output.contiguous(),
                            f"{name}.grad" if name else None, rop, pre, post)
        return g, None, None, None, None


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0):
    """All-reduce; differentiable when ``tensor`` requires grad."""
    rop = _ops._resolve_op(op, average)
    if tensor.requires_grad and torch.is_grad_enabled():
        return _HorovodAllreduce.apply(tensor, name, rop, prescale_factor,
                                       postscale_factor)
    return _allreduce_impl(tensor, name, rop, prescale_factor, postscale_factor)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0):
    return synchronize(allreduce_async_(tensor, average, name, op, prescale_factor,
                                        postscale_factor))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0):
    return _ops.grouped_allreduce(tensors, average=average, name=name, op=op,
                                  prescale_factor=prescale_factor,
                                  postscale_factor=postscale_factor)


def broadcast_(tensor, root_rank, name=None):
    return synchronize(broadcast_async_(tensor, root_rank, name))
