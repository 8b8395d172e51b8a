"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` gives the Horovod surface this slice
has ported: process-group init and topology, collectives, the
``DistributedOptimizer`` wrapper and parameter/optimizer-state broadcast.
Models live in ``horovod_tpu_torch.models``, the training step in
``horovod_tpu_torch.parallel``, the flash-attention kernels in
``horovod_tpu_torch.ops.flash_attention``. The package imports torch and
never jax, nor anything of ``horovod_tpu``.
"""
from .common.basics import (
    cross_rank,
    cross_size,
    device,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from .common.exceptions import HorovodInternalError, NotInitializedError
from .common.functions import broadcast_optimizer_state, broadcast_parameters
from .common.types import Adasum, Average, Max, Min, Product, ReduceOp, Sum
from .ops import allreduce, barrier, broadcast, grouped_allreduce
from .optim.distributed import DistributedOptimizer
from .parallel.mesh import create_mesh

__version__ = "0.1.0"
