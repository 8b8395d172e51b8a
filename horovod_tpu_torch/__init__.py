"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` gives the Horovod surface under the
JAX package's names: process-group init and topology, the ``*_built``
flags, the collectives (allreduce, grouped_allreduce, allgather,
broadcast, alltoall, reducescatter, barrier, join) with their ``*_async``
forms, ``poll`` and ``synchronize`` (over the world through the eager
engine, ``horovod_tpu_torch.engine``), the object collectives,
``Compression``,
``DistributedOptimizer`` (with ZeRO, error feedback, Adasum and the
all-reduce overlapped with backward), ``DistributedGradientTape``,
``distributed_value_and_grad``, parameter/optimizer-state broadcast,
``adasum_allreduce``, ``SyncBatchNorm`` and ``sync_batch_stats``, and the
``zero`` module (``recut_state``, ``status_snapshot``, ``state_to_global``,
``state_from_global``), the mesh (``create_mesh``, ``create_hybrid_mesh``;
``axis_name=`` on every collective and optimizer), ``wrap_step``, and the
sequence-parallel attention ``ring_attention``, ``ulysses_attention`` and
``dense_attention``.
The ``horovod.torch`` binding surface (in-place collectives, the
differentiable all-reduce, the hook ``DistributedOptimizer``) is
``horovod_tpu_torch.torch``. Elastic training is ``hvd.elastic``
(``State``, ``ObjectState``, ``TorchState``, ``@hvd.elastic.run``), launched by
``python -m horovod_tpu_torch.runner.launch``. Models live in ``horovod_tpu_torch.models``, the training step in
``horovod_tpu_torch.parallel``, the kernels in ``horovod_tpu_torch.ops``.
The package imports torch and never jax, nor anything of ``horovod_tpu``.
"""
from .common.basics import (
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    device,
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
    tcp_built,
    xla_built,
)
from .common.exceptions import HorovodInternalError, HostsUpdatedInterrupt, NotInitializedError
from .common.functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .common.types import Adasum, Average, Max, Min, Product, ReduceOp, Sum
from .ops import (
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    grouped_allreduce,
    join,
    poll,
    reducescatter,
    synchronize,
)
from .ops.adasum import adasum_allreduce
from .ops.compression import Compression
from .ops.sync_batch_norm import SyncBatchNorm, sync_batch_stats
from .optim import zero
from .optim.distributed import (
    DistributedGradientTape,
    DistributedOptimizer,
    distributed_value_and_grad,
)
from .parallel.mesh import AXIS_ORDER, create_hybrid_mesh, create_mesh
from .parallel.ring import dense_attention, ring_attention
from .parallel.step import wrap_step
from .parallel.ulysses import ulysses_attention

from . import elastic  # noqa: E402  (last: it imports the binding)

__version__ = "0.1.0"
