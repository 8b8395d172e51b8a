"""The data-parallel training step (counterpart of
``horovod_tpu/parallel/train.py:55-296``).

The JAX package builds one jitted SPMD step whose batch is sharded over the
``dp`` axis. Here each rank runs the same eager step on its own slice of
the global batch; the model's gradients are averaged across ranks by the
``DistributedOptimizer`` the caller wraps its optimizer in, and the step
returns the loss averaged across ranks, which is the global-batch loss the
JAX step returns when the loss is a mean over equal slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..common.functions import broadcast_optimizer_state, broadcast_parameters
from ..common.types import ReduceOp
from .mesh import Mesh


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; the log-softmax runs in f32 whatever the logits'
    dtype."""
    logp = F.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -picked.mean()


def lm_loss(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Next-token prediction loss for causal LMs."""
    return softmax_xent(logits[:, :-1], ids[:, 1:])


@dataclasses.dataclass
class TrainState:
    """The step count; the model and optimizer hold the tensors."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def _shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n, r = mesh.shape["dp"], mesh.coords["dp"]
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not split over dp={n}")
    per = x.shape[0] // n
    return x[r * per:(r + 1) * per]


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable, *, mesh: Mesh
                    ) -> Tuple[Callable[[], TrainState], Callable]:
    """Returns ``(init_fn, step_fn)``.

    ``init_fn()`` broadcasts the parameters and optimizer state from rank 0
    and returns the initial ``TrainState``. ``step_fn(state, inputs,
    labels)`` takes the global batch, puts the model in train mode (batch
    statistics, running-stat updates), runs this rank's ``dp`` slice of it
    forward and backward, steps ``optimizer`` (a ``DistributedOptimizer``
    for the gradients to be averaged), and returns ``(state, loss)`` with
    the loss averaged over ranks (a detached scalar on the device)."""

    def init_fn() -> TrainState:
        broadcast_parameters(model, root_rank=0)
        broadcast_optimizer_state(optimizer, root_rank=0)
        return TrainState(step=0, model=model, optimizer=optimizer)

    def step_fn(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor):
        x = _shard(inputs, mesh).to(mesh.device)
        y = _shard(labels, mesh).to(mesh.device)
        model.train()   # batch statistics, as the JAX step's train=True
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        optimizer.step()
        # Every rank averages one scalar here: no header exchange.
        loss = ops._allreduce(loss.detach(), ReduceOp.AVERAGE)
        return dataclasses.replace(state, step=state.step + 1), loss

    return init_fn, step_fn
