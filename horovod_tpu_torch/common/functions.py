"""Parameter and optimizer-state broadcast (counterpart of
``horovod_tpu/common/functions.py``; ref: horovod/torch/functions.py:30-107).

Both broadcast in place, as Horovod's PyTorch API does, so every rank
starts from root's weights and optimizer state.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Tuple, Union

import torch

from . import basics
from .. import ops

Params = Union[Mapping[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]],
               torch.nn.Module]


def _broadcast_tensor_(t: torch.Tensor, root_rank: int) -> None:
    dev = basics.device()
    with torch.no_grad():
        if t.device.type == dev.type:
            ops.broadcast_(t, root_rank)
        else:
            # A tensor held elsewhere (AdamW keeps `step` on the CPU) rides
            # the rank's device for the collective and is copied back.
            t.copy_(ops.broadcast_(t.to(dev), root_rank))


def broadcast_parameters(params: Params, root_rank: int = 0) -> None:
    """Broadcast a module's parameters and buffers, a ``state_dict``, or
    ``named_parameters()`` pairs from root, in place."""
    if isinstance(params, torch.nn.Module):
        items = params.state_dict(keep_vars=True).items()
    elif isinstance(params, Mapping):
        items = params.items()
    else:
        items = params
    for _, t in sorted(items, key=lambda kv: kv[0]):
        _broadcast_tensor_(t.data if isinstance(t, torch.nn.Parameter) else t,
                           root_rank)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast every tensor of the optimizer's state from root, in place.
    State that is still empty (before the first step) is the same on every
    rank and needs nothing."""
    state = optimizer.state_dict()["state"]
    for pid in sorted(state):
        for key in sorted(state[pid]):
            val = state[pid][key]
            if isinstance(val, torch.Tensor):
                _broadcast_tensor_(val, root_rank)
