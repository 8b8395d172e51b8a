"""Parameter, optimizer-state and object collectives (counterpart of
``horovod_tpu/common/functions.py``; ref: horovod/torch/functions.py:30-262).

The parameter and optimizer-state broadcasts work in place, as Horovod's
PyTorch API does, so every rank starts from root's weights and optimizer
state. The object collectives pickle, send the byte count first and then
the bytes, through the port's own ``broadcast``/``allgather`` on the
rank's device.
"""
from __future__ import annotations

import pickle
from typing import Any, Iterable, List, Mapping, Optional, Tuple, Union

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


def _plain_step(optimizer: torch.optim.Optimizer) -> None:
    """The wrapped optimizer's own step, which reduces nothing: the
    binding's hook wrapper keeps its class in ``_hvd_opt_cls``, the
    top-level ``DistributedOptimizer`` its optimizer in ``_inner``."""
    cls = getattr(optimizer, "_hvd_opt_cls", None)
    if cls is not None:
        cls.step(optimizer)
    else:
        getattr(optimizer, "_inner", optimizer).step()


def _init_state(optimizer: torch.optim.Optimizer) -> None:
    """Give an optimizer its state by one step on zero gradients, leaving
    the parameters and gradients as they were (ref: horovod/torch/
    functions.py:97-115, which keeps the parameters the step moved)."""
    params = [p for g in optimizer.param_groups for p in g["params"] if p.requires_grad]
    kept = [(p, p.detach().clone(), p.grad) for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    _plain_step(optimizer)
    with torch.no_grad():
        for p, data, grad in kept:
            p.copy_(data)
            p.grad = grad


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast every tensor of the optimizer's state from root, in place.
    A rank whose state is still empty while root's is not (a worker that
    joined an elastic job) first makes its state by one step on zero
    gradients, its parameters kept. A ZeRO-sharded ``DistributedOptimizer``
    holds a different shard on every rank, so there is nothing to
    broadcast."""
    if getattr(optimizer, "_zero", None) is not None:
        return
    if basics.size() > 1:
        root_held = broadcast_object(bool(optimizer.state), root_rank,
                                     name="optimizer_state.held")
        if root_held and not optimizer.state:
            _init_state(optimizer)
    state = optimizer.state_dict()["state"]
    for pid in sorted(state):
        for key in sorted(state[pid]):
            val = state[pid][key]
            if isinstance(val, torch.Tensor):
                _broadcast_tensor_(val, root_rank)


def _to_bytes(obj: Any) -> torch.Tensor:
    payload = bytearray(pickle.dumps(obj))
    return torch.frombuffer(payload, dtype=torch.uint8).to(basics.device())


def broadcast_object(obj: Any = None, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Root's ``obj`` on every rank (ref: horovod/torch/functions.py:186-227).
    Unpickles what root sent, so every rank must trust root."""
    if basics.size() == 1:
        return obj
    nm = name or "broadcast_object"
    dev = basics.device()
    if basics.rank() == root_rank:
        data = _to_bytes(obj)
        count = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    else:
        count = torch.zeros(1, dtype=torch.int64, device=dev)
    count = ops.broadcast(count, root_rank, name=f"{nm}.size")
    if basics.rank() != root_rank:
        data = torch.empty(int(count.item()), dtype=torch.uint8, device=dev)
    data = ops.broadcast(data, root_rank, name=f"{nm}.data")
    return pickle.loads(data.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """Every rank's ``obj``, in rank order
    (ref: horovod/torch/functions.py:229-262)."""
    if basics.size() == 1:
        return [obj]
    nm = name or "allgather_object"
    data = _to_bytes(obj)
    counts = ops.allgather(torch.tensor([data.numel()], dtype=torch.int64,
                                        device=data.device), name=f"{nm}.size")
    data = ops.allgather(data, name=f"{nm}.data").cpu().numpy()
    out, off = [], 0
    for count in counts.tolist():
        out.append(pickle.loads(data[off:off + count].tobytes()))
        off += count
    return out
