"""The stateless wire casts of the all-reduce (counterpart of
``horovod_tpu/ops/traced.py:30-125``).

``HOROVOD_WIRE_COMPRESSION=bf16|fp16|auto`` (auto is bf16) makes an f32
SUM or AVERAGE all-reduce of at least ``HOROVOD_WIRE_COMPRESSION_MIN_BYTES``
bytes travel, and sum, in the narrow dtype; the result is cast back to f32.
``HOROVOD_WIRE_COMPRESSION_INT8=1``, with a mode other than none, takes
the int8 lane instead: each rank quantises its tensor to int8 with one f32
scale (max|x|/127), the ranks all-gather the int8 payload and the scales,
and every rank decodes and sums in f32 in rank order. The casts carry no
state; ``DistributedOptimizer(error_feedback=True)`` keeps the residual
(``optim/zero.py``). The knobs are read per call.

Only tensor functions live here, and the all-gather they ride; the entry
points that apply the casts are in ``ops/__init__.py``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..common import basics
from ..common import env
from ..common.types import ReduceOp

_CASTABLE = (ReduceOp.SUM, ReduceOp.AVERAGE)


def _engages(x: torch.Tensor, op: ReduceOp) -> bool:
    return (op in _CASTABLE and x.dtype == torch.float32
            and env.wire_compression_mode() != "none"
            and x.numel() * x.element_size() >= env.wire_compression_min_bytes())


def wire_dtype(x: torch.Tensor, op: ReduceOp) -> Optional[torch.dtype]:
    """The dtype ``x`` is cast to before the all-reduce, or None for full
    width (ref: ``_traced_wire_dtype``)."""
    if not _engages(x, op):
        return None
    return torch.float16 if env.wire_compression_mode() == "fp16" else torch.bfloat16


def int8_enabled(x: torch.Tensor, op: ReduceOp) -> bool:
    """Whether ``x`` takes the int8 lane (ref: ``_traced_int8_enabled``)."""
    return env.wire_compression_int8() and _engages(x, op)


def int8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``(q, scale)`` with x ≈ q·scale, scale =
    max|x|/127 floored at 1e-30 (an all-zero tensor), q rounded half to
    even and clipped to ±127."""
    scale = torch.clamp_min(x.abs().max() / 127.0, 1e-30)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class Works:
    """The ``torch.distributed`` works of one launch, waited on together."""

    def __init__(self, works):
        self._works = [w for w in works if w is not None]

    def wait(self) -> None:
        for w in self._works:
            w.wait()

    def is_completed(self) -> bool:
        return all(w.is_completed() for w in self._works)


def all_gather_launch(x: torch.Tensor, async_op: bool, comm=None
                      ) -> Tuple[Optional[object], Callable[[], torch.Tensor]]:
    """Launch the all-gather of equal-shaped ``x`` from every member of
    ``comm`` (the world by default); returns ``(work, finish)`` where
    ``finish()`` gives the ``(size, *x.shape)`` stack in rank order. NCCL
    gathers into one tensor; the list form is the one every backend has."""
    group = None if comm is None else comm.group
    n = basics.size() if comm is None else comm.size
    x = x.contiguous()
    if comm is not None and comm.trivial:
        return None, lambda: x[None]
    if dist.get_backend() == "nccl":
        out = x.new_empty((n, *x.shape))
        work = dist.all_gather_into_tensor(out, x, group=group, async_op=async_op)
        return work, lambda: out
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
    work = dist.all_gather(parts, x, group=group, async_op=async_op)
    return work, lambda: torch.stack(parts)


def int8_allreduce_launch(x: torch.Tensor, async_op: bool, comm=None
                          ) -> Tuple[Works, Callable[[], torch.Tensor]]:
    """The int8 lane's SUM of f32 ``x``: quantise, all-gather the int8
    payload and the scales, decode and add in rank order in f32
    (ref: ``_int8_allreduce``); ``finish()`` returns the f32 sum."""
    q, scale = int8_encode(x)
    wq, qs = all_gather_launch(q, async_op, comm)
    ws, ss = all_gather_launch(scale.reshape(1), async_op, comm)

    def finish():
        parts, scales = qs(), ss()
        out = int8_decode(parts[0], scales[0])
        for p in range(1, parts.shape[0]):
            out = out + int8_decode(parts[p], scales[p])
        return out

    return Works([wq, ws]), finish
