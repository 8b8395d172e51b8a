"""Collective-op registry with Enabled() priority dispatch (counterpart of
``horovod_tpu/engine/operation_manager.py``; ref:
horovod/common/ops/operation_manager.{h,cc}:42-122: per response type an
ordered list of implementations, the first whose Enabled() holds runs).

The port's lists, most specialised first: at a world of one the local
ops (the JAX package's ``LocalBackend``); else NCCL for CUDA tensors, at
the top, and gloo for CPU tensors. A CUDA tensor never takes the gloo op
and never passes through host memory. ADASUM responses take the port's
``ops/adasum.py`` combine on the channel's group. Every op runs on the
process group of the channel its response was assigned (``Channel``), on
that channel's thread and, for CUDA, its stream. The all-reduce takes the
response's wire codec (``engine/controller.py`` CODEC_*): a cast to bf16
or fp16 around the sum, or the int8 lane of ``ops/wire.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common.message import ResponseType
from ..common.types import ReduceOp
from .controller import CODEC_BF16, CODEC_FP16, CODEC_INT8

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}
_CAST = {CODEC_BF16: torch.bfloat16, CODEC_FP16: torch.float16}


class OpEntry:
    """One registered implementation (ref: HorovodOp subclasses +
    Enabled(), collective_operations.h:38-257)."""

    def __init__(self, name: str, enabled: Callable[..., bool], execute: Callable):
        self.name = name
        self.enabled = enabled
        self.execute = execute


class OperationManager:
    def __init__(self):
        self._ops: Dict[ResponseType, List[OpEntry]] = {}

    def register(self, response_type: ResponseType, entry: OpEntry):
        self._ops.setdefault(response_type, []).append(entry)

    def select(self, response_type: ResponseType, **ctx) -> OpEntry:
        """First enabled op wins (ref: operation_manager.cc:99-116)."""
        for entry in self._ops.get(response_type, []):
            if entry.enabled(**ctx):
                return entry
        raise RuntimeError(f"no enabled op for {response_type!r} (ctx={ctx})")


# ---------------------------------------------------------------------------
# The data plane of the ops, on one channel (``chan``: its group, size,
# this rank, and a ``parallel.mesh.Comm`` over it).
def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it travels: bool as its uint8 view."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def allreduce(buf: torch.Tensor, rop: ReduceOp, chan, codec: int = 0) -> torch.Tensor:
    """Reduce the engine-owned ``buf`` (in place where it can) over the
    channel; returns the result in ``buf``'s dtype."""
    if codec == CODEC_INT8:
        from ..ops import wire

        return wire.int8_allreduce_launch(buf, False, chan.comm)[1]()
    dt = _CAST.get(codec)
    # bool reduces as uint8 (SUM and MAX are a logical or, MIN an and).
    x = buf.to(dt) if dt is not None else (
        buf.to(torch.uint8) if buf.dtype == torch.bool else buf)
    dist.all_reduce(x, op=_DIST_OPS[rop], group=chan.group)
    return x if x.dtype == buf.dtype else x.to(buf.dtype)


def adasum(buf: torch.Tensor, rop=None, chan=None, codec: int = 0) -> torch.Tensor:
    from ..ops.adasum import adasum_allreduce

    return adasum_allreduce(buf, chan.comm)


def allgather(t: torch.Tensor, sizes: Sequence[int], chan) -> torch.Tensor:
    """The ranks' ``t`` (first dims ``sizes``, in rank order) concatenated:
    each pads to the longest, all gather, every part sliced to its rows."""
    from ..ops import wire

    longest = max(sizes)
    buf = _wire(t).contiguous()
    if t.shape[0] < longest:
        buf = torch.cat([buf, buf.new_zeros(longest - t.shape[0], *t.shape[1:])])
    parts = wire.all_gather_launch(buf, False, chan.comm)[1]()
    out = torch.cat([parts[p, :r] for p, r in enumerate(sizes)])
    return out.view(torch.bool) if t.dtype == torch.bool else out


def broadcast(t: torch.Tensor, root: int, chan) -> torch.Tensor:
    out = t.clone() if chan.rank == root else torch.empty_like(t)
    dist.broadcast(_wire(out), src=root, group=chan.group)
    return out


def alltoall(t: torch.Tensor, splits: Sequence[int], chan) -> Tuple[torch.Tensor, List[int]]:
    """``splits[p]`` rows of dim 0 to rank p; the peers' rows in rank order
    and how many came from each. The receive counts are the peers' splits,
    exchanged first (the response carries none)."""
    mine = torch.tensor(list(splits), dtype=torch.int64, device=t.device)
    every = [torch.empty_like(mine) for _ in range(chan.size)]
    dist.all_gather(every, mine, group=chan.group)
    recv = [int(v) for v in torch.stack(every)[:, chan.rank].tolist()]
    buf = _wire(t).contiguous()
    out = buf.new_empty(sum(recv), *t.shape[1:])
    dist.all_to_all_single(out, buf, output_split_sizes=recv,
                           input_split_sizes=list(splits), group=chan.group)
    return (out.view(torch.bool) if t.dtype == torch.bool else out), recv


def _local_allgather(t, sizes, chan):
    return t.clone()


def _local_alltoall(t, splits, chan):
    return t.clone(), [int(s) for s in splits]


def build_default(size: int) -> OperationManager:
    """The registry of a world of ``size``; ``select`` takes ``device``,
    the tensor's device type."""
    mgr = OperationManager()
    if size == 1:
        def always(**_):
            return True

        mgr.register(ResponseType.ALLREDUCE, OpEntry(
            "LOCAL_ALLREDUCE", always, lambda buf, rop, chan, codec=0: buf))
        mgr.register(ResponseType.ADASUM, OpEntry(
            "LOCAL_ADASUM", always, lambda buf, rop, chan, codec=0: buf))
        mgr.register(ResponseType.ALLGATHER, OpEntry("LOCAL_ALLGATHER", always,
                                                     _local_allgather))
        mgr.register(ResponseType.BROADCAST, OpEntry(
            "LOCAL_BROADCAST", always, lambda t, root, chan: t.clone()))
        mgr.register(ResponseType.ALLTOALL, OpEntry("LOCAL_ALLTOALL", always,
                                                    _local_alltoall))
        return mgr

    def on(kind: str):
        return lambda device="cpu", **_: device == kind

    for prefix, kind in (("NCCL", "cuda"), ("GLOO", "cpu")):
        mgr.register(ResponseType.ALLREDUCE, OpEntry(f"{prefix}_ALLREDUCE", on(kind),
                                                     allreduce))
        mgr.register(ResponseType.ALLGATHER, OpEntry(f"{prefix}_ALLGATHER", on(kind),
                                                     allgather))
        mgr.register(ResponseType.BROADCAST, OpEntry(f"{prefix}_BROADCAST", on(kind),
                                                     broadcast))
        mgr.register(ResponseType.ALLTOALL, OpEntry(f"{prefix}_ALLTOALL", on(kind),
                                                    alltoall))
    mgr.register(ResponseType.ADASUM, OpEntry("ADASUM_VHDD", lambda **_: True, adasum))
    return mgr
