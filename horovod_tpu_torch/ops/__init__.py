"""Collectives over the process group (counterpart of the
``horovod_tpu/ops/__init__.py`` entry points and ``ops/traced.py:127-355``).

``torch.distributed`` plays the part XLA's psum plays in the JAX package:
NCCL between cards, gloo on the CPU. AVERAGE is SUM followed by a 1/size
postscale; prescale and postscale multiply in the tensor's own dtype (the
factor rounded to it first, as the JAX ``_scale``), and integer tensors
scale through f32 so 1/size does not truncate to zero (ref: ScaleBuffer,
collective_operations.h:89-125).

The entry points take the JAX package's keywords: ``op=`` or the legacy
``average=`` (both at once raise ``ValueError``), and ``name=``, which
names the collective in errors (``torch.distributed`` negotiates nothing
by name, so it keys no cache here).

Shapes may differ between ranks where Horovod allows it: the first dim of
``allgather`` (ranks exchange their shapes first, pad to the largest,
gather, and slice in rank order) and the splits of ``alltoall`` (ranks
exchange their split counts first). The trailing dims and the dtype must
agree; where they do not, every rank raises ``HorovodInternalError``
naming the op and the shapes or dtypes, since every rank sees the same
exchanged shapes. bool tensors travel as their uint8 view.

The asynchronous forms (``*_async``, ``poll``, ``synchronize``) launch the
data collective with ``async_op=True`` and finish it (scale, slice, cast
back) in ``synchronize``; the shape exchange before it is synchronous. The
JAX package offers them only in process mode; the port always runs one
process per rank, so they work at every world size.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common import basics
from ..common.async_handles import HandleTable
from ..common.exceptions import HorovodInternalError
from ..common.types import ReduceOp

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}
# Codes for the dtypes in the shape exchange.
_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
           torch.bool]

_handles = HandleTable()


def _resolve_op(op: Optional[ReduceOp], average: Optional[bool]) -> ReduceOp:
    """(ref: horovod/torch/mpi_ops.py:83-110, the JAX ``_resolve_op``)"""
    if isinstance(average, ReduceOp):
        raise TypeError(f"average={average!r}: pass a reduce op as op=")
    if op is not None and average is not None:
        raise ValueError("specify either op= or the legacy average=, not both")
    if op is None:
        op = ReduceOp.AVERAGE if (average is None or average) else ReduceOp.SUM
    if op not in _DIST_OPS:
        raise NotImplementedError(f"reduce op {ReduceOp(op).name} is not ported yet")
    return ReduceOp(op)


def _scale(x: torch.Tensor, factor: float) -> torch.Tensor:
    if factor is None or factor == 1.0:
        return x
    if not (x.is_floating_point() or x.is_complex()):
        return (x.to(torch.float32) * factor).to(x.dtype)
    return x * float(torch.tensor(factor, dtype=x.dtype))


def _check_device(t: torch.Tensor, what: str):
    dev = basics.device()
    if t.device.type != dev.type:
        raise ValueError(f"{what}: tensor on {t.device}, this rank runs on {dev}")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it travels: bool as its uint8 view."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _label(op: str, name: Optional[str]) -> str:
    return op if name is None else f"{op} {name!r}"


# ---------------------------------------------------------------------------
# allreduce
def _reduce_launch(tensor: torch.Tensor, op: ReduceOp, prescale_factor: float,
                   postscale_factor: float, async_op: bool):
    """Launch the all-reduce of a fresh buffer; returns (work, finish)."""
    x = _scale(tensor, prescale_factor)
    x = x.clone() if x is tensor else x
    # bool reduces as uint8 (SUM and MAX are a logical or, MIN an and).
    buf = x.to(torch.uint8) if x.dtype == torch.bool else x
    work = dist.all_reduce(buf, op=_DIST_OPS[op], async_op=async_op)

    def finish():
        out = _scale(buf, 1.0 / basics.size()) if op == ReduceOp.AVERAGE else buf
        return _scale(out, postscale_factor).to(tensor.dtype)

    return work, finish


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """All-reduce across ranks; returns a new tensor, the input is kept."""
    rop = _resolve_op(op, average)
    _check_device(tensor, _label("allreduce", name))
    _, finish = _reduce_launch(tensor, rop, prescale_factor, postscale_factor, False)
    return finish()


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """(ref: horovod/torch/mpi_ops.py:117-161)"""
    rop = _resolve_op(op, average)
    _check_device(tensor, _label("allreduce_async", name))
    return _handles.put(*_reduce_launch(tensor, rop, prescale_factor,
                                        postscale_factor, True))


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: Optional[bool] = None, name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Fused all-reduce of a list: flatten into one buffer of the widest
    dtype, one collective, split back (ref: the fusion buffer,
    controller.cc:686-809; ``ops/traced.py`` grouped_allreduce)."""
    rop = _resolve_op(op, average)
    if not tensors:
        return []
    for t in tensors:
        _check_device(t, _label("grouped_allreduce", name))
    widest = tensors[0].dtype
    for t in tensors[1:]:
        widest = torch.promote_types(widest, t.dtype)
    flat = torch.cat([t.reshape(-1).to(widest) for t in tensors])
    red = allreduce(flat, op=rop, prescale_factor=prescale_factor,
                    postscale_factor=postscale_factor)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(red[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return out


# ---------------------------------------------------------------------------
# Shape exchange for the collectives whose first dim may differ by rank.
def _exchange_shapes(op: str, t: torch.Tensor, extra: Sequence[int] = ()
                     ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Every rank's (shape, extra) for ``t``, after checking that dtype and
    trailing dims agree. Two small all-gathers on the rank's device: the
    dtype code, the number of dims and of extras, then the dims and extras
    themselves (whose length the first round has made equal)."""
    n, dev = basics.size(), basics.device()
    if t.dtype not in _DTYPES:
        raise TypeError(f"{op}: dtype {t.dtype} is not supported")
    head = torch.tensor([_DTYPES.index(t.dtype), t.dim(), len(extra)],
                        dtype=torch.int64, device=dev)
    heads = [torch.empty_like(head) for _ in range(n)]
    dist.all_gather(heads, head)
    heads = torch.stack(heads).tolist()
    for r, (code, ndim, n_extra) in enumerate(heads):
        if code != heads[0][0]:
            raise HorovodInternalError(
                f"{op}: dtype mismatch, rank 0 has {_DTYPES[heads[0][0]]}, "
                f"rank {r} has {_DTYPES[code]}")
        if (ndim, n_extra) != tuple(heads[0][1:]):
            raise HorovodInternalError(
                f"{op}: rank 0 has a {heads[0][1]}-d tensor, rank {r} a {ndim}-d one")
    body = torch.tensor([*t.shape, *extra], dtype=torch.int64, device=dev)
    bodies = [torch.empty_like(body) for _ in range(n)]
    dist.all_gather(bodies, body)
    out = [(tuple(row[:t.dim()]), tuple(row[t.dim():]))
           for row in torch.stack(bodies).tolist()]
    for r, (shape, _) in enumerate(out):
        if shape[1:] != out[0][0][1:]:
            raise HorovodInternalError(
                f"{op}: trailing dims differ, rank 0 has shape {out[0][0]}, "
                f"rank {r} has shape {shape}")
    return out


# ---------------------------------------------------------------------------
# allgather
def _allgather_launch(tensor: torch.Tensor, name: Optional[str], async_op: bool):
    label = _label("allgather", name)
    _check_device(tensor, label)
    x = tensor.reshape(1) if tensor.dim() == 0 else tensor
    rows = [shape[0] for shape, _ in _exchange_shapes(label, x)]
    longest = max(rows)
    buf = _wire(x).contiguous()
    if x.shape[0] < longest:
        buf = torch.cat([buf, buf.new_zeros(longest - x.shape[0], *x.shape[1:])])
    parts = [torch.empty_like(buf) for _ in rows]
    work = dist.all_gather(parts, buf, async_op=async_op)

    def finish():
        out = torch.cat([p[:r] for p, r in zip(parts, rows)])
        return out.view(torch.bool) if tensor.dtype == torch.bool else out

    return work, finish


def allgather(tensor: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    """Concatenate the ranks' tensors along dim 0, in rank order; the first
    dims may differ, a 0-d tensor counts as shape (1,)
    (ref: collective_operations.h:148-185)."""
    return _allgather_launch(tensor, name, False)[1]()


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    return _handles.put(*_allgather_launch(tensor, name, True))


# ---------------------------------------------------------------------------
# broadcast
def _broadcast_launch(tensor: torch.Tensor, root_rank: int, name: Optional[str],
                      async_op: bool):
    _check_device(tensor, _label("broadcast", name))
    out = tensor.clone()
    work = dist.broadcast(_wire(out), src=root_rank, async_op=async_op)
    return work, lambda: out


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """A copy of root's tensor on every rank."""
    return _broadcast_launch(tensor, root_rank, name, False)[1]()


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None) -> int:
    return _handles.put(*_broadcast_launch(tensor, root_rank, name, True))


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place broadcast from root."""
    _check_device(tensor, _label("broadcast_", name))
    dist.broadcast(_wire(tensor), src=root_rank)
    return tensor


# ---------------------------------------------------------------------------
# alltoall
def _alltoall_launch(tensor: torch.Tensor, splits: Optional[Sequence[int]],
                     name: Optional[str], async_op: bool):
    label = _label("alltoall", name)
    _check_device(tensor, label)
    n, r = basics.size(), basics.rank()
    if tensor.dim() == 0:
        raise ValueError(f"{label}: needs a tensor of at least one dim")
    if splits is None:
        if tensor.shape[0] % n:
            raise ValueError(f"{label}: dim 0 ({tensor.shape[0]}) must be divisible "
                             f"by size ({n}) when splits=None")
        splits = [tensor.shape[0] // n] * n
    splits = [int(s) for s in splits]
    if len(splits) != n or min(splits) < 0 or sum(splits) != tensor.shape[0]:
        raise ValueError(f"{label}: splits {splits} must be {n} counts that sum "
                         f"to dim 0 ({tensor.shape[0]})")
    recv = [extra[r] for _, extra in _exchange_shapes(label, tensor, splits)]
    buf = _wire(tensor).contiguous()
    out = buf.new_empty(sum(recv), *tensor.shape[1:])
    work = dist.all_to_all_single(out, buf, output_split_sizes=recv,
                                  input_split_sizes=splits, async_op=async_op)

    def finish():
        res = out.view(torch.bool) if tensor.dtype == torch.bool else out
        return res, recv

    return work, finish


def alltoall(tensor: torch.Tensor, splits: Optional[Sequence[int]] = None,
             name: Optional[str] = None) -> Tuple[torch.Tensor, List[int]]:
    """Send ``splits[p]`` rows of dim 0 to rank p (in order), receive the
    peers' rows in rank order; returns ``(output, recv_splits)``. Without
    ``splits`` each peer gets ``shape[0] // size`` rows
    (ref: operations.cc:979-1042)."""
    return _alltoall_launch(tensor, splits, name, False)[1]()


def alltoall_async(tensor: torch.Tensor, splits: Optional[Sequence[int]] = None,
                   name: Optional[str] = None) -> int:
    return _handles.put(*_alltoall_launch(tensor, splits, name, True))


# ---------------------------------------------------------------------------
# reducescatter
def reducescatter(tensor: torch.Tensor, op: Optional[ReduceOp] = None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce across ranks (SUM unless ``op`` says otherwise) and keep this
    rank's ``shape[0] // size`` rows of dim 0; rows past ``size * per`` are
    dropped, as the JAX eager path drops them. NCCL reduce-scatters those
    rows; gloo, which has no reduce-scatter, all-reduces and slices, the
    JAX eager path's own way."""
    rop = _resolve_op(ReduceOp.SUM if op is None else op, None)
    label = _label("reducescatter", name)
    _check_device(tensor, label)
    if tensor.dim() == 0:
        raise ValueError(f"{label}: needs a tensor of at least one dim")
    n, r = basics.size(), basics.rank()
    per = tensor.shape[0] // n
    if dist.get_backend() != "nccl":
        return allreduce(tensor, op=rop)[r * per:(r + 1) * per]
    x = tensor[:n * per].contiguous()
    buf = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = buf.new_empty(per, *x.shape[1:])
    dist.reduce_scatter_tensor(out, buf, op=_DIST_OPS[rop])
    if rop == ReduceOp.AVERAGE:
        out = _scale(out, 1.0 / n)
    return out.to(tensor.dtype)


# ---------------------------------------------------------------------------
# handles and barrier
def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has finished
    (ref: horovod/torch/mpi_ops.py:poll)."""
    return _handles.poll(handle)


def synchronize(handle: int):
    """Wait for the collective behind ``handle`` and return its result
    (ref: horovod/torch/mpi_ops.py:synchronize)."""
    return _handles.synchronize(handle)


def barrier() -> None:
    basics._require_init()
    dist.barrier()
