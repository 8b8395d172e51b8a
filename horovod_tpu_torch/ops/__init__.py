"""Collectives over the process group (counterpart of the
``horovod_tpu/ops/__init__.py`` entry points and ``ops/traced.py:127-355``).

``torch.distributed`` plays the part XLA's psum plays in the JAX package:
NCCL between cards, gloo on the CPU. AVERAGE is SUM followed by a 1/size
postscale; prescale and postscale multiply in the tensor's own dtype (the
factor rounded to it first, as the JAX ``_scale``), and integer tensors
scale through f32 so 1/size does not truncate to zero (ref: ScaleBuffer,
collective_operations.h:89-125). An f32 SUM or AVERAGE all-reduce takes
the stateless wire cast that ``HOROVOD_WIRE_COMPRESSION`` selects
(``ops/wire.py``), per tensor, or on the packed buffer of a grouped call,
where the JAX traced all-reduce takes it. PRODUCT multiplies the ranks'
tensors (``dist.ReduceOp.PRODUCT``, which NCCL and gloo both take; the JAX
traced op gathers and multiplies), between the same prescale and
postscale. ADASUM combines the ranks' tensors by ``ops/adasum.py``.

The entry points take the JAX package's keywords: ``op=`` or the legacy
``average=`` (both at once raise ``ValueError``), ``name=``, which names
the collective in errors (``torch.distributed`` negotiates nothing by
name, so it keys no cache here), and ``axis_name=``: one mesh axis or a
tuple of them (``parallel/mesh.py``), the collective then runs over this
rank's line along them, as the JAX traced collectives run over the named
axes (``resolve_axis``, ``horovod_tpu/ops/__init__.py:92-140``). None is
the axis a ``wrap_step`` body binds, else the world. Ranks, sizes and
``root_rank`` are then indices along the line; AVERAGE divides by the
line's size. A line of one rank runs no collective.

The world's collectives go through the eager engine (``engine/``), as the
JAX package's concrete inputs in process mode do
(``horovod_tpu/ops/__init__.py:4-24``): ``allreduce``,
``grouped_allreduce``, ``allgather``, ``broadcast``, ``broadcast_``,
``alltoall``, their ``*_async`` forms, ``barrier`` and ``join``, whenever
no ``axis_name`` is given and no ``wrap_step`` body binds one. The
engine's background thread negotiates each tensor by its name
(``<op>.<name>``, or ``noname.<n>`` counted over every unnamed call) with
the coordinator, so ranks may submit in different orders; it fuses,
caches steady-state negotiations, warns about stalls and writes the
``HOROVOD_TIMELINE``. A disagreement (collective, dtype, shape, op,
scale factors, root) comes back as the coordinator's ERROR on every rank:
``HorovodInternalError`` naming the tensor and both values; no rank hangs.
The object collectives and ``broadcast_parameters`` ride these.

Calls on a mesh line (``axis_name=``, or inside ``wrap_step``) launch
their collective directly, as the JAX traced collectives lower to XLA's,
after a small header exchange (two int64 all-gathers: the collective,
dtype, reduce op, pre/postscale factors, root, number of dims, then the
dims and counts) that every rank checks, naming the op and both values
on a disagreement. ``reducescatter`` and the port's hot internal callers
(the BatchNorm statistics, the loss average, the optimizer's buckets,
ZeRO's reduce-scatter) launch directly too, without the header; the
optimizer checks its gradient signature once instead.

Shapes may differ between ranks where Horovod allows it: the first dim of
``allgather`` (pad to the largest, gather, slice in rank order) and the
splits of ``alltoall``. bool tensors travel as their uint8 view.

The asynchronous forms (``*_async``, ``poll``, ``synchronize``) return a
handle: through the engine, its handle; on a mesh line, the data
collective launched with ``async_op=True`` and finished (scale, slice,
cast back) in ``synchronize``, after a synchronous header exchange.
"""
from __future__ import annotations

import contextlib
import struct
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common import basics
from ..common.async_handles import HandleTable
from ..common.exceptions import HorovodInternalError, comm_failures_raise_internal
from ..common.types import ReduceOp
from ..parallel import mesh as _mesh
from ..parallel.mesh import Comm, resolve_comm, world_comm
from . import wire

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}
# Codes for the dtypes and collectives in the header exchange.
_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
           torch.bool]
_KINDS = ["allreduce", "grouped_allreduce", "broadcast", "allgather", "alltoall",
          "DistributedOptimizer", "DistributedGradientTape", "distributed_value_and_grad"]

_handles = HandleTable()


def _resolve_op(op: Optional[ReduceOp], average: Optional[bool],
                adasum: bool = True) -> ReduceOp:
    """(ref: horovod/torch/mpi_ops.py:83-110, the JAX ``_resolve_op``)"""
    if isinstance(average, ReduceOp):
        raise TypeError(f"average={average!r}: pass a reduce op as op=")
    if op is not None and average is not None:
        raise ValueError("specify either op= or the legacy average=, not both")
    if op is None:
        op = ReduceOp.AVERAGE if (average is None or average) else ReduceOp.SUM
    if op not in _DIST_OPS and not (adasum and op == ReduceOp.ADASUM):
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


def _engine(axis_name):
    """The engine when the call is over the world (no ``axis_name``, no
    ``wrap_step`` axis bound), else None: the call runs on its line."""
    if axis_name is not None or _mesh._default_axis.get() is not None:
        return None
    return basics.engine()


class _EngineWork:
    """An engine handle as the handle table's work: done when the engine
    says so; ``wait`` keeps the result."""

    def __init__(self, eng, handle: int):
        self.eng, self.handle, self.result = eng, handle, None

    def is_completed(self) -> bool:
        return self.eng.poll(self.handle)

    def wait(self) -> None:
        self.result = self.eng.synchronize(self.handle)


def _put_engine(eng, handle: int, finish=None) -> int:
    work = _EngineWork(eng, handle)
    return _handles.put(work, lambda: work.result if finish is None
                        else finish(work.result))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor as it travels: bool as its uint8 view."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _label(op: str, name: Optional[str]) -> str:
    return op if name is None else f"{op} {name!r}"


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while the profiler records
    (``profile_step`` reads ``hvd.flatten`` and ``hvd.unflatten``), else
    nothing: about a microsecond a call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# The header exchange: what every rank must agree on before a collective.
def _bits(f: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(f)))[0]


def _unbits(i: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(i)))[0]


_FIELDS = [  # (name, how a value reads in the error)
    ("collective", lambda v: _KINDS[v]),
    ("dtype", lambda v: str(_DTYPES[v])),
    ("reduce op", lambda v: ReduceOp(v).name if v >= 0 else "none"),
    ("prescale factor", _unbits),
    ("postscale factor", _unbits),
    ("root rank", str),
    ("number of dims", str),
    ("number of counts", str),
]


def _gather_rows(row: List[int], comm: Comm) -> List[List[int]]:
    """Every member's ``row`` (equal lengths), through the rank's device."""
    t = torch.tensor(row, dtype=torch.int64, device=basics.device())
    parts = [torch.empty_like(t) for _ in range(comm.size)]
    dist.all_gather(parts, t, group=comm.group)
    return torch.stack(parts).tolist()


def _exchange_header(label: str, kind: str, dtype: torch.dtype,
                     shape: Sequence[int], op: Optional[ReduceOp] = None,
                     prescale: float = 1.0, postscale: float = 1.0,
                     root: int = -1, extra: Sequence[int] = (),
                     comm: Optional[Comm] = None
                     ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Every rank's ``(shape, extra)``, after checking that the collective,
    dtype, op, scale factors, root and the lengths of shape and extra
    agree; a disagreement raises ``HorovodInternalError`` naming the op and
    both values. Comparing shapes and extras is the caller's (what may
    differ depends on the collective). Runs over ``comm`` (the world by
    default); ranks in errors are indices along it."""
    comm = comm or world_comm()
    if dtype not in _DTYPES:
        raise TypeError(f"{label}: dtype {dtype} is not supported")
    shape, extra = tuple(int(d) for d in shape), tuple(int(e) for e in extra)
    if comm.size == 1:
        return [(shape, extra)]
    head = [_KINDS.index(kind), _DTYPES.index(dtype), -1 if op is None else int(op),
            _bits(prescale), _bits(postscale), root, len(shape), len(extra)]
    heads = _gather_rows(head, comm)
    for r, row in enumerate(heads):
        for i, (field, show) in enumerate(_FIELDS):
            if row[i] != heads[0][i]:
                raise HorovodInternalError(
                    f"{label}: {field} mismatch, rank 0 has {show(heads[0][i])}, "
                    f"rank {r} has {show(row[i])}")
    if not shape and not extra:
        return [((), ())] * comm.size
    return [(tuple(row[:len(shape)]), tuple(row[len(shape):]))
            for row in _gather_rows([*shape, *extra], comm)]


def _check_same_shape(label: str, shapes) -> None:
    for r, (shape, _) in enumerate(shapes):
        if shape != shapes[0][0]:
            raise HorovodInternalError(
                f"{label}: shape mismatch, rank 0 has shape {shapes[0][0]}, "
                f"rank {r} has shape {shape}")


def _check_trailing_dims(label: str, shapes) -> None:
    for r, (shape, _) in enumerate(shapes):
        if shape[1:] != shapes[0][0][1:]:
            raise HorovodInternalError(
                f"{label}: trailing dims differ, rank 0 has shape {shapes[0][0]}, "
                f"rank {r} has shape {shape}")


# ---------------------------------------------------------------------------
# allreduce
def _reduce_launch(x: torch.Tensor, op: ReduceOp, postscale_factor: float,
                   out_dtype: torch.dtype, async_op: bool, comm: Optional[Comm] = None):
    """Launch the all-reduce of ``x`` over ``comm`` (the world by default),
    already prescaled and the caller's to give away (it may be reduced in
    place); returns ``(work, finish)``. SUM and AVERAGE of f32 take the
    wire cast ``wire.py`` selects."""
    comm = comm or world_comm()
    if wire.int8_enabled(x, op):
        work, raw = wire.int8_allreduce_launch(x, async_op, comm)
    else:
        dt = wire.wire_dtype(x, op)
        # bool reduces as uint8 (SUM and MAX are a logical or, MIN an and).
        buf = x.to(dt) if dt is not None else (
            x.to(torch.uint8) if x.dtype == torch.bool else x)
        work = None if comm.trivial else dist.all_reduce(
            buf, op=_DIST_OPS[op], group=comm.group, async_op=async_op)
        raw = (lambda: buf.to(x.dtype)) if dt is not None else (lambda: buf)

    def finish():
        out = raw()
        if op == ReduceOp.AVERAGE:
            out = _scale(out, 1.0 / comm.size)
        return _scale(out, postscale_factor).to(out_dtype)

    return work, finish


def _allreduce_launch(tensor: torch.Tensor, op: ReduceOp, prescale_factor: float,
                      postscale_factor: float, async_op: bool, owned: bool = False,
                      comm: Optional[Comm] = None, sizes: Optional[List[int]] = None):
    """The all-reduce without the header; ``owned`` says ``tensor`` may be
    overwritten. Adasum runs its rounds at once (no ``async`` form), over
    each range of ``sizes`` apart where given."""
    x = _scale(tensor, prescale_factor)
    if op == ReduceOp.ADASUM:
        from .adasum import adasum_allreduce

        out = _scale(adasum_allreduce(x, comm, sizes), postscale_factor)
        return None, lambda: out
    if x is tensor and not owned:
        x = x.clone()
    return _reduce_launch(x, op, postscale_factor, tensor.dtype, async_op, comm)


def _allreduce(tensor: torch.Tensor, op: ReduceOp, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0, comm: Optional[Comm] = None) -> torch.Tensor:
    """All-reduce without the header exchange, for the port's own hot
    callers, whose ranks agree by construction."""
    return _allreduce_launch(tensor, op, prescale_factor, postscale_factor, False,
                             comm=comm)[1]()


def _check_allreduce(label: str, tensor: torch.Tensor, op: ReduceOp,
                     prescale_factor: float, postscale_factor: float, comm: Comm) -> None:
    _check_device(tensor, label)
    _check_same_shape(label, _exchange_header(
        label, "allreduce", tensor.dtype, tensor.shape, op, prescale_factor,
        postscale_factor, comm=comm))


@comm_failures_raise_internal
def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[ReduceOp] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0, axis_name=None) -> torch.Tensor:
    """All-reduce across ranks; returns a new tensor, the input is kept."""
    rop = _resolve_op(op, average)
    eng = _engine(axis_name)
    if eng is not None:
        _check_device(tensor, _label("allreduce", name))
        return eng.synchronize(eng.enqueue_allreduce(
            tensor.detach(), name=name, op=rop, prescale=prescale_factor,
            postscale=postscale_factor))
    comm = resolve_comm(axis_name)
    _check_allreduce(_label("allreduce", name), tensor, rop, prescale_factor,
                     postscale_factor, comm)
    return _allreduce(tensor, rop, prescale_factor, postscale_factor, comm)


@comm_failures_raise_internal
def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op: Optional[ReduceOp] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, axis_name=None) -> int:
    """(ref: horovod/torch/mpi_ops.py:117-161)"""
    rop = _resolve_op(op, average)
    eng = _engine(axis_name)
    if eng is not None:
        _check_device(tensor, _label("allreduce_async", name))
        return _put_engine(eng, eng.enqueue_allreduce(
            tensor.detach(), name=name, op=rop, prescale=prescale_factor,
            postscale=postscale_factor))
    comm = resolve_comm(axis_name)
    _check_allreduce(_label("allreduce_async", name), tensor, rop, prescale_factor,
                     postscale_factor, comm)
    return _handles.put(*_allreduce_launch(tensor, rop, prescale_factor,
                                           postscale_factor, True, comm=comm))


def _grouped_allreduce(tensors: Sequence[torch.Tensor], op: ReduceOp,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       comm: Optional[Comm] = None,
                       per_tensor: bool = False) -> List[torch.Tensor]:
    """The grouped all-reduce without the header. ``per_tensor``: Adasum
    combines each tensor's range of the buffer on its own (the other ops
    are elementwise, so it changes nothing for them)."""
    widest = tensors[0].dtype
    for t in tensors[1:]:
        widest = torch.promote_types(widest, t.dtype)
    with span("hvd.flatten"):
        flat = torch.cat([t.reshape(-1).to(widest) for t in tensors])
    sizes = [t.numel() for t in tensors] if per_tensor else None
    red = _allreduce_launch(flat, op, prescale_factor, postscale_factor, False,
                            owned=True, comm=comm, sizes=sizes)[1]()
    out, off = [], 0
    with span("hvd.unflatten"):
        for t in tensors:
            n = t.numel()
            out.append(red[off:off + n].view(t.shape).to(t.dtype))
            off += n
    return out


@comm_failures_raise_internal
def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: Optional[bool] = None, name: Optional[str] = None,
                      op: Optional[ReduceOp] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0, axis_name=None) -> List[torch.Tensor]:
    """All-reduce of a list. Over the world, each tensor goes to the engine
    as ``<name or "grouped">.<i>``, all added in one cycle, so the
    coordinator fuses them (the JAX process mode's grouped all-reduce,
    each tensor in its own dtype). On a mesh line: flatten into one buffer
    of the widest dtype, one collective, split back (ref: the fusion
    buffer, controller.cc:686-809; ``ops/traced.py`` grouped_allreduce).
    The ranks must agree on the number of tensors and each one's size."""
    rop = _resolve_op(op, average)
    if not tensors:
        return []
    label = _label("grouped_allreduce", name)
    eng = _engine(axis_name)
    if eng is not None:
        for t in tensors:
            _check_device(t, label)
        base = name or "grouped"
        handles = eng.enqueue_allreduces(
            [t.detach() for t in tensors], [f"{base}.{i}" for i in range(len(tensors))],
            op=rop, prescale=prescale_factor, postscale=postscale_factor)
        # Every member is waited for before an error is raised, so that none
        # is still pending under its name when the caller calls again.
        out, error = [], None
        for h in handles:
            try:
                out.append(eng.synchronize(h))
            except HorovodInternalError as e:
                error = error or e
        if error is not None:
            raise error
        return out
    comm = resolve_comm(axis_name)
    for t in tensors:
        _check_device(t, label)
    widest = tensors[0].dtype
    for t in tensors[1:]:
        widest = torch.promote_types(widest, t.dtype)
    sizes = [t.numel() for t in tensors]
    heads = _exchange_header(label, "grouped_allreduce", widest, (sum(sizes),), rop,
                             prescale_factor, postscale_factor, extra=sizes, comm=comm)
    for r, (_, counts) in enumerate(heads):
        if counts != heads[0][1]:
            raise HorovodInternalError(
                f"{label}: tensor sizes mismatch, rank 0 has {list(heads[0][1])}, "
                f"rank {r} has {list(counts)}")
    return _grouped_allreduce(tensors, rop, prescale_factor, postscale_factor, comm)


# ---------------------------------------------------------------------------
# allgather
def _allgather_launch(tensor: torch.Tensor, name: Optional[str], async_op: bool,
                      axis_name=None):
    label = _label("allgather", name)
    _check_device(tensor, label)
    comm = resolve_comm(axis_name)
    x = tensor.reshape(1) if tensor.dim() == 0 else tensor
    shapes = _exchange_header(label, "allgather", x.dtype, x.shape, comm=comm)
    _check_trailing_dims(label, shapes)
    rows = [shape[0] for shape, _ in shapes]
    longest = max(rows)
    buf = _wire(x).contiguous()
    if x.shape[0] < longest:
        buf = torch.cat([buf, buf.new_zeros(longest - x.shape[0], *x.shape[1:])])
    if comm.trivial:
        parts, work = [buf], None
    else:
        parts = [torch.empty_like(buf) for _ in rows]
        work = dist.all_gather(parts, buf, group=comm.group, async_op=async_op)

    def finish():
        out = torch.cat([p[:r] for p, r in zip(parts, rows)])
        return out.view(torch.bool) if tensor.dtype == torch.bool else out

    return work, finish


def _enqueue_allgather(eng, tensor: torch.Tensor, name: Optional[str]) -> int:
    _check_device(tensor, _label("allgather", name))
    x = tensor.detach()
    return eng.enqueue_allgather(x.reshape(1) if x.dim() == 0 else x, name=name)


@comm_failures_raise_internal
def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              axis_name=None) -> torch.Tensor:
    """Concatenate the ranks' tensors along dim 0, in rank order; the first
    dims may differ, a 0-d tensor counts as shape (1,)
    (ref: collective_operations.h:148-185)."""
    eng = _engine(axis_name)
    if eng is not None:
        return eng.synchronize(_enqueue_allgather(eng, tensor, name))
    return _allgather_launch(tensor, name, False, axis_name)[1]()


@comm_failures_raise_internal
def allgather_async(tensor: torch.Tensor, name: Optional[str] = None,
                    axis_name=None) -> int:
    eng = _engine(axis_name)
    if eng is not None:
        return _put_engine(eng, _enqueue_allgather(eng, tensor, name))
    return _handles.put(*_allgather_launch(tensor, name, True, axis_name))


# ---------------------------------------------------------------------------
# broadcast
def _check_broadcast(label: str, tensor: torch.Tensor, root_rank: int,
                     comm: Comm) -> int:
    """The root's global rank, after the header check."""
    _check_device(tensor, label)
    if not 0 <= root_rank < comm.size:
        raise ValueError(f"{label}: root_rank {root_rank} outside a line of {comm.size}")
    _check_same_shape(label, _exchange_header(label, "broadcast", tensor.dtype,
                                              tensor.shape, root=root_rank, comm=comm))
    return comm.ranks[root_rank]


def _broadcast_launch(tensor: torch.Tensor, root_rank: int, name: Optional[str],
                      async_op: bool, axis_name=None):
    comm = resolve_comm(axis_name)
    src = _check_broadcast(_label("broadcast", name), tensor, root_rank, comm)
    out = tensor.clone()
    work = None if comm.trivial else dist.broadcast(
        _wire(out), src=src, group=comm.group, async_op=async_op)
    return work, lambda: out


def _enqueue_broadcast(eng, tensor: torch.Tensor, root_rank: int,
                       name: Optional[str], label: str) -> int:
    _check_device(tensor, label)
    if not 0 <= root_rank < basics.size():
        raise ValueError(f"{label}: root_rank {root_rank} outside a world of "
                         f"{basics.size()}")
    return eng.enqueue_broadcast(tensor.detach(), root_rank, name=name)


@comm_failures_raise_internal
def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None, axis_name=None) -> torch.Tensor:
    """A copy of root's tensor on every rank (``root_rank`` an index along
    ``axis_name``'s line)."""
    eng = _engine(axis_name)
    if eng is not None:
        return eng.synchronize(_enqueue_broadcast(eng, tensor, root_rank, name,
                                                  _label("broadcast", name)))
    return _broadcast_launch(tensor, root_rank, name, False, axis_name)[1]()


@comm_failures_raise_internal
def broadcast_async(tensor: torch.Tensor, root_rank: int = 0,
                    name: Optional[str] = None, axis_name=None) -> int:
    eng = _engine(axis_name)
    if eng is not None:
        return _put_engine(eng, _enqueue_broadcast(eng, tensor, root_rank, name,
                                                   _label("broadcast_async", name)))
    return _handles.put(*_broadcast_launch(tensor, root_rank, name, True, axis_name))


@comm_failures_raise_internal
def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               name: Optional[str] = None, axis_name=None) -> torch.Tensor:
    """In-place broadcast from root."""
    eng = _engine(axis_name)
    if eng is not None:
        out = eng.synchronize(_enqueue_broadcast(eng, tensor, root_rank, name,
                                                 _label("broadcast_", name)))
        with torch.no_grad():
            tensor.copy_(out)
        return tensor
    comm = resolve_comm(axis_name)
    src = _check_broadcast(_label("broadcast_", name), tensor, root_rank, comm)
    if not comm.trivial:
        dist.broadcast(_wire(tensor), src=src, group=comm.group)
    return tensor


# ---------------------------------------------------------------------------
# alltoall
def _alltoall_launch(tensor: torch.Tensor, splits: Optional[Sequence[int]],
                     name: Optional[str], async_op: bool, axis_name=None):
    label = _label("alltoall", name)
    _check_device(tensor, label)
    eng = _engine(axis_name)
    comm = world_comm() if eng is not None else resolve_comm(axis_name)
    n, r = comm.size, comm.rank
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
    if eng is not None:
        work = _EngineWork(eng, eng.enqueue_alltoall(tensor.detach(), splits, name=name))
        return work, lambda: work.result
    shapes = _exchange_header(label, "alltoall", tensor.dtype, tensor.shape,
                              extra=splits, comm=comm)
    _check_trailing_dims(label, shapes)
    recv = [extra[r] for _, extra in shapes]
    buf = _wire(tensor).contiguous()
    if comm.trivial:
        out, work = buf.clone(), None
    else:
        out = buf.new_empty(sum(recv), *tensor.shape[1:])
        work = dist.all_to_all_single(out, buf, output_split_sizes=recv,
                                      input_split_sizes=splits, group=comm.group,
                                      async_op=async_op)

    def finish():
        res = out.view(torch.bool) if tensor.dtype == torch.bool else out
        return res, recv

    return work, finish


@comm_failures_raise_internal
def alltoall(tensor: torch.Tensor, splits: Optional[Sequence[int]] = None,
             name: Optional[str] = None, axis_name=None) -> Tuple[torch.Tensor, List[int]]:
    """Send ``splits[p]`` rows of dim 0 to rank p (in order), receive the
    peers' rows in rank order; returns ``(output, recv_splits)``. Without
    ``splits`` each peer gets ``shape[0] // size`` rows
    (ref: operations.cc:979-1042)."""
    work, finish = _alltoall_launch(tensor, splits, name, False, axis_name)
    if work is not None:
        work.wait()
    return finish()


@comm_failures_raise_internal
def alltoall_async(tensor: torch.Tensor, splits: Optional[Sequence[int]] = None,
                   name: Optional[str] = None, axis_name=None) -> int:
    return _handles.put(*_alltoall_launch(tensor, splits, name, True, axis_name))


# ---------------------------------------------------------------------------
# reducescatter
def _reducescatter(tensor: torch.Tensor, op: ReduceOp,
                   comm: Optional[Comm] = None) -> torch.Tensor:
    """This rank's ``shape[0] // size`` rows of the reduction, in the
    tensor's own dtype (no wire cast, as the JAX traced reducescatter)."""
    comm = comm or world_comm()
    n, r = comm.size, comm.rank
    per = tensor.shape[0] // n
    x = tensor[:n * per].contiguous()
    buf = x.to(torch.uint8) if x.dtype == torch.bool else x
    if comm.trivial:
        out = buf.clone()
    elif dist.get_backend() == "nccl":
        out = buf.new_empty(per, *x.shape[1:])
        dist.reduce_scatter_tensor(out, buf, op=_DIST_OPS[op], group=comm.group)
    else:
        buf = buf.clone()   # x may be a view of the caller's tensor
        dist.all_reduce(buf, op=_DIST_OPS[op], group=comm.group)
        out = buf[r * per:(r + 1) * per]
    if op == ReduceOp.AVERAGE:
        out = _scale(out, 1.0 / n)
    return out.to(tensor.dtype)


@comm_failures_raise_internal
def reducescatter(tensor: torch.Tensor, op: Optional[ReduceOp] = None,
                  name: Optional[str] = None, axis_name=None) -> torch.Tensor:
    """Reduce across ranks (SUM unless ``op`` says otherwise) and keep this
    rank's ``shape[0] // size`` rows of dim 0; rows past ``size * per`` are
    dropped, as the JAX eager path drops them. NCCL reduce-scatters those
    rows; gloo, which has no reduce-scatter, all-reduces and slices, the
    JAX eager path's own way. PRODUCT is refused, as the JAX traced
    reducescatter refuses every op but SUM and AVERAGE."""
    rop = _resolve_op(ReduceOp.SUM if op is None else op, None, adasum=False)
    if rop == ReduceOp.PRODUCT:
        raise ValueError("reducescatter takes SUM, AVERAGE, MIN or MAX, not PRODUCT")
    label = _label("reducescatter", name)
    _check_device(tensor, label)
    if tensor.dim() == 0:
        raise ValueError(f"{label}: needs a tensor of at least one dim")
    return _reducescatter(tensor, rop, resolve_comm(axis_name))


# ---------------------------------------------------------------------------
# handles and barrier
@comm_failures_raise_internal
def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has finished
    (ref: horovod/torch/mpi_ops.py:poll)."""
    return _handles.poll(handle)


@comm_failures_raise_internal
def synchronize(handle: int):
    """Wait for the collective behind ``handle`` and return its result
    (ref: horovod/torch/mpi_ops.py:synchronize)."""
    return _handles.synchronize(handle)


def barrier() -> None:
    """Every rank reaches this point before any leaves it: a fence through
    the engine, after everything each rank enqueued before it."""
    eng = basics.engine()
    eng.synchronize(eng.enqueue_barrier())


def join() -> int:
    """Signal that this rank has run out of data: it takes part in the
    other ranks' all-reduces with zeros until every rank has joined
    (ref: operations.cc:1044-1068, controller.cc:220-308). Returns the
    last rank to join. AVERAGE still divides by the world's size."""
    eng = basics.engine()
    return int(eng.synchronize(eng.enqueue_join()))
