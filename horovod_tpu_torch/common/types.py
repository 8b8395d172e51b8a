"""Reduction ops, statuses and wire dtypes (counterpart of
``horovod_tpu/common/types.py``; the port's own copy, since it imports
nothing of the JAX package)."""
from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class ReduceOp(enum.IntEnum):
    """Reduction ops exposed to users (ref: horovod/common/basics.py:210-233
    Average/Sum/Adasum; Min/Max/Product as in the JAX package)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Module-level aliases matching horovod's public names.
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


class StatusType(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclass
class Status:
    """Operation status (ref: horovod/common/common.h:126-166)."""

    type: StatusType = StatusType.OK
    reason: str = ""

    def ok(self) -> bool:
        return self.type == StatusType.OK

    @staticmethod
    def OK() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def UnknownError(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def PreconditionError(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def Aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def InvalidArgument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)


class DataType(enum.IntEnum):
    """Wire dtype enum (ref: horovod/common/wire/message.fbs DataType), the
    JAX package's numbering."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10


_TORCH_TO_DTYPE = {
    torch.uint8: DataType.UINT8,
    torch.int8: DataType.INT8,
    torch.int16: DataType.INT16,
    torch.int32: DataType.INT32,
    torch.int64: DataType.INT64,
    torch.float16: DataType.FLOAT16,
    torch.float32: DataType.FLOAT32,
    torch.float64: DataType.FLOAT64,
    torch.bool: DataType.BOOL,
    torch.bfloat16: DataType.BFLOAT16,
}
_DTYPE_TO_TORCH = {v: k for k, v in _TORCH_TO_DTYPE.items()}


def to_wire_dtype(dtype: torch.dtype) -> DataType:
    try:
        return _TORCH_TO_DTYPE[dtype]
    except KeyError:
        raise TypeError(f"dtype {dtype} is not supported") from None


def from_wire_dtype(dt: DataType) -> torch.dtype:
    return _DTYPE_TO_TORCH[DataType(dt)]


def dtype_size(dt: DataType) -> int:
    if dt in (DataType.UINT8, DataType.INT8, DataType.BOOL):
        return 1
    if dt in (DataType.UINT16, DataType.INT16, DataType.FLOAT16, DataType.BFLOAT16):
        return 2
    if dt in (DataType.INT32, DataType.FLOAT32):
        return 4
    return 8
