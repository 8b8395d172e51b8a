"""Reduction ops (counterpart of ``horovod_tpu/common/types.py``; the
port's own copy, since it imports nothing of the JAX package)."""
from __future__ import annotations

import enum


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
