"""The environment knobs of the scaled data-parallel path (counterpart of
``horovod_tpu/utils/env.py:458, 493-495, 697-735``; the port's own copy).

Each function reads the environment when it is called, so a knob set
between two calls takes effect on the second, as the JAX package's eager
knobs do. A value that does not parse falls back to the default: a typo
must never change what the wire carries or how the optimizer state is
laid out.
"""
from __future__ import annotations

import os

FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
ZERO_SHARDING = "HOROVOD_ZERO_SHARDING"
WIRE_COMPRESSION = "HOROVOD_WIRE_COMPRESSION"
WIRE_COMPRESSION_MIN_BYTES = "HOROVOD_WIRE_COMPRESSION_MIN_BYTES"
WIRE_COMPRESSION_INT8 = "HOROVOD_WIRE_COMPRESSION_INT8"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024  # ref: operations.cc:432
DEFAULT_WIRE_COMPRESSION_MIN_BYTES = 65536


def _int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val in (None, ""):
        return default
    try:
        return int(val)
    except ValueError:
        return default


def fusion_threshold_bytes() -> int:
    """Bytes of gradients one bucket of the overlapped all-reduce holds
    (ref: operations.cc:432-440); floor 0, one gradient a bucket."""
    return max(_int(FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES), 0)


def zero_sharding_default() -> int:
    """HOROVOD_ZERO_SHARDING as 0, 1 or 2; anything else is 0."""
    val = _int(ZERO_SHARDING, 0)
    return val if val in (1, 2) else 0


def wire_compression_mode() -> str:
    """HOROVOD_WIRE_COMPRESSION as none, bf16, fp16 or auto (bf16);
    anything else is none."""
    val = os.environ.get(WIRE_COMPRESSION, "none").lower()
    return val if val in ("none", "bf16", "fp16", "auto") else "none"


def wire_compression_min_bytes() -> int:
    """The smallest payload a wire cast engages on; floor 0."""
    return max(_int(WIRE_COMPRESSION_MIN_BYTES, DEFAULT_WIRE_COMPRESSION_MIN_BYTES), 0)


def wire_compression_int8() -> bool:
    """The int8-with-scale lane, opt-in."""
    val = os.environ.get(WIRE_COMPRESSION_INT8)
    if val in (None, ""):
        return False
    return val.lower() not in ("0", "false", "no", "off")
