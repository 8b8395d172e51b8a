"""The environment knobs of the scaled data-parallel path and of the eager
engine (counterpart of ``horovod_tpu/utils/env.py:29-35, 196-217, 458-506,
665-735``; the port's own copy, with the JAX package's defaults).

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

CYCLE_TIME = "HOROVOD_CYCLE_TIME"
CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
NUM_CHANNELS = "HOROVOD_NUM_CHANNELS"
CHANNEL_POLICY = "HOROVOD_CHANNEL_POLICY"
LATENCY_CHANNEL_BYTES = "HOROVOD_LATENCY_CHANNEL_BYTES"
MAX_INFLIGHT = "HOROVOD_MAX_INFLIGHT_RESPONSES"
CYCLE_EVENT = "HOROVOD_CYCLE_EVENT_DRIVEN"
STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
STALL_CHECK_TIME = "HOROVOD_STALL_CHECK_TIME_SECONDS"
STALL_SHUTDOWN_TIME = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
TIMELINE = "HOROVOD_TIMELINE"
TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024  # ref: operations.cc:432
DEFAULT_WIRE_COMPRESSION_MIN_BYTES = 65536
DEFAULT_CYCLE_TIME_MS = 5.0          # ref: operations.cc:442
DEFAULT_CACHE_CAPACITY = 1024        # ref: global_state.h:88
DEFAULT_NUM_CHANNELS = 2
MAX_CHANNELS = 16
DEFAULT_LATENCY_CHANNEL_BYTES = 65536
DEFAULT_STALL_WARNING_SECONDS = 60.0  # ref: stall_inspector.h

# Knobs of modules the port has not taken yet: set, they raise instead of
# being ignored (name -> (ROADMAP item, what it would have turned on)).
UNPORTED = {
    "HOROVOD_AUTOTUNE": ("A6", "the autotuner (engine/parameter_manager.py)"),
    "HOROVOD_HIERARCHICAL_ALLREDUCE": ("A6", "the hierarchical allreduce"),
    "HOROVOD_HIERARCHICAL_ALLGATHER": ("A6", "the hierarchical allgather"),
    "HOROVOD_METRICS_PORT": ("A8", "the metrics HTTP exporter"),
    "HOROVOD_METRICS_FILE": ("A8", "the metrics file exporter"),
    "HOROVOD_TRACE_FILE": ("A8", "the tracing plane's merged trace"),
    "HOROVOD_TRACE_DIR": ("A8", "the tracing plane's flight recorder"),
}


def _int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val in (None, ""):
        return default
    try:
        return int(val)
    except ValueError:
        return default


def _float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val in (None, ""):
        return default
    try:
        return float(val)
    except ValueError:
        return default


def _bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val in (None, ""):
        return default
    return val.lower() not in ("0", "false", "no", "off")


def check_unported_knobs() -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for each knob
    of a module the port has not taken that is set (to anything but off)."""
    for name, (item, what) in UNPORTED.items():
        if _bool(name, False):
            raise NotImplementedError(
                f"{name} is set, but {what} is not ported yet (ROADMAP {item}); "
                f"unset it to run")


def cycle_time_ms() -> float:
    """The background loop's longest coalescing wait (ref: operations.cc:442)."""
    return _float(CYCLE_TIME, DEFAULT_CYCLE_TIME_MS)


def cache_capacity() -> int:
    return _int(CACHE_CAPACITY, DEFAULT_CACHE_CAPACITY)


def cache_enabled() -> bool:
    """HOROVOD_CACHE_CAPACITY=0 disables the response cache
    (ref: operations.cc:455-462)."""
    return cache_capacity() != 0


def num_channels() -> int:
    """Executor channels, clamped to [1, MAX_CHANNELS]. Read once, when the
    engine starts: each channel holds a process group, made collectively."""
    return max(1, min(_int(NUM_CHANNELS, DEFAULT_NUM_CHANNELS), MAX_CHANNELS))


def max_inflight_responses() -> int:
    """Dispatched-but-unfinished response bound (backpressure window);
    defaults to 2 per channel; at least 1."""
    return max(_int(MAX_INFLIGHT, 2 * num_channels()), 1)


def channel_policy() -> str:
    """"size" (default: the highest channel is a latency lane for responses
    of at most HOROVOD_LATENCY_CHANNEL_BYTES) or "rr" (round-robin)."""
    val = os.environ.get(CHANNEL_POLICY, "size").lower()
    return val if val in ("size", "rr") else "size"


def latency_channel_bytes() -> int:
    return _int(LATENCY_CHANNEL_BYTES, DEFAULT_LATENCY_CHANNEL_BYTES)


def cycle_event_driven() -> bool:
    """1 (default): an enqueue wakes the background loop at once, so the
    cycle time is a longest coalescing delay; 0: a fixed sleep a cycle."""
    return _bool(CYCLE_EVENT, True)


def stall_check_disabled() -> bool:
    return _bool(STALL_CHECK_DISABLE, False)


def stall_check_seconds() -> float:
    return _float(STALL_CHECK_TIME, DEFAULT_STALL_WARNING_SECONDS)


def stall_shutdown_seconds() -> float:
    return _float(STALL_SHUTDOWN_TIME, 0.0)


def timeline_file() -> str:
    return os.environ.get(TIMELINE, "")


def timeline_mark_cycles() -> bool:
    return _bool(TIMELINE_MARK_CYCLES, False)


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
