"""The environment knobs of the scaled data-parallel path, of the eager
engine, of the launcher and elastic plane, and of the durability and
drain planes, and of the metrics plane (counterpart of
``horovod_tpu/utils/env.py:29-62, 136-186, 196-217, 288-306, 435-451,
458-506, 576-660, 665-735, 776-795, 969-981``; the port's own copy, with
the JAX package's defaults).

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

# Rank topology and rendezvous, set by the launcher (ref: gloo_run.py:65-198).
RANK = "HOROVOD_RANK"
SIZE = "HOROVOD_SIZE"
LOCAL_RANK = "HOROVOD_LOCAL_RANK"
LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
CROSS_RANK = "HOROVOD_CROSS_RANK"
CROSS_SIZE = "HOROVOD_CROSS_SIZE"
RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOSTNAME = "HOROVOD_HOSTNAME"
SECRET_KEY = "HOROVOD_SECRET_KEY"
ELASTIC = "HOROVOD_ELASTIC"
# The port's own: the launcher hosts a torch TCPStore beside the rendezvous
# server (at the rendezvous address, this port); ``init()`` forms its
# process groups on it under the prefix HOROVOD_MESH_SCOPE, which the
# elastic driver bumps every topology epoch.
STORE_PORT = "HOROVOD_STORE_PORT"
MESH_SCOPE = "HOROVOD_MESH_SCOPE"
# The local slot a worker was spawned into; its card, across resets.
SPAWN_LOCAL_RANK = "HOROVOD_SPAWN_LOCAL_RANK"
REPLAY_WINDOW = "HOROVOD_REPLAY_WINDOW"
CONNECT_ATTEMPTS = "HOROVOD_CONNECT_ATTEMPTS"
CONNECT_BACKOFF = "HOROVOD_CONNECT_BACKOFF_SECONDS"
CONNECT_BACKOFF_CAP = "HOROVOD_CONNECT_BACKOFF_CAP_SECONDS"
ELASTIC_READY_TIMEOUT = "HOROVOD_ELASTIC_READY_TIMEOUT"
ELASTIC_RESET_TIMEOUT = "HOROVOD_ELASTIC_RESET_TIMEOUT"
ELASTIC_DISCOVERY_INTERVAL = "HOROVOD_ELASTIC_DISCOVERY_INTERVAL"
ELASTIC_EPOCH_POLL = "HOROVOD_ELASTIC_EPOCH_POLL"
BLACKLIST_COOLDOWN = "HOROVOD_BLACKLIST_COOLDOWN_SECONDS"
LOG_LEVEL = "HOROVOD_LOG_LEVEL"

# The durability plane (``common/checkpoint.py``): a shared directory
# (unset: off), a checkpoint every N commits (0: none), the complete
# checkpoints kept, the coordinator's bound on collecting the ranks' acks,
# and whether shards and manifests are fsynced.
CHECKPOINT_DIR = "HOROVOD_CHECKPOINT_DIR"
CHECKPOINT_INTERVAL = "HOROVOD_CHECKPOINT_INTERVAL_STEPS"
CHECKPOINT_KEEP = "HOROVOD_CHECKPOINT_KEEP"
CHECKPOINT_COMMIT_TIMEOUT = "HOROVOD_CHECKPOINT_COMMIT_TIMEOUT_SECONDS"
CHECKPOINT_FSYNC = "HOROVOD_CHECKPOINT_FSYNC"
# The drain plane (``common/drain.py``): the window between a preemption
# notice and the forced exit, and the signal that is the notice (a name,
# with or without SIG, or a number).
DRAIN_GRACE_SECONDS = "HOROVOD_DRAIN_GRACE_SECONDS"
PREEMPT_SIGNAL = "HOROVOD_PREEMPT_SIGNAL"

# The metrics plane (``common/telemetry.py``, ``common/metrics_export.py``):
# rank 0's HTTP endpoint (unset or empty: off; 0: an ephemeral port) and
# its bind address (loopback unless set: the endpoint is unauthenticated),
# the periodic JSON dump (``{rank}`` in the path: every rank writes its
# own) and its interval, and how often each rank piggybacks its scalar
# snapshot on the control plane for rank 0's fleet view (0: never).
METRICS_PORT = "HOROVOD_METRICS_PORT"
METRICS_ADDR = "HOROVOD_METRICS_ADDR"
METRICS_FILE = "HOROVOD_METRICS_FILE"
METRICS_FILE_INTERVAL = "HOROVOD_METRICS_FILE_INTERVAL"
METRICS_SYNC_SECONDS = "HOROVOD_METRICS_SYNC_SECONDS"

DEFAULT_METRICS_SYNC_SECONDS = 3.0

DEFAULT_CHECKPOINT_INTERVAL_STEPS = 10
DEFAULT_CHECKPOINT_KEEP = 3
DEFAULT_CHECKPOINT_COMMIT_TIMEOUT = 120.0
DEFAULT_DRAIN_GRACE_SECONDS = 30.0
DEFAULT_PREEMPT_SIGNAL = "SIGTERM"

DEFAULT_REPLAY_WINDOW_S = 300.0
DEFAULT_CONNECT_ATTEMPTS = 5
DEFAULT_CONNECT_BACKOFF_SECONDS = 0.1
DEFAULT_CONNECT_BACKOFF_CAP_SECONDS = 2.0
DEFAULT_ELASTIC_READY_TIMEOUT = 180.0
DEFAULT_ELASTIC_RESET_TIMEOUT = 600.0
DEFAULT_ELASTIC_DISCOVERY_INTERVAL = 1.0
DEFAULT_ELASTIC_EPOCH_POLL = 0.5
DEFAULT_BLACKLIST_COOLDOWN_SECONDS = 600.0

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
    "HOROVOD_TRACE_FILE": ("A8", "the tracing plane's merged trace"),
    "HOROVOD_TRACE_DIR": ("A8", "the tracing plane's flight recorder"),
    "HVDRUN_USE_TASK_SERVICE": ("A7", "the task-service launch (runner/service.py)"),
    "HOROVOD_CONTROLLER_INTERVAL_SECONDS": (
        "A7", "the elasticity controller (runner/elastic/controller.py)"),
    "HOROVOD_JOB_NAME": ("A9", "jobs sharing one rendezvous server (the serving plane)"),
    "HOROVOD_FLEET_SLOTS": ("A9", "the shared rendezvous server's capacity arbitration"),
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


def metrics_sync_seconds() -> float:
    """Interval between each rank's telemetry pushes to rank 0's fleet
    view; 0 disables cross-rank aggregation."""
    return _float(METRICS_SYNC_SECONDS, DEFAULT_METRICS_SYNC_SECONDS)


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


def get_str(name: str, default: str = "") -> str:
    val = os.environ.get(name)
    return val if val is not None else default


get_int, get_float, get_bool = _int, _float, _bool


def connect_retry_policy() -> "tuple[int, float, float]":
    """(attempts, base backoff seconds, backoff cap seconds) of the
    rendezvous client's retries."""
    return (max(_int(CONNECT_ATTEMPTS, DEFAULT_CONNECT_ATTEMPTS), 1),
            _float(CONNECT_BACKOFF, DEFAULT_CONNECT_BACKOFF_SECONDS),
            _float(CONNECT_BACKOFF_CAP, DEFAULT_CONNECT_BACKOFF_CAP_SECONDS))


def replay_window() -> float:
    """Seconds a signed rendezvous request stays valid; 0 turns the
    timestamp check off (replays are still refused within a run)."""
    return _float(REPLAY_WINDOW, DEFAULT_REPLAY_WINDOW_S)


def elastic_ready_timeout() -> float:
    """Reset-barrier verdict deadline; 0 disables eviction."""
    return _float(ELASTIC_READY_TIMEOUT, DEFAULT_ELASTIC_READY_TIMEOUT)


def elastic_reset_timeout() -> float:
    """A resetting worker's longest wait for the next topology epoch, and
    its store's wait for the other ranks of that epoch."""
    return _float(ELASTIC_RESET_TIMEOUT, DEFAULT_ELASTIC_RESET_TIMEOUT)


def elastic_discovery_interval() -> float:
    return _float(ELASTIC_DISCOVERY_INTERVAL, DEFAULT_ELASTIC_DISCOVERY_INTERVAL)


def elastic_epoch_poll() -> float:
    return _float(ELASTIC_EPOCH_POLL, DEFAULT_ELASTIC_EPOCH_POLL)


def blacklist_cooldown_seconds() -> float:
    """First-failure blacklist duration; 0 = permanent at once."""
    return _float(BLACKLIST_COOLDOWN, DEFAULT_BLACKLIST_COOLDOWN_SECONDS)


def checkpoint_dir() -> str:
    """The shared checkpoint directory; empty: the durability plane is off."""
    return get_str(CHECKPOINT_DIR, "")


def checkpoint_interval_steps() -> int:
    """Commits between checkpoints; 0: no periodic checkpoint."""
    return max(_int(CHECKPOINT_INTERVAL, DEFAULT_CHECKPOINT_INTERVAL_STEPS), 0)


def checkpoint_keep() -> int:
    """Complete checkpoints the coordinator keeps (at least 1)."""
    return max(_int(CHECKPOINT_KEEP, DEFAULT_CHECKPOINT_KEEP), 1)


def checkpoint_commit_timeout() -> float:
    """The coordinator's bound on collecting every rank's ack."""
    return _float(CHECKPOINT_COMMIT_TIMEOUT, DEFAULT_CHECKPOINT_COMMIT_TIMEOUT)


def checkpoint_fsync() -> bool:
    return _bool(CHECKPOINT_FSYNC, True)


def drain_grace_seconds() -> float:
    """The grace window of a preemption notice (at least 0)."""
    return max(_float(DRAIN_GRACE_SECONDS, DEFAULT_DRAIN_GRACE_SECONDS), 0.0)


def preempt_signal() -> int:
    """HOROVOD_PREEMPT_SIGNAL as a signal number: a name with or without
    the SIG prefix, or a number; anything else is SIGTERM, since the
    handler and the sender must agree."""
    import signal as _signal

    v = get_str(PREEMPT_SIGNAL, DEFAULT_PREEMPT_SIGNAL).strip()
    if not v:
        return _signal.SIGTERM
    try:
        return int(v)
    except ValueError:
        pass
    name = v.upper()
    if not name.startswith("SIG"):
        name = "SIG" + name
    sig = getattr(_signal, name, None)
    return int(sig) if isinstance(sig, _signal.Signals) else int(_signal.SIGTERM)
