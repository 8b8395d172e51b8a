"""CLI flags -> HOROVOD_* environment of the workers (counterpart of
``horovod_tpu/runner/config_parser.py``; ref: horovod/runner/common/util/
config_parser.py). The flags of the autotuner and the hierarchical
collectives stay, and the knobs they set raise at ``init()`` naming their
ROADMAP item (``common/env.py`` ``UNPORTED``), so none is silently
dropped."""
from __future__ import annotations

from typing import Dict

from ..common import env as env_cfg

# argparse dest -> env name
_ARG_TO_ENV = {
    "fusion_threshold_mb": env_cfg.FUSION_THRESHOLD,
    "cycle_time_ms": env_cfg.CYCLE_TIME,
    "cache_capacity": env_cfg.CACHE_CAPACITY,
    "hierarchical_allreduce": "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "hierarchical_allgather": "HOROVOD_HIERARCHICAL_ALLGATHER",
    "autotune": "HOROVOD_AUTOTUNE",
    "autotune_log_file": "HOROVOD_AUTOTUNE_LOG",
    "timeline_filename": env_cfg.TIMELINE,
    "timeline_mark_cycles": env_cfg.TIMELINE_MARK_CYCLES,
    "no_stall_check": env_cfg.STALL_CHECK_DISABLE,
    "stall_check_warning_time_seconds": env_cfg.STALL_CHECK_TIME,
    "stall_check_shutdown_time_seconds": env_cfg.STALL_SHUTDOWN_TIME,
    "log_level": env_cfg.LOG_LEVEL,
}


def args_to_env(args) -> Dict[str, str]:
    """The env additions for worker processes from parsed args."""
    env: Dict[str, str] = {}
    for dest, name in _ARG_TO_ENV.items():
        val = getattr(args, dest, None)
        if val is None or val is False:
            continue
        if dest == "fusion_threshold_mb":
            env[name] = str(int(float(val) * 1024 * 1024))
        elif val is True:
            env[name] = "1"
        else:
            env[name] = str(val)
    return env


def add_engine_args(parser):
    """The engine's knob flags (ref: launch.py parser groups)."""
    g = parser.add_argument_group("tuning")
    g.add_argument("--fusion-threshold-mb", type=float, default=None,
                   help="tensor fusion threshold in MB (default 64)")
    g.add_argument("--cycle-time-ms", type=float, default=None,
                   help="background cycle time in ms (default 5)")
    g.add_argument("--cache-capacity", type=int, default=None,
                   help="response cache capacity (default 1024; 0 disables)")
    g.add_argument("--hierarchical-allreduce", action="store_true", default=None)
    g.add_argument("--hierarchical-allgather", action="store_true", default=None)
    g.add_argument("--autotune", action="store_true", default=None)
    g.add_argument("--autotune-log-file", default=None)
    t = parser.add_argument_group("observability")
    t.add_argument("--timeline-filename", default=None,
                   help="write a Chrome-tracing timeline here (rank 0)")
    t.add_argument("--timeline-mark-cycles", action="store_true", default=None)
    t.add_argument("--no-stall-check", action="store_true", default=None)
    t.add_argument("--stall-check-warning-time-seconds", type=float, default=None)
    t.add_argument("--stall-check-shutdown-time-seconds", type=float, default=None)
    t.add_argument("--log-level", default=None,
                   choices=["TRACE", "DEBUG", "INFO", "WARNING", "ERROR", "FATAL"])
    return parser
