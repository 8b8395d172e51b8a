"""Stall inspector: coordinator-side watchdog for stuck negotiations
(counterpart of ``horovod_tpu/engine/stall.py``; ref:
horovod/common/stall_inspector.{h,cc}:30-96).

Warns, with the JAX package's text, when a tensor has been submitted by
some ranks but is missing on others for more than
HOROVOD_STALL_CHECK_TIME_SECONDS (default 60); optionally aborts after
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS. Warnings and aborts are the JAX
package's telemetry counters (``horovod_stall_*_total``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Set, Tuple

from ..common import env as env_cfg
from ..common import telemetry
from ..utils.logging import get_logger

logger = get_logger()


class StallInspector:
    def __init__(self, size: int, registry=None):
        if registry is None:
            registry = telemetry.default_registry()
        self._m_warnings = registry.counter(
            "horovod_stall_warnings_total",
            "Tensors that stalled past the warning threshold")
        self._m_aborts = registry.counter(
            "horovod_stall_aborts_total",
            "Stall-shutdown aborts issued by the coordinator")
        self.size = size
        self.enabled = not env_cfg.stall_check_disabled()
        self.warning_time = env_cfg.stall_check_seconds()
        self.shutdown_time = env_cfg.stall_shutdown_seconds()
        self.last_check = time.monotonic()
        # tensor name -> (first-seen time, set of ready ranks)
        self.pending: Dict[str, Tuple[float, Set[int]]] = {}
        self.warned: Set[str] = set()

    def record(self, name: str, rank: int):
        now = time.monotonic()
        if name not in self.pending:
            self.pending[name] = (now, set())
        self.pending[name][1].add(rank)

    def remove(self, name: str):
        self.pending.pop(name, None)
        self.warned.discard(name)

    def check(self) -> Optional[str]:
        """Returns the abort reason when the job should shut down (a
        tensor stalled past HOROVOD_STALL_SHUTDOWN_TIME_SECONDS), else
        None. Truthy-on-abort keeps the old boolean contract; the reason
        string rides the coordinator's shutdown broadcast so EVERY
        rank's pending handles fail with the stall diagnosis — the same
        HorovodInternalError path a transport death takes — instead of a
        generic 'shut down' message only rank 0 can explain."""
        if not self.enabled:
            return None
        now = time.monotonic()
        if now - self.last_check < min(self.warning_time, 10.0):
            return None
        self.last_check = now
        abort: Optional[str] = None
        for name, (t0, ready) in self.pending.items():
            age = now - t0
            missing = sorted(set(range(self.size)) - ready)
            if age > self.warning_time and name not in self.warned:
                logger.warning(
                    "One or more tensors were submitted to be reduced/gathered "
                    "but were not ready on all ranks for %.0fs. Stalled op: %s "
                    "[ready ranks: %s] [missing ranks: %s]",
                    age, name, sorted(ready), missing,
                )
                self.warned.add(name)
                self._m_warnings.inc()
            if self.shutdown_time > 0 and age > self.shutdown_time:
                logger.error("Stall shutdown time exceeded for %s; aborting.", name)
                self._m_aborts.inc()
                if abort is None:
                    abort = (
                        f"stall shutdown: op {name} waited {age:.0f}s "
                        f"(> HOROVOD_STALL_SHUTDOWN_TIME_SECONDS="
                        f"{self.shutdown_time:.0f}) for rank(s) {missing}"
                    )
        return abort
