"""Worker state registry: each slot's READY/SUCCESS/FAILURE verdict and
the reset decision (counterpart of ``horovod_tpu/runner/elastic/
registration.py``; ref: horovod/runner/elastic/registration.py — a
barrier over the world; when it fills: stop on success or on all failed,
blacklist the failed hosts, hold the reset limit, else driver.resume())."""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ...utils.logging import get_logger

logger = get_logger()

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, driver, host_manager, reset_limit: Optional[int] = None):
        self._driver = driver
        self._hosts = host_manager
        self._lock = threading.Condition()
        self._states: Dict[str, str] = {}      # "host:local_rank" -> state
        self._reset_count = 0
        self._reset_limit = reset_limit
        self._world = 0
        self._expected: Optional[set] = None
        self._epoch = 0
        # One barrier action an epoch: a late verdict must not re-run it.
        self._acted = False

    def reset(self, world_size: int, expected=None):
        """New epoch: act after ``world_size`` verdicts. ``expected`` (a
        set of "host:local_rank" keys) drops the verdicts of slots outside
        it (a worker evicted in the previous epoch that dies a beat later)."""
        with self._lock:
            self._states = {}
            self._world = world_size
            self._expected = set(expected) if expected is not None else None
            self._epoch += 1
            self._acted = False

    def verdicts(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._states)

    @property
    def epoch(self) -> int:
        """Barrier token: a verdict recorded with it counts only toward
        the barrier it was computed against."""
        with self._lock:
            return self._epoch

    @property
    def reset_count(self) -> int:
        return self._reset_count

    def record(self, key: str, state: str, epoch: Optional[int] = None):
        """Record a slot's verdict; the last one fires the barrier action
        (ref: registration.py:113-172)."""
        opener = None
        opener_token = 0
        fire: Optional[Dict[str, str]] = None
        with self._lock:
            if self._driver.finished:
                return
            if epoch is not None and epoch != self._epoch:
                return
            if self._expected is not None and key not in self._expected:
                return
            opened = not self._states
            self._states[key] = state
            logger.debug("worker %s -> %s (%d/%d)", key, state, len(self._states),
                         self._world)
            if opened:
                # The first verdict arms the driver's ready deadline.
                opener = getattr(self._driver, "_on_barrier_opened", None)
                opener_token = self._epoch
            if len(self._states) >= self._world and not self._acted:
                self._acted = True
                fire = dict(self._states)
        # Call out with the registry lock released: the driver's paths take
        # its own lock before they query the registry.
        if opener is not None:
            opener(opener_token)
        if fire is not None:
            self._barrier_action(fire)

    def record_success(self, host: str, local_rank: int):
        self.record(f"{host}:{local_rank}", SUCCESS)

    def record_failure(self, host: str, local_rank: int, epoch: Optional[int] = None):
        self.record(f"{host}:{local_rank}", FAILURE, epoch=epoch)

    def _barrier_action(self, states: Dict[str, str]):
        succeeded = [k for k, v in states.items() if v == SUCCESS]
        failed = [k for k, v in states.items() if v == FAILURE]
        if succeeded and len(succeeded) == len(states):
            self._driver.finish(0)
            return
        if failed and len(failed) == len(states):
            logger.error("all workers failed; stopping job")
            self._driver.finish(1)
            return
        # A partial failure: blacklist each failing host once, resume with
        # the survivors (ref: registration.py:132-172).
        for host in {key.rsplit(":", 1)[0] for key in failed}:
            self._hosts.blacklist(host)
        with self._lock:
            self._reset_count += 1
        if self._reset_limit is not None and self._reset_count > self._reset_limit:
            logger.error("reset limit %d exceeded; stopping job", self._reset_limit)
            self._driver.finish(1)
            return
        self._driver.resume()
