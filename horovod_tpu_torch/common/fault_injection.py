"""Deterministic fault injection (counterpart of
``horovod_tpu/common/fault_injection.py``).

``HOROVOD_FAULT_INJECT`` is a ';'-separated rule list in the JAX package's
grammar, e.g. ``kill:step=5:rank=3``. A training loop calls
``advance_step()`` once per batch. On the rank it names (``rank=R``, read
from HOROVOD_RANK; any rank without it):

- ``kill:step=N`` ends the process with ``os._exit(1)`` when the counter
  reaches N (no atexit, no finally: the closest analogue of a SIGKILLed
  worker that still lets the OS close its sockets);
- ``preempt:step=N`` or ``preempt:secs=T`` delivers the preemption notice
  once, at step N or T seconds after the rules load, through the real
  signal path (``os.kill`` of this process with HOROVOD_PREEMPT_SIGNAL),
  so the drain plane's handler (``common/drain.py``) does the work;
- ``diskfail[:after=K][:op=read|write][:path=S]`` raises
  ``InjectedDiskFault`` (an ``OSError``) on each matching disk I/O after
  the first K, and ``diskslow:secs=S`` sleeps S seconds before it: every
  write and checked read of ``utils/atomic_file.py`` asks ``check_disk``.

Every rule of the JAX grammar parses to the same ``Rule``. The port has
no transport of its own to hook, so the actions on network I/O (``sever``,
``drop``, ``delay``, ``hang``) wait for ROADMAP A7; ``wedge`` waits for
the liveness plane (A8.3) and ``killdoor`` for the serving plane (A9).
Armed, each of them raises ``NotImplementedError`` naming its item, at
``hvd.init()`` for the environment's rules. A fired ``preempt``,
``diskfail`` or ``diskslow`` counts in the JAX package's
``horovod_faults_injected_total{action=...}``.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.logging import get_logger
from . import env as env_cfg
from . import telemetry

logger = get_logger()


def _fault_counter(action: str):
    return telemetry.counter(
        "horovod_faults_injected_total",
        "Faults fired by the chaos harness, by action",
        labels={"action": action},
    )

ENV_VAR = "HOROVOD_FAULT_INJECT"

_NET_ACTIONS = ("kill", "sever", "drop", "delay", "wedge", "hang", "preempt")
_DISK_ACTIONS = ("diskfail", "diskslow")
_SERVING_ACTIONS = ("killdoor",)
# action -> the ROADMAP item that ports it
UNPORTED_ACTIONS = {
    "sever": "A7", "drop": "A7", "delay": "A7", "hang": "A7",
    "wedge": "A8", "killdoor": "A9",
}


class InjectedDiskFault(OSError):
    """Raised by a diskfail rule: an OSError, so disk writers run their
    real error paths."""


@dataclass
class Rule:
    action: str
    peer: Optional[int] = None        # None = any peer
    rank: Optional[int] = None        # None = any rank
    op: Optional[str] = None
    after: int = 0
    step: Optional[int] = None        # kill trigger
    secs: float = 0.0
    path: Optional[str] = None
    hits: int = field(default=0, compare=False)


def parse_spec(spec: str) -> List[Rule]:
    """Parse the ``HOROVOD_FAULT_INJECT`` rule grammar (the JAX package's)."""
    rules: List[Rule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        action = fields[0].strip().lower()
        if action not in _NET_ACTIONS + _DISK_ACTIONS + _SERVING_ACTIONS:
            raise ValueError(f"unknown fault action {action!r} in {part!r}")
        kw: Dict[str, str] = {}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(f"bad fault field {f!r} in {part!r}")
            k, v = f.split("=", 1)
            kw[k.strip()] = v.strip()
        rule = Rule(action=action)
        if "peer" in kw:
            rule.peer = int(kw["peer"])
        if "rank" in kw:
            rule.rank = int(kw["rank"])
        if "path" in kw:
            if action not in _DISK_ACTIONS:
                raise ValueError(f"path= applies to disk rules only (got {part!r})")
            rule.path = kw["path"]
        if "op" in kw:
            if action in _SERVING_ACTIONS:
                raise ValueError(f"op= does not apply to {action} rules (got {part!r})")
            valid = (("read", "write") if action in _DISK_ACTIONS
                     else ("connect", "send", "recv"))
            if kw["op"] not in valid:
                raise ValueError(f"bad fault op {kw['op']!r} for {action} "
                                 f"(expected one of {valid})")
            rule.op = kw["op"]
        if action == "drop" and kw.get("op") not in (None, "send"):
            raise ValueError(f"drop rules apply to sends only (got op={kw['op']!r})")
        if "after" in kw:
            rule.after = int(kw["after"])
        if "step" in kw:
            rule.step = int(kw["step"])
        if "secs" in kw:
            rule.secs = float(kw["secs"])
        if rule.action in ("kill", "wedge") and rule.step is None:
            raise ValueError(f"{rule.action} rule needs step=N: {part!r}")
        if rule.action == "preempt" and rule.step is None and rule.secs <= 0:
            raise ValueError(f"preempt rule needs step=N or secs=T: {part!r}")
        if rule.action in ("delay", "diskslow") and rule.secs <= 0:
            raise ValueError(f"{rule.action} rule needs secs=S: {part!r}")
        if rule.action == "killdoor" and rule.after < 0:
            raise ValueError(f"killdoor needs after=N >= 0: {part!r}")
        rules.append(rule)
    return rules


def check_supported(rules: List[Rule]) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of the first
    rule whose action the port does not run yet."""
    for r in rules:
        item = UNPORTED_ACTIONS.get(r.action)
        if item is not None:
            raise NotImplementedError(
                f"{ENV_VAR} rule {r.action!r} is not ported yet (ROADMAP {item}); "
                "the port runs the kill, preempt, diskfail and diskslow rules")


class FaultInjector:
    """Process-wide injector of the rules above."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[Rule] = []
        self._step = 0
        self._env_loaded = False
        self._timers: List[threading.Timer] = []
        self.active = False

    def _load_env(self):
        if self._env_loaded:
            return
        spec = os.environ.get(ENV_VAR, "")
        rules = parse_spec(spec) if spec else []
        check_supported(rules)
        self._env_loaded = True
        if rules:
            self._rules.extend(rules)
            self.active = True
            logger.warning("fault injection armed: %s", spec)
            self._arm_preempt_timers()

    def install(self, rules: List[Rule]):
        check_supported(rules)
        with self._lock:
            self._cancel_timers()
            self._env_loaded = True  # an explicit install overrides the env
            self._rules = list(rules)
            self._step = 0
            self.active = bool(self._rules)
            self._arm_preempt_timers()

    # -- preempt triggers ----------------------------------------------
    def _arm_preempt_timers(self):
        """Arm the ``preempt:secs=T`` rules of this rank (lock held);
        ``hits`` marks a rule armed or fired."""
        own_rank = env_cfg.get_int(env_cfg.RANK, -1)
        for r in self._rules:
            if r.action != "preempt" or r.step is not None or r.hits:
                continue
            if r.rank is not None and r.rank != own_rank:
                continue
            r.hits = 1
            t = threading.Timer(r.secs, self._fire_preempt,
                                args=(f"after {r.secs:.1f}s",))
            t.daemon = True
            t.name = "hvd-fault-preempt"
            self._timers.append(t)
            t.start()

    def _cancel_timers(self):
        for t in self._timers:
            t.cancel()
        self._timers = []

    @staticmethod
    def _fire_preempt(what: str):
        """The notice through the real signal path, as a platform sends it."""
        logger.error("fault injection: preemption notice (%s)", what)
        _fault_counter("preempt").inc()
        os.kill(os.getpid(), env_cfg.preempt_signal())

    # -- triggers --------------------------------------------------------
    def advance_step(self) -> int:
        """Advance the step counter; fires an armed kill or preempt rule."""
        preempt = False
        with self._lock:
            self._load_env()
            if not self.active:
                return 0
            self._step += 1
            step = self._step
            own_rank = env_cfg.get_int(env_cfg.RANK, -1)
            for r in self._rules:
                if r.step is None or (r.rank is not None and r.rank != own_rank):
                    continue
                if r.action == "kill" and step >= r.step:
                    logger.error("fault injection: killing worker at step %d", step)
                    os._exit(1)
                if r.action == "preempt" and step >= r.step and not r.hits:
                    r.hits = 1
                    preempt = True
        if preempt:
            # Outside the lock: the handler runs on this (main) thread at
            # the next bytecode and must not find the lock held.
            self._fire_preempt(f"at step {step}")
        return step

    def check_disk(self, op: str, path: str):
        """The hook of a disk write or read (``op`` 'write' or 'read') of
        ``path``: diskslow sleeps, diskfail raises InjectedDiskFault."""
        if not self.active:
            return
        own_rank = env_cfg.get_int(env_cfg.RANK, -1)
        sleep_s = 0.0
        with self._lock:
            self._load_env()
            for r in self._rules:
                if r.action not in _DISK_ACTIONS:
                    continue
                if r.rank is not None and r.rank != own_rank:
                    continue
                if r.op is not None and r.op != op:
                    continue
                if r.path is not None and r.path not in path:
                    continue
                r.hits += 1
                if r.hits <= r.after:
                    continue
                if r.action == "diskslow":
                    _fault_counter("diskslow").inc()
                    sleep_s += r.secs
                else:
                    _fault_counter("diskfail").inc()
                    raise InjectedDiskFault(
                        f"fault injection failed disk {op} of {path!r}")
        # Outside the lock: the writer thread's sleep must not hold up
        # the training thread's step counter.
        if sleep_s > 0:
            time.sleep(sleep_s)

    @property
    def step(self) -> int:
        return self._step


injector = FaultInjector()


def get_injector() -> FaultInjector:
    with injector._lock:
        injector._load_env()
    return injector


def advance_step() -> int:
    """For training loops: one call per batch."""
    return get_injector().advance_step()
