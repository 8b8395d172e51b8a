"""Host discovery for elastic training (counterpart of
``horovod_tpu/runner/elastic/discovery.py``; ref: horovod/runner/elastic/
discovery.py — HostDiscoveryScript runs a user script that prints
``hostname[:slots]`` lines; HostManager keeps a stable, oldest-first host
order and a blacklist).

The blacklist is cooldown-with-escalation: a host's first failure parks it
for HOROVOD_BLACKLIST_COOLDOWN_SECONDS, a repeat failure for good (0: for
good at once). A host whose worker announced a drain is quarantined
instead: excluded for a while, with no strike, never for good. A
blacklisting counts in the JAX module's
``horovod_hosts_blacklisted_total``; its event waits for ROADMAP A8.2.
"""
from __future__ import annotations

import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...common import env as env_cfg
from ...common import telemetry
from ...utils.logging import get_logger

logger = get_logger()


class HostUpdateResult:
    NO_UPDATE = 0
    REMOVED = 1
    ADDED = 2
    MIXED = REMOVED | ADDED


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """hostname -> slots."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """(ref: discovery.py:130-152)"""

    def __init__(self, discovery_script: str, slots: Optional[int] = None):
        self.script = discovery_script
        self.default_slots = slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.check_output(self.script, shell=True, timeout=60).decode()
        hosts: Dict[str, int] = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                name, slots = line.rsplit(":", 1)
                hosts[name] = int(slots)
            else:
                if self.default_slots is None:
                    raise ValueError(
                        f"discovery line {line!r} has no slot count and no "
                        "--slots-per-host default was given")
                hosts[line] = self.default_slots
        return hosts


class FixedHosts(HostDiscovery):
    """(ref: discovery.py FixedHosts)"""

    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def set(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class HostManager:
    """Stable-ordered view of the available hosts, with blacklisting (ref:
    discovery.py:79-121: the order keeps host age, so rank 0 stays on the
    oldest surviving host, which carries the state through resets)."""

    def __init__(self, discovery: HostDiscovery, cooldown: Optional[float] = None):
        self._discovery = discovery
        self._order: List[str] = []          # first-seen order
        self._current: Dict[str, int] = {}
        self._blacklist: Dict[str, float] = {}   # host -> expiry (monotonic; inf)
        self._quarantine: Dict[str, float] = {}  # host -> expiry (monotonic)
        self._strikes: Dict[str, int] = {}
        self._cooldown = env_cfg.blacklist_cooldown_seconds() if cooldown is None \
            else cooldown
        self._lock = threading.Lock()

    def _active_blacklist(self) -> set:
        """Prune expired cooldowns; call with the lock held."""
        now = time.monotonic()
        for h in [h for h, exp in self._blacklist.items() if exp <= now]:
            del self._blacklist[h]
            logger.warning("blacklist cooldown expired for host %s; it is eligible "
                           "again (a repeat failure will blacklist it permanently)", h)
        return set(self._blacklist)

    def update_available_hosts(self) -> int:
        new = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            # The previous view is filtered with the blacklist as it was:
            # a host whose cooldown just lapsed is then ADDED.
            prev_excluded = set(self._blacklist) | set(self._quarantine)
            excluded = self._active_blacklist() | self._active_quarantine()
            prev_active = {h: s for h, s in self._current.items()
                           if h not in prev_excluded}
            res = HostUpdateResult.NO_UPDATE
            for h in new:
                if h not in self._order:
                    self._order.append(h)
            active = {h: s for h, s in new.items() if h not in excluded}
            if set(active) - set(prev_active) or any(
                    active.get(h, 0) > prev_active.get(h, 0) for h in active):
                res |= HostUpdateResult.ADDED
            if set(prev_active) - set(active) or any(
                    active.get(h, 0) < prev_active.get(h, 0)
                    for h in prev_active if h in active):
                res |= HostUpdateResult.REMOVED
            self._current = new
            return res

    @property
    def current_hosts(self) -> List[Tuple[str, int]]:
        """Active (hostname, slots), oldest first."""
        with self._lock:
            excluded = self._active_blacklist() | self._active_quarantine()
            return [(h, self._current[h]) for h in self._order
                    if h in self._current and h not in excluded
                    and self._current[h] > 0]

    def _active_quarantine(self) -> set:
        """Prune expired quarantines; call with the lock held."""
        now = time.monotonic()
        for h in [h for h, exp in self._quarantine.items() if exp <= now]:
            del self._quarantine[h]
            logger.info("drain quarantine expired for host %s; it is eligible again", h)
        return set(self._quarantine)

    def quarantine(self, host: str, seconds: float):
        """Exclude a draining host for ``seconds``: a drain is intended, so
        it costs no strike and never becomes permanent."""
        with self._lock:
            expiry = time.monotonic() + max(seconds, 0.0)
            self._quarantine[host] = max(expiry, self._quarantine.get(host, 0.0))
        logger.warning("quarantining draining host %s for %.0fs", host, max(seconds, 0.0))

    def is_quarantined(self, host: str) -> bool:
        with self._lock:
            return host in self._active_quarantine()

    def blacklist(self, host: str):
        with self._lock:
            self._strikes[host] = strikes = self._strikes.get(host, 0) + 1
            if strikes > 1 or self._cooldown <= 0:
                expiry, how = float("inf"), "permanently"
            else:
                expiry = time.monotonic() + self._cooldown
                how = f"for {self._cooldown:.0f}s (first failure)"
            already = self._blacklist.get(host)
            self._blacklist[host] = max(expiry, already or 0.0)
            if already is None:
                logger.warning("blacklisting host %s %s", host, how)
                telemetry.counter(
                    "horovod_hosts_blacklisted_total",
                    "Hosts blacklisted after worker failures",
                ).inc()

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return host in self._active_blacklist()

    def available_slots(self) -> int:
        return sum(s for _, s in self.current_hosts)
