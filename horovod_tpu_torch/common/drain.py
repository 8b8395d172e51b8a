"""The drain plane: an announced preemption handed over at a commit
(counterpart of ``horovod_tpu/common/drain.py``).

A platform that preempts sends a signal (HOROVOD_PREEMPT_SIGNAL, SIGTERM
by default) and grants a grace window before the kill. Instead of dying
and being detected, the worker drains:

1. **Notice.** The signal handler marks the drain requested, publishes an
   early notice into the rendezvous KV (``drain_e<epoch>/<host:slot>``,
   and the marker ``drain_e<epoch>/any``) so the driver can quarantine the
   host at once, and arms a hard deadline at HOROVOD_DRAIN_GRACE_SECONDS.
2. **Barrier.** At the next ``state.commit()`` every rank all-reduces a
   one-element drain flag (``commit_barrier``), so the whole world learns
   of the drain at the same commit. Every rank then makes that commit
   durable together (``CheckpointManager.save_now``: the coordinator's ack
   barrier needs the whole world).
3. **Handoff.** The draining rank publishes the ``drained`` notice,
   aborts its process groups (so its exit waits on no peer's NCCL
   communicator) and leaves through ``WorkerPreempted``, a
   ``SystemExit(0)``: the launcher and the driver record an intentional
   stop, and the survivors' next collective fails at once on its closed
   sockets, with no liveness timeout to wait out.

If no commit comes within the grace window, the deadline exits the
process with code 0 anyway: at most one checkpoint interval of steps is
lost, the bound of an unannounced failure. Outside an elastic run loop
(``managed=False``: a worker of a static launch, the launcher's teardown)
the handler exits 0 at once, so an intentional stop is never taken for a
failure. The chaos rule ``preempt`` (``common/fault_injection.py``) sends
the signal. Notices and the notice-to-drained seconds are the JAX
module's telemetry series (``horovod_preemptions_total``,
``horovod_drain_seconds``). Its events and goodput hooks (the badput
buckets, the stamp handoff) wait for ROADMAP A8.2 and A8.4.
"""
from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time
from typing import Optional

from ..utils.logging import get_logger
from . import env as env_cfg
from . import telemetry
from .exceptions import WorkerPreempted

logger = get_logger()


def _m_preemptions():
    return telemetry.counter(
        "horovod_preemptions_total",
        "Preemption notices (signal or chaos-injected) this worker "
        "received")


def _m_drain_seconds():
    return telemetry.histogram(
        "horovod_drain_seconds",
        "Preemption notice to drained exit: final checkpoint durable, "
        "stamp released, notice published", min_exp=-4, max_exp=8)

# drain_e<epoch>/<host:spawn_local_rank> -> the notice (JSON), and
# drain_e<epoch>/any -> a marker: "is anyone draining this epoch?"
# without listing keys.
DRAIN_PREFIX = "drain_e"


class DrainCoordinator:
    """A process's drain state (module docstring). ``managed`` is set by
    the elastic run loop on every rank alike, since the commit barrier is
    a collective every rank must agree to run."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requested = threading.Event()
        self._reason = ""
        self._t0: Optional[float] = None          # monotonic, at the notice
        self._deadline: Optional[threading.Timer] = None
        self._managed = False
        self._installed_signum: Optional[int] = None
        self._prev_handler = None
        # The last time a peer's drain was seen at a commit barrier.
        self._peer_mono: Optional[float] = None
        # The hard exits (an unmanaged notice, an expired grace) go through
        # this, so tests observe them instead of dying.
        self._exit = os._exit

    # -- lifecycle -----------------------------------------------------
    def install(self, managed: Optional[bool] = None) -> bool:
        """Register the preemption-signal handler (idempotent; from the
        main thread only, elsewhere skipped). A handler some user code
        installed is left in place. Whether the handler is in place."""
        if managed is not None:
            with self._lock:
                self._managed = managed
        signum = env_cfg.preempt_signal()
        with self._lock:
            if self._installed_signum == signum:
                return True
        try:
            prev = _signal.getsignal(signum)
            if prev not in (_signal.SIG_DFL, None) and prev is not self._on_signal:
                logger.info("preemption signal %d already has a handler; leaving it in "
                            "place (graceful drain disabled)", signum)
                return False
            _signal.signal(signum, self._on_signal)
        except (ValueError, OSError):  # not the main thread, or a bad signal
            return False
        with self._lock:
            self._installed_signum = signum
            self._prev_handler = prev
        return True

    def set_managed(self, managed: bool):
        with self._lock:
            self._managed = managed

    def active(self) -> bool:
        """Whether the commit barrier runs (managed mode)."""
        return self._managed

    def pending(self) -> bool:
        return self._requested.is_set()

    @property
    def reason(self) -> str:
        return self._reason

    # -- the notice ----------------------------------------------------
    def _on_signal(self, signum, frame):
        try:
            name = _signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        self.request(f"signal {name}")

    def request(self, reason: str = "preemption notice"):
        """Mark the drain requested (idempotent): from the signal handler,
        the fault injector, or a test."""
        with self._lock:
            if self._requested.is_set():
                return
            self._requested.set()
            self._reason = reason
            self._t0 = time.monotonic()
            managed = self._managed
        _m_preemptions().inc()
        grace = env_cfg.drain_grace_seconds()
        if not managed:
            logger.warning("preemption notice (%s) outside an elastic run loop: "
                           "exiting cleanly now", reason)
            self._publish_notice("drained")
            self._exit(0)
            return
        logger.warning("preemption notice (%s): draining; final checkpoint at the next "
                       "commit, hard exit in %.0fs", reason, grace)
        # Early, and off the handler's thread: the driver quarantines the
        # host even if this process never reaches another commit.
        threading.Thread(target=self._publish_notice, args=("requested",), daemon=True,
                         name="hvd-drain-notice").start()
        if grace > 0:
            t = threading.Timer(grace, self._grace_expired)
            t.daemon = True
            t.name = "hvd-drain-deadline"
            with self._lock:
                self._deadline = t
            t.start()

    def _grace_expired(self):
        logger.error("drain grace (%.0fs) expired before a commit; exiting without the "
                     "final checkpoint (at most one checkpoint interval of steps is lost)",
                     env_cfg.drain_grace_seconds())
        self._publish_notice("drained")
        self._exit(0)

    def checkpoint_budget(self) -> float:
        """Seconds left for the final checkpoint: the grace window less
        what has passed, less 2 s for the exit."""
        grace = env_cfg.drain_grace_seconds()
        with self._lock:
            t0 = self._t0
        elapsed = 0.0 if t0 is None else time.monotonic() - t0
        return max(1.0, grace - elapsed - 2.0)

    def seconds_since_notice(self) -> Optional[float]:
        with self._lock:
            t0 = self._t0
        return None if t0 is None else time.monotonic() - t0

    # -- completion, on the draining rank at a commit ------------------
    def execute(self, state) -> None:
        """The final checkpoint is durable (``commit_barrier`` ran
        ``save_now`` on every rank): publish ``drained`` and leave through
        ``WorkerPreempted``."""
        with self._lock:
            t, self._deadline = self._deadline, None
        if t is not None:
            t.cancel()
        self._publish_notice("drained")
        with self._lock:
            t0 = self._t0
        if t0 is not None:
            _m_drain_seconds().observe(time.monotonic() - t0)
        logger.warning("drained cleanly (%s); exiting", self._reason)
        # The port's own step: abort this world's process groups, so the
        # exit waits on no peer's NCCL communicator; the peers learn of the
        # exit from the engine's control plane, whose sockets it closes.
        from . import basics

        basics.note_failure()
        raise WorkerPreempted(self._reason or "preempted")

    # -- the survivors -------------------------------------------------
    def note_peer_draining(self):
        self._peer_mono = time.monotonic()

    def fleet_draining(self, window: float = 600.0) -> bool:
        """Whether a disruption now is a preemption: this rank drains, a
        peer's drain was seen at a recent commit barrier, or the epoch's
        drain marker is in the KV (a peer that died on its deadline before
        any barrier)."""
        if self._requested.is_set():
            return True
        t = self._peer_mono
        if t is not None and time.monotonic() - t < window:
            return True
        return self._kv_marker_present()

    def _kv_marker_present(self) -> bool:
        try:
            kv = _kv_from_env()
            if kv is None:
                return False
            from ..backend import elastic_env

            epoch = elastic_env.current_epoch()
            if epoch is None:
                return False
            return kv.get(f"{DRAIN_PREFIX}{epoch}", "any") is not None
        except Exception:
            return False

    # -- the KV notice ---------------------------------------------------
    def _publish_notice(self, phase: str):
        """Best effort: a rendezvous server that is down must never stall or
        fail the drain."""
        try:
            kv = _kv_from_env()
            if kv is None:
                return
            from ..backend import elastic_env
            from . import basics

            epoch = elastic_env.current_epoch()
            if epoch is None:
                return
            ident = elastic_env.spawn_identity()
            doc = {"identity": ident, "phase": phase, "reason": self._reason,
                   "wall": time.time()}
            if basics.is_initialized():
                doc["rank"] = basics.rank()
            scope = f"{DRAIN_PREFIX}{epoch}"
            kv.put(scope, ident, json.dumps(doc).encode())
            kv.put(scope, "any", json.dumps({"wall": doc["wall"], "phase": phase}).encode())
        except Exception as e:
            logger.debug("drain notice publish failed: %s", e)

    # -- tests ---------------------------------------------------------
    def reset(self):
        """Cancel the deadline, put the previous signal handler back, and
        forget everything."""
        with self._lock:
            t, self._deadline = self._deadline, None
            signum, prev = self._installed_signum, self._prev_handler
            self._installed_signum = self._prev_handler = None
            self._requested = threading.Event()
            self._reason = ""
            self._t0 = None
            self._managed = False
            self._peer_mono = None
            self._exit = os._exit
        if t is not None:
            t.cancel()
        if signum is not None:
            try:
                _signal.signal(signum, prev if prev is not None else _signal.SIG_DFL)
            except (ValueError, OSError):
                pass


def _kv_from_env():
    addr = env_cfg.get_str(env_cfg.RENDEZVOUS_ADDR)
    port = env_cfg.get_int(env_cfg.RENDEZVOUS_PORT, 0)
    if addr and port:
        from ..backend.rendezvous import RendezvousClient

        return RendezvousClient(addr, port)
    return None


# The process's coordinator (as ``fault_injection.injector``).
coordinator = DrainCoordinator()


def fleet_draining() -> bool:
    return coordinator.fleet_draining()


def commit_barrier(state) -> None:
    """Once a ``state.commit()``, after the snapshot and before the
    host-update check: an all-reduce of a one-element drain flag, so every
    rank learns of a pending drain at the same commit; then every rank
    makes this commit durable and the draining rank leaves. Outside
    managed mode nothing runs (one attribute read)."""
    coord = coordinator
    if not coord.active():
        return
    from . import basics

    mine = coord.pending()
    if not basics.is_initialized() or basics.size() == 1:
        if mine:
            _drain_commit(coord, state, draining=True)
        return
    import torch

    from .. import ops
    from .types import ReduceOp

    flag = torch.tensor([1.0 if mine else 0.0], device=basics.device())
    out = ops.allreduce(flag, op=ReduceOp.SUM, name="hvd.drain_pending")
    if float(out[0]) <= 0.0:
        return
    _drain_commit(coord, state, draining=mine)


def _drain_commit(coord: DrainCoordinator, state, draining: bool):
    mgr = getattr(state, "_checkpoint_manager", None)
    if mgr is not None:
        try:
            mgr.save_now(state, timeout=coord.checkpoint_budget())
        except Exception as e:
            # The drain still completes: losing the last partial interval
            # is the bound of an unannounced failure.
            logger.error("drain checkpoint failed: %s", e)
    if draining:
        coord.execute(state)
    coord.note_peer_draining()
