"""The elastic run loop (counterpart of ``horovod_tpu/elastic/run.py``;
ref: horovod/common/elastic.py:115-168 run_fn).

    loop { state.sync(); return train(state);
           except HorovodInternalError -> state.restore();
           except HostsUpdatedInterrupt -> (the commit stands);
           reset: hvd.shutdown(); the next epoch's row; hvd.init();
           state.on_reset() }

``hvd.init()`` after a reset takes the same card (``common/basics.py``:
the spawn slot's), forms its process groups under the new epoch's store
prefix, and starts a new engine. Each reset appends what it took to
``reset_log`` (seconds of restore, shutdown, the wait for the driver's
epoch, init and sync).

With HOROVOD_CHECKPOINT_DIR set the durability plane wraps the loop
(``common/checkpoint.py``): the newest complete checkpoint is restored
into the state before the first sync, so a job whose every worker died
resumes at its last committed checkpoint (``resume_log`` records the step
and the seconds of the restore and of the sync after it); every commit
feeds the manager; after every reset the manager re-anchors its commit
counter on the newest manifest; on the way out its writer finishes. The
drain plane runs managed (``common/drain.py``): a preemption notice is
handed over at a commit, and the draining worker leaves through
``WorkerPreempted``, a ``SystemExit(0)``: a clean exit. Resets, restores
and host updates count in the JAX module's telemetry counters
(``horovod_elastic_*_total``); the events of a reset and the goodput
accounting wait for ROADMAP A8.2 and A8.4.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, List

from ..common import basics, checkpoint, drain, telemetry
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..utils.logging import get_logger
from .state import State

logger = get_logger()

# A fleet whose resets climb while its restores stay flat is churning on
# topology changes; the reverse means workers keep dying mid-step.
_m_resets = telemetry.counter(
    "horovod_elastic_resets_total",
    "Full shutdown+init cycles taken by the elastic run loop")
_m_restores = telemetry.counter(
    "horovod_elastic_restores_total",
    "State restores after a collective failure (worker death)")
_m_host_updates = telemetry.counter(
    "horovod_elastic_host_updates_total",
    "Host add/remove notifications that interrupted training")

# One dict a reset, in order: {"cause", "t_caught" (time.time()),
# "restore_s", "shutdown_s", "rendezvous_s", "init_s", "sync_s"}.
reset_log: List[dict] = []
# One dict a durable restore, in order: {"step", "restore_s", "sync_s",
# "t" (time.time() after the sync)}.
resume_log: List[dict] = []


def _reset(rec: dict):
    """Shut down, take the next epoch's row, init again (ref:
    common/elastic.py reset)."""
    from ..backend import elastic_env

    _m_resets.inc()
    t = time.perf_counter()
    basics.shutdown()       # stops the notification server too
    rec["shutdown_s"] = time.perf_counter() - t
    t = time.perf_counter()
    elastic_env.refresh_topology_from_rendezvous()
    rec["rendezvous_s"] = time.perf_counter() - t
    t = time.perf_counter()
    basics.init()
    rec["init_s"] = time.perf_counter() - t
    elastic_env.notification_manager.init()


def run(func: Callable) -> Callable:
    """Decorator: ``@hvd.elastic.run`` (ref: common/elastic.py:115-130)."""

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        return run_fn(func, state, *args, **kwargs)

    return wrapper


def run_fn(func: Callable, state: State, *args, **kwargs):
    """(ref: common/elastic.py:133-168; the durability and drain planes
    as in ``horovod_tpu/elastic/run.py:63-162``)"""
    from ..backend.elastic_env import notification_manager

    notification_manager.init()
    notification_manager.register_listener(state)
    drain.coordinator.install(managed=True)
    ckpt_mgr = checkpoint.manager_from_env()
    if ckpt_mgr is not None and not state.supports_durability():
        logger.warning("HOROVOD_CHECKPOINT_DIR is set but %s has no durability hooks "
                       "(checkpoint_objects/checkpoint_trees/load_checkpoint); durable "
                       "checkpointing is off", type(state).__name__)
        ckpt_mgr = None
    rec = None
    if ckpt_mgr is not None:
        checkpoint.set_current(ckpt_mgr)
        state.set_checkpoint_manager(ckpt_mgr)
        t = time.perf_counter()
        restored = ckpt_mgr.restore_latest(state)
        if restored is not None:
            logger.info("resuming from durable checkpoint at step %d", restored)
            rec = {"step": restored, "restore_s": time.perf_counter() - t}
            resume_log.append(rec)
    skip_sync = False
    try:
        while True:
            if not skip_sync:
                t = time.perf_counter()
                state.sync()
                if rec is not None:
                    rec["sync_s"] = time.perf_counter() - t
                    rec["t"] = time.time()
            rec = None
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                rec = {"cause": "collective failure", "t_caught": time.time()}
                # A peer that announced a drain leaves on purpose: its exit
                # fails this collective at once.
                logger.warning("collective failure (%s)%s; restoring last commit", e,
                               " (peer draining)" if drain.fleet_draining() else "")
                _m_restores.inc()
                t = time.perf_counter()
                state.restore()
                rec["restore_s"] = time.perf_counter() - t
                skip_sync = False
            except HostsUpdatedInterrupt as e:
                rec = {"cause": "hosts updated", "t_caught": time.time(),
                       "restore_s": 0.0}
                logger.info("hosts updated; re-initializing")
                _m_host_updates.inc()
                skip_sync = e.skip_sync
            reset_log.append(rec)
            _reset(rec)
            state.on_reset()
            if ckpt_mgr is not None:
                # Counters are each rank's own: a worker that joined
                # counted from its restore. Every rank re-anchors on the
                # newest manifest, so the intervals stay in step.
                ckpt_mgr.resync_after_reset()
    finally:
        if ckpt_mgr is not None:
            state.set_checkpoint_manager(None)
            # The last checkpoint of a clean exit is the one a later job
            # restores: let the writer finish it.
            ckpt_mgr.stop()
            if checkpoint.current() is ckpt_mgr:
                checkpoint.set_current(None)
        notification_manager.remove_listener(state)
        # A notice during teardown (the launcher's stop) exits at once.
        drain.coordinator.set_managed(False)
