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
epoch, init and sync). Durable checkpoints and the drain plane wait for
ROADMAP A7 (their knobs raise at ``init()``), the metrics and events of a
reset for A8.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, List

from ..common import basics
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..utils.logging import get_logger
from .state import State

logger = get_logger()

# One dict a reset, in order: {"cause", "t_caught" (time.time()),
# "restore_s", "shutdown_s", "rendezvous_s", "init_s", "sync_s"}.
reset_log: List[dict] = []


def _reset(rec: dict):
    """Shut down, take the next epoch's row, init again (ref:
    common/elastic.py reset)."""
    from ..backend import elastic_env

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
    """(ref: common/elastic.py:133-168)"""
    from ..backend.elastic_env import notification_manager

    notification_manager.init()
    notification_manager.register_listener(state)
    skip_sync = False
    rec = None
    try:
        while True:
            if not skip_sync:
                t = time.perf_counter()
                state.sync()
                if rec is not None:
                    rec["sync_s"] = time.perf_counter() - t
            rec = None
            try:
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                rec = {"cause": "collective failure", "t_caught": time.time()}
                logger.warning("collective failure (%s); restoring last commit", e)
                t = time.perf_counter()
                state.restore()
                rec["restore_s"] = time.perf_counter() - t
                skip_sync = False
            except HostsUpdatedInterrupt as e:
                rec = {"cause": "hosts updated", "t_caught": time.time(),
                       "restore_s": 0.0}
                logger.info("hosts updated; re-initializing")
                skip_sync = e.skip_sync
            reset_log.append(rec)
            _reset(rec)
            state.on_reset()
    finally:
        notification_manager.remove_listener(state)
