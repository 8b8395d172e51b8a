"""Elastic state objects: in-memory replicated commits (counterpart of
``horovod_tpu/elastic/state.py``; ref: horovod/common/elastic.py:95-145
State/ObjectState).

``commit()`` saves, then checks for host updates; ``restore()`` rolls back
to the last commit; ``sync()`` broadcasts rank 0's state, so a worker that
joined starts from the same one. ``TorchState`` (``horovod_tpu_torch/
torch/elastic.py``) holds a model and its optimizer. The durability hooks
(checkpoints of the commit, the drain barrier) wait for ROADMAP A7, the
goodput accounting for A8.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List

from ..common.functions import broadcast_object


class State:
    """Base elastic state (ref: common/elastic.py:95-145)."""

    def __init__(self, **kwargs):
        self._reset_callbacks: List[Callable[[], None]] = []
        self._host_messages: List[Any] = []
        self._last_updated_timestamp = 0

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_messages.clear()
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp, update_res):
        self._host_messages.append((timestamp, update_res))

    def commit(self):
        """Save, then check for pending host updates (ref:
        common/elastic.py:60-71)."""
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        """Raise HostsUpdatedInterrupt on every rank together (ref:
        common/elastic.py:73-93). The broadcast runs at every commit:
        notifications reach each worker on its own, so an early return on a
        rank with none queued would leave the others alone in the
        collective. Rank 0's view decides."""
        from ..common.exceptions import HostsUpdatedInterrupt
        from ..runner.elastic.discovery import HostUpdateResult

        prev = last = self._last_updated_timestamp
        res = 0
        for ts, update in self._host_messages:
            if ts > last:
                last = ts
            # OR over every queued message: ADDED then REMOVED is MIXED,
            # which must sync (a new worker waits in sync()).
            if ts > prev:
                res |= update
        self._host_messages.clear()
        prev, last, res = broadcast_object((prev, last, res), root_rank=0,
                                           name="host_update_ts")
        self._last_updated_timestamp = last
        if last > prev:
            # Only a removal-only update may skip the sync: nobody new
            # needs the state.
            raise HostsUpdatedInterrupt(skip_sync=(res == HostUpdateResult.REMOVED))

    # subclass interface
    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


class ObjectState(State):
    """State of picklable attributes (ref: common/elastic.py ObjectState)."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved: Dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._attrs = list(kwargs.keys())
        self.save()

    def save(self):
        self._saved = {k: copy.deepcopy(getattr(self, k)) for k in self._attrs}

    def restore(self):
        # A copy out of the commit: the commit itself is never handed out.
        for k, v in self._saved.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        synced = broadcast_object({k: getattr(self, k) for k in self._attrs},
                                  root_rank=0, name="object_state")
        for k, v in synced.items():
            setattr(self, k, v)
        self.save()
