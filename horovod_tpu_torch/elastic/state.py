"""Elastic state objects: in-memory replicated commits (counterpart of
``horovod_tpu/elastic/state.py``; ref: horovod/common/elastic.py:95-145
State/ObjectState).

``commit()`` saves, offers the commit to the durability plane's manager
(``set_checkpoint_manager``; ``common/checkpoint.py``), runs the drain
barrier (``common/drain.py``) and then checks for host updates;
``restore()`` rolls back to the last commit; ``sync()`` broadcasts rank
0's state, so a worker that joined starts from the same one. The
durability hooks (``supports_durability``, ``checkpoint_objects``,
``checkpoint_trees``, ``load_checkpoint``) hand the manager the last
commit, never the live attributes. ``TorchState`` (``horovod_tpu_torch/
torch/elastic.py``) holds a model and its optimizer. The goodput
accounting of a commit waits for ROADMAP A8.4.
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
        """Save, feed the checkpoint manager, run the drain barrier, then
        check for pending host updates (ref: common/elastic.py:60-71). The
        manager and the drain come before the host-update check, which may
        raise HostsUpdatedInterrupt: neither the snapshot nor the handoff
        may be lost to the reset."""
        self.save()
        mgr = getattr(self, "_checkpoint_manager", None)
        if mgr is not None:
            mgr.maybe_save(self)
        from ..common import drain

        drain.commit_barrier(self)
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

    def set_checkpoint_manager(self, manager):
        """Attach the durability plane: every ``commit()`` then also feeds
        the manager, which checkpoints the commit every N commits. The
        elastic run loop attaches it from HOROVOD_CHECKPOINT_DIR."""
        self._checkpoint_manager = manager

    # subclass interface
    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass

    # -- durability hooks ------------------------------------------------
    def supports_durability(self) -> bool:
        """Whether this state has the checkpoint hooks: the run loop attaches
        no manager to one that would commit checkpoints it cannot load."""
        return False

    def checkpoint_objects(self) -> dict:
        return {}

    def checkpoint_trees(self) -> dict:
        """{attr: flat leaf list} of the last commit."""
        return {}

    def load_checkpoint(self, objects: dict, trees: dict):
        raise NotImplementedError("this State subclass does not support durable checkpoints")


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

    # -- durability hooks ------------------------------------------------
    def supports_durability(self) -> bool:
        return True

    def checkpoint_objects(self) -> dict:
        # save() deep-copies into a new dict and rebinds ``_saved``, so the
        # writer may pickle this one while training commits on.
        return self._saved

    def load_checkpoint(self, objects: dict, trees: dict):
        if trees:
            raise ValueError("checkpoint holds tensor leaves but this state is a plain "
                             "ObjectState; restore into a TorchState")
        for k, v in objects.items():
            setattr(self, k, copy.deepcopy(v))
            if k not in self._attrs:
                self._attrs.append(k)
        self.save()
