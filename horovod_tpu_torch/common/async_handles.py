"""Handles of the asynchronous collectives (counterpart of
``horovod_tpu/common/async_handles.py``).

A handle is an integer key to a pending collective: the
``torch.distributed.Work`` it launched (or ``None`` when the result was
ready at once) and the function that turns the collective's buffers into
the caller's result once it has finished (scale, slice, cast back).
Handles count up from 0 under a lock and are never reused, so two
handles never name the same collective.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, Optional, Tuple


class HandleTable:
    def __init__(self):
        self._ids = itertools.count()
        self._pending: Dict[int, Tuple[Optional[Any], Callable[[], Any]]] = {}
        self._lock = threading.Lock()

    def put(self, work, finish: Callable[[], Any]) -> int:
        with self._lock:
            handle = next(self._ids)
            self._pending[handle] = (work, finish)
        return handle

    def _get(self, handle: int):
        try:
            return self._pending[handle]
        except KeyError:
            raise ValueError(f"unknown or already synchronized handle {handle}") from None

    def poll(self, handle: int) -> bool:
        """True once the collective has finished; never blocks."""
        with self._lock:
            work, _ = self._get(handle)
        return work is None or work.is_completed()

    def synchronize(self, handle: int):
        """Wait for the collective, drop the handle, return the result."""
        with self._lock:
            work, finish = self._get(handle)
            del self._pending[handle]
        if work is not None:
            work.wait()
        return finish()
