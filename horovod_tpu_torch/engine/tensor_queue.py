"""Pending-tensor queue shared between framework threads and the engine's
background thread (counterpart of ``horovod_tpu/engine/tensor_queue.py``;
ref: horovod/common/tensor_queue.{h,cc}:28-63).

An entry holds the caller's ``torch.Tensor`` on the rank's device. On a
CUDA tensor it also holds ``ready_event``, recorded on the caller's
current stream at enqueue: the channel stream that reads the tensor waits
on it first (ref: ReadyEvent), since a gradient may still be being written
when its hook enqueues it. Enqueues refused after the engine died and
entries failed by ``finalize`` count in the JAX package's telemetry
counters (``horovod_tensor_queue_*_total``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from ..common import telemetry
from ..common.message import Request
from ..common.types import Status

DUPLICATE_NAME_ERROR = (
    "Requested to collective-op a tensor with the same name as another tensor "
    "that is currently being processed. "
    "(ref: horovod/common/common.h:163-166)"
)


@dataclass
class TensorTableEntry:
    """(ref: horovod/common/common.h TensorTableEntry)"""

    tensor_name: str
    tensor: Optional[torch.Tensor]
    root_rank: int = 0
    callback: Optional[Callable[[Status, object], None]] = None
    # Alltoall splits (ref: operations.cc:979-1042)
    splits: Optional[List[int]] = None
    # The collective's name ("allreduce", "broadcast", ...), the op of the
    # timeline's closing event.
    op_name: str = ""
    # CUDA event on the enqueuing stream, after which the tensor is ready.
    ready_event: Optional[object] = None


class TensorQueue:
    def __init__(self, registry=None):
        if registry is None:
            registry = telemetry.default_registry()
        self._m_latched = registry.counter(
            "horovod_tensor_queue_latched_errors_total",
            "Enqueues rejected because the engine already died "
            "(terminal status latched)")
        self._m_aborted = registry.counter(
            "horovod_tensor_queue_aborted_entries_total",
            "Pending entries failed by finalize() on engine death")
        self._lock = threading.Lock()
        self._tensor_table: Dict[str, TensorTableEntry] = {}
        self._message_queue: List[Request] = []
        # Event-driven cycles: the engine registers its wake event here so
        # an enqueue ends the background loop's coalescing wait at once.
        self._wakeup: Optional[Callable[[], None]] = None
        # Set by finalize(): enqueues after the engine died fail at once
        # with the terminal status instead of parking an entry no loop
        # will ever pop.
        self._final_status: Optional[Status] = None

    def set_wakeup(self, fn: Optional[Callable[[], None]]):
        self._wakeup = fn

    def add_to_tensor_queue(self, entry: TensorTableEntry, request: Request) -> Status:
        return self.add_many([(entry, request)])[0]

    def add_many(self, pairs) -> List[Status]:
        """Add ``(entry, request)`` pairs under one lock, so the background
        loop pops them in one cycle (a grouped all-reduce negotiates as one
        set and fuses)."""
        out = []
        with self._lock:
            for entry, request in pairs:
                if self._final_status is not None:
                    self._m_latched.inc()
                    out.append(self._final_status)
                elif entry.tensor_name in self._tensor_table:
                    out.append(Status.InvalidArgument(DUPLICATE_NAME_ERROR))
                else:
                    self._tensor_table[entry.tensor_name] = entry
                    self._message_queue.append(request)
                    out.append(Status.OK())
        wake = self._wakeup
        if wake is not None:
            wake()
        return out

    def pop_messages_from_queue(self) -> List[Request]:
        with self._lock:
            msgs, self._message_queue = self._message_queue, []
            return msgs

    def get_tensor_entries(self, names: List[str]) -> List[TensorTableEntry]:
        """Remove and return the entries for a response's tensors
        (ref: tensor_queue.cc GetTensorEntriesFromResponse)."""
        with self._lock:
            out = []
            for n in names:
                e = self._tensor_table.pop(n, None)
                if e is not None:
                    out.append(e)
            return out

    def pop_entries_by_prefix(self, prefix: str) -> List[TensorTableEntry]:
        """Complete local JOIN entries when the all-joined response arrives
        (the JOIN Response carries no tensor names)."""
        with self._lock:
            names = [n for n in self._tensor_table if n.startswith(prefix)]
            return [self._tensor_table.pop(n) for n in names]

    def size(self) -> int:
        with self._lock:
            return len(self._tensor_table)

    def pending_names(self) -> List[str]:
        """Names of tensors still awaiting a response (for /status)."""
        with self._lock:
            return sorted(self._tensor_table)

    def finalize(self, status: Status):
        """Abort every pending entry with ``status`` and latch it as the
        terminal state (ref: tensor_queue.cc FinalizeTensorQueue)."""
        with self._lock:
            self._final_status = status
            self._m_aborted.inc(len(self._tensor_table))
            entries = list(self._tensor_table.values())
            self._tensor_table.clear()
            self._message_queue.clear()
        for e in entries:
            if e.callback:
                e.callback(status, None)
