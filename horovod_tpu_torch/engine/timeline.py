"""Chrome-tracing timeline writer (counterpart of
``horovod_tpu/engine/timeline.py``; ref: horovod/common/timeline.{h,cc}
:47-126).

Per-tensor lanes with a NEGOTIATE_<OP> phase (per-rank ready ticks), then
the op phase with nested activities (MEMCPY_IN_FUSION_BUFFER, the op's
implementation such as NCCL_ALLREDUCE, MEMCPY_OUT_FUSION_BUFFER). Records
are pushed to a writer thread through a queue so the hot path never
blocks on file IO. Enabled by HOROVOD_TIMELINE=<file> and written by the
coordinator only (ref: operations.cc:416-429), in the JAX package's event
names and layout. Events a full queue drops count in the JAX package's
``horovod_trace_events_dropped_total{source="timeline"}``.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, Optional

from ..common import env as env_cfg
from ..common import telemetry
from ..utils import clock
from ..utils.logging import get_logger

logger = get_logger()

# Activity names (ref: horovod/common/common.h:32-62)
QUEUE = "QUEUE"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
NEGOTIATE = "NEGOTIATE"


class Timeline:
    def __init__(self, filename: Optional[str] = None, use_env: bool = True,
                 registry=None, queue_size: int = 1 << 20):
        # use_env=False on non-coordinator ranks: only rank 0 writes
        # (ref: operations.cc:416-429).
        if filename is None and use_env:
            filename = env_cfg.timeline_file() or None
        self.filename = filename
        self.enabled = bool(self.filename)
        self.mark_cycles = env_cfg.timeline_mark_cycles()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        # Multi-writer: the background loop (negotiation phases) and the
        # channel executors (op phases) emit concurrently; lane-id
        # allocation is the only read-modify-write and takes the lock.
        self._tids: Dict[str, int] = {}
        self._tid_lock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # A full writer queue drops events (the hot path must never block
        # on file IO); count them and warn once.
        self._m_dropped = (registry or telemetry.default_registry()).counter(
            "horovod_trace_events_dropped_total",
            "Trace events lost before reaching an output (flight-"
            "recorder ring overwrites, timeline writer-queue drops)",
            labels={"source": "timeline"})
        self._warned_drop = False
        if self.enabled:
            self._writer = threading.Thread(
                target=self._write_loop, name="hvd-timeline", daemon=True
            )
            self._writer.start()

    def _ts(self) -> float:
        # Shared process anchor (utils/clock): the wall-clock identity in
        # the metadata event lets other processes' traces be spliced in.
        return clock.trace_us(clock.mono_ns())  # microseconds

    def _tid(self, tensor_name: str) -> int:
        with self._tid_lock:
            tid = self._tids.get(tensor_name)
            if tid is None:
                tid = self._tids[tensor_name] = len(self._tids) + 1
            return tid

    def _emit(self, ev: dict):
        if not self.enabled:
            return
        try:
            self._q.put_nowait(ev)
        except queue.Full:
            self._m_dropped.inc()
            if not self._warned_drop:
                self._warned_drop = True
                logger.warning(
                    "timeline writer queue is full; dropping events (the "
                    "trace will have gaps)")

    # -- per-tensor state machine (ref: timeline.h:81-126) --------------
    def negotiate_start(self, name: str, op_name: str):
        self._emit({"ph": "B", "name": f"NEGOTIATE_{op_name}", "pid": 0,
                    "tid": self._tid(name), "ts": self._ts()})

    def negotiate_rank_ready(self, name: str, rank: int):
        self._emit({"ph": "i", "name": str(rank), "pid": 0,
                    "tid": self._tid(name), "ts": self._ts(), "s": "t"})

    def negotiate_end(self, name: str, op_name: str):
        self._emit({"ph": "E", "name": f"NEGOTIATE_{op_name}", "pid": 0,
                    "tid": self._tid(name), "ts": self._ts()})

    def start(self, name: str, op_name: str):
        self._emit({"ph": "B", "name": op_name, "pid": 0,
                    "tid": self._tid(name), "ts": self._ts()})

    def activity_start(self, name: str, activity: str):
        self._emit({"ph": "B", "name": activity, "pid": 0,
                    "tid": self._tid(name), "ts": self._ts()})

    def activity_end(self, name: str):
        self._emit({"ph": "E", "pid": 0, "tid": self._tid(name), "ts": self._ts()})

    def activity(self, name: str, activity: str):
        """Context manager: the E event fires even when the op raises,
        keeping B/E balanced on the lane (an unbalanced lane nests every
        later event under the dangling phase in the trace viewer)."""
        import contextlib

        @contextlib.contextmanager
        def _span():
            self.activity_start(name, activity)
            try:
                yield
            finally:
                self.activity_end(name)

        return _span()

    def end(self, name: str, op_name: str):
        self._emit({"ph": "E", "name": op_name, "pid": 0,
                    "tid": self._tid(name), "ts": self._ts()})

    def mark_cycle(self):
        if self.mark_cycles:
            self._emit({"ph": "i", "name": "CYCLE", "pid": 0, "tid": 0,
                        "ts": self._ts(), "s": "g"})

    # -------------------------------------------------------------------
    def _write_loop(self):
        with open(self.filename, "w") as f:
            f.write("[\n")
            # Clock-anchor metadata event first: the wall-clock identity
            # of this file's t=0, so offline tools can splice it against
            # the mesh timeline's device lanes (or another process's
            # host lanes) on a common axis.
            f.write(json.dumps({"ph": "M", "name": "horovod_clock",
                                "pid": 0, "tid": 0,
                                "args": clock.anchor_meta()}))
            first = False
            while not self._stop.is_set() or not self._q.empty():
                try:
                    ev = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if not first:
                    f.write(",\n")
                f.write(json.dumps(ev))
                first = False
                f.flush()
            f.write("\n]\n")

    def shutdown(self):
        if self.enabled and self._writer is not None:
            # Disable BEFORE draining so no new events race the flush,
            # then give the writer time proportional to the backlog
            # instead of a flat 5s that abandons buffered events of a
            # long run mid-file.
            self.enabled = False
            self._stop.set()
            deadline = time.monotonic() + 30.0
            while self._writer.is_alive() and time.monotonic() < deadline:
                self._writer.join(timeout=1.0)
            if self._writer.is_alive():
                logger.warning(
                    "timeline writer did not drain %d buffered events "
                    "before shutdown", self._q.qsize())
            dropped = self._m_dropped.value
            if dropped:
                logger.warning(
                    "timeline dropped %d events during the run (writer "
                    "queue full); the trace has gaps", dropped)
