"""Shared monotonic/wall clock anchor for every trace producer
(counterpart of ``horovod_tpu/utils/clock.py``; the port's own copy).

One process-wide anchor: ``MONO_ANCHOR_NS`` / ``WALL_ANCHOR_NS`` are
captured once at import, every host trace event's ``ts`` is microseconds
since that monotonic anchor (``trace_us``), and ``anchor_meta()`` stamps
the wall-clock identity of the anchor into each output file so offline
tools can align files from different processes via wall time. Cross-rank
alignment (different machines, different clocks) is not this module's.
"""
from __future__ import annotations

import os
import socket
import time

# Captured once per process; every host-side trace ts derives from it.
MONO_ANCHOR_NS: int = time.monotonic_ns()
WALL_ANCHOR_NS: int = time.time_ns()


def mono_ns() -> int:
    """The one timestamp source for trace events and latency histograms."""
    return time.monotonic_ns()


def trace_us(ns: int) -> float:
    """Chrome-trace ``ts``: microseconds since the process anchor."""
    return (ns - MONO_ANCHOR_NS) / 1e3


def anchor_meta() -> dict:
    """Identity of this process's trace origin, embedded in every trace
    file so offline tools can align files captured by different
    processes (or splice in device lanes timed against wall clock)."""
    return {
        "mono_anchor_ns": MONO_ANCHOR_NS,
        "wall_anchor_ns": WALL_ANCHOR_NS,
        "pid": os.getpid(),
        "host": os.environ.get("HOROVOD_HOSTNAME") or socket.gethostname(),
    }
