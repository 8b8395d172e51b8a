"""Chrome-trace file reading (counterpart of
``horovod_tpu/utils/chrome_trace.py``; the port's own copy of the readers
it uses). A Chrome-trace document is either a bare event list or an
object with a ``traceEvents`` key; ``trace_events`` normalises both.
"""
from __future__ import annotations

import json
from typing import List


def read_trace_file(path: str):
    """Load one Chrome-trace JSON file (.json or .json.gz)."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def trace_events(doc) -> List[dict]:
    """Normalize a Chrome-trace document to its event list."""
    if isinstance(doc, list):
        return doc
    return doc.get("traceEvents", [])
