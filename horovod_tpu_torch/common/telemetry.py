"""Process-local metrics registry: Counter / Gauge / Histogram
(counterpart of ``horovod_tpu/common/telemetry.py``; the port's own copy,
so a scraper sees the same series, types, labels and help strings from
either package).

Every subsystem of the port (the engine's cycle loop and executors, the
tensor queue, the response cache, the stall inspector, the timeline, the
checkpoint and drain planes, the elastic run loop and driver, the
rendezvous client, retry loops, fault injection, ZeRO) registers its
metrics here, and ``metrics_export`` renders them as Prometheus text,
JSON dumps, or the ``hvd.metrics()`` snapshot dict.

Design constraints:

* **Hot path**: instrumentation sites hold direct references to metric
  objects (no per-call registry lookup); an increment is one attribute
  access plus an int add under a per-metric lock.
* **Histograms** use fixed log2 buckets: ``observe()`` computes the bucket
  index with one ``math.frexp``: no bisection, no allocation.
* **Registries**: one process a rank puts everything in the process-wide
  default registry, which module-level sites (retry loops, fault
  injection) always use; an ``Engine`` may own a registry of its own.

Cross-rank view: each rank periodically piggybacks a scalar snapshot on
the coordinator control plane (``engine/controller.py``); rank 0 folds the
blobs into a ``FleetView`` whose per-metric min/max/sum, tagged with the
extremal rank, makes a straggler show up as a rank-tagged outlier. The
blob is the JAX package's JSON, so either package's ``FleetView`` reads
the other's.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

# Default histogram bucket range: 2^-20 s (~1 us) .. 2^6 s (64 s) for
# latencies; byte-sized histograms override with wider exponents.
DEFAULT_MIN_EXP = -20
DEFAULT_MAX_EXP = 6

LabelDict = Optional[Dict[str, str]]


def _metric_key(name: str, labels: LabelDict) -> str:
    """Stable registry key; doubles as the snapshot dict key."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter. `inc()` is the whole API of the hot path."""

    kind = "counter"

    __slots__ = ("name", "labels", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = "", labels: LabelDict = None):
        self.name = name
        self.labels = dict(labels) if labels else None
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: Union[int, float] = 1):
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def snapshot(self):
        return self._value


class Gauge:
    """Point-in-time value: `set()` for push-style, `set_function()` for
    pull-style (sampled at snapshot time — e.g. queue depth)."""

    kind = "gauge"

    __slots__ = ("name", "labels", "help", "_value", "_fn", "_lock")

    def __init__(self, name: str, help: str = "", labels: LabelDict = None):
        self.name = name
        self.labels = dict(labels) if labels else None
        self.help = help
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: Union[int, float]):
        with self._lock:
            self._value = v

    def inc(self, n: Union[int, float] = 1):
        with self._lock:
            self._value += n

    def dec(self, n: Union[int, float] = 1):
        self.inc(-n)

    def set_function(self, fn: Optional[Callable[[], float]]):
        self._fn = fn

    def clear_function(self, fn: Optional[Callable[[], float]] = None):
        """Detach the pull callback — the public teardown contract for
        owners going away (a dead Engine/backend must not be pinned by
        the process-default registry, nor report frozen state as live).
        Pass the callback you registered to detach only if you are
        still the current owner (a sibling may have taken the gauge
        over); None detaches unconditionally."""
        if fn is None or self._fn == fn:
            self._fn = None

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed log2-bucket histogram.

    Bucket i counts observations in (2^(min_exp+i-1), 2^(min_exp+i)];
    bucket 0 additionally absorbs everything <= 2^min_exp, and a final
    overflow bucket (+Inf) takes v > 2^max_exp. `observe()` is one
    frexp + two int adds + one float add.
    """

    kind = "histogram"

    __slots__ = ("name", "labels", "help", "min_exp", "max_exp",
                 "bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, help: str = "", labels: LabelDict = None,
                 min_exp: int = DEFAULT_MIN_EXP, max_exp: int = DEFAULT_MAX_EXP):
        if max_exp <= min_exp:
            raise ValueError("max_exp must exceed min_exp")
        self.name = name
        self.labels = dict(labels) if labels else None
        self.help = help
        self.min_exp = min_exp
        self.max_exp = max_exp
        # Upper (le) bounds of the finite buckets; +Inf is implicit last.
        self.bounds: List[float] = [
            float(2.0 ** e) for e in range(min_exp, max_exp + 1)
        ]
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def _index(self, v: float) -> int:
        if v <= self.bounds[0]:
            return 0
        if v > self.bounds[-1]:
            return len(self.bounds)
        m, e = math.frexp(v)  # v = m * 2^e, 0.5 <= m < 1
        if m == 0.5:
            e -= 1  # exact powers of two land in their own le bucket
        return e - self.min_exp

    def observe(self, v: Union[int, float]):
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "bounds": list(self.bounds),
                "counts": list(self._counts),
            }


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Thread-safe get-or-create registry of metrics.

    `snapshot()` returns a plain dict (counters/gauges as numbers,
    histograms as {count,sum,bounds,counts}) — the payload behind
    `hvd.metrics()`, the JSON dump and the Prometheus renderer.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labels: LabelDict,
                       **kwargs) -> Metric:
        key = _metric_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {key!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "",
                labels: LabelDict = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: LabelDict = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: LabelDict = None,
                  min_exp: int = DEFAULT_MIN_EXP,
                  max_exp: int = DEFAULT_MAX_EXP) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   min_exp=min_exp, max_exp=max_exp)

    def get(self, name: str, labels: LabelDict = None) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(_metric_key(name, labels))

    def metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, Union[int, float, dict]]:
        return {
            _metric_key(m.name, m.labels): m.snapshot()
            for m in self.metrics()
        }

    def scalars(self) -> Dict[str, float]:
        """Flat numeric view for the cross-rank wire blob: counters and
        gauges verbatim; histograms contribute `<name>_count` and
        `<name>_sum` (the fleet aggregates need no buckets)."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            key = _metric_key(m.name, m.labels)
            if isinstance(m, Histogram):
                out[f"{key}_count"] = m.count
                out[f"{key}_sum"] = m.sum
            else:
                v = m.snapshot()
                if isinstance(v, (int, float)) and not math.isnan(v):
                    out[key] = v
        return out

    def reset(self):
        for m in self.metrics():
            m.reset()


# ---------------------------------------------------------------------------
# Process-wide default registry. One-process-per-rank jobs (the real
# deployment shape) put everything here; the threaded multi-rank test
# harness builds per-Engine registries instead.
_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry


def counter(name: str, help: str = "", labels: LabelDict = None) -> Counter:
    return _default_registry.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: LabelDict = None) -> Gauge:
    return _default_registry.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: LabelDict = None,
              min_exp: int = DEFAULT_MIN_EXP,
              max_exp: int = DEFAULT_MAX_EXP) -> Histogram:
    return _default_registry.histogram(name, help, labels,
                                       min_exp=min_exp, max_exp=max_exp)


# ---------------------------------------------------------------------------
# Build identity + uptime (standard practice for any scraped process;
# the perf regression reporter stamps the same dict into its JSON so
# every BENCH round is attributable to a build).

_PROCESS_START_MONO = time.monotonic()


def build_info() -> Dict[str, str]:
    """Static build identity: the port's package and version, and the
    torch and CUDA versions it runs on (CUDA "none" on a CPU build)."""
    import torch

    from .. import __version__

    return {"package": "horovod_tpu_torch", "version": __version__,
            "torch": torch.__version__, "cuda": torch.version.cuda or "none"}


def register_build_info(registry: Optional[MetricsRegistry] = None) -> dict:
    """Register the `horovod_build_info{package=,version=,torch=,cuda=}` info-gauge
    (constant 1 — the labels ARE the payload, the Prometheus info-metric
    idiom) and `horovod_uptime_seconds` on `registry`. Idempotent."""
    registry = registry or default_registry()
    info = build_info()
    registry.gauge(
        "horovod_build_info",
        "Build identity; the constant-1 value carries its labels",
        labels=info,
    ).set(1)
    registry.gauge(
        "horovod_uptime_seconds",
        "Seconds since this process imported the telemetry layer",
    ).set_function(lambda: time.monotonic() - _PROCESS_START_MONO)
    return info


# ---------------------------------------------------------------------------
# Cross-rank aggregation (coordinator side).

def encode_push(registry: MetricsRegistry, rank: int,
                extra: Optional[dict] = None) -> bytes:
    """Scalar snapshot blob a rank piggybacks on its RequestList.
    `extra` merges additional top-level keys into the JSON (the JAX
    package's tracing, alert and event batches ride there; the port's
    wait for ROADMAP A8.2-A8.4)."""
    doc = {"rank": rank, "time": time.time(), "metrics": registry.scalars()}
    if extra:
        doc.update(extra)
    return json.dumps(doc, separators=(",", ":")).encode("utf-8")


class FleetView:
    """Rank 0's per-rank latest scalar snapshots + min/max/sum rollup.

    A straggler is visible directly: `aggregate[metric]["min_rank"]` /
    `["max_rank"]` name the extremal rank for every metric (e.g. the rank
    with the lowest `allreduce_bytes_total` or the deepest
    `tensor_queue_depth`).
    """

    def __init__(self, size: int):
        self.size = size
        self._lock = threading.Lock()
        # rank -> (wall time of snapshot, scalars)
        self._ranks: Dict[int, Tuple[float, Dict[str, float]]] = {}

    def ingest(self, blob: bytes, rank_hint: Optional[int] = None):
        try:
            d = json.loads(blob.decode("utf-8"))
            if not isinstance(d, dict):
                return
            rank = int(d.get("rank", rank_hint if rank_hint is not None else -1))
            scalars = d.get("metrics", {})
            if not isinstance(scalars, dict):
                return
            t = float(d.get("time", time.time()))
        except Exception:
            return  # a malformed blob must never take down the cycle loop
        if rank < 0:
            return
        with self._lock:
            self._ranks[rank] = (t, scalars)

    def ranks(self) -> Dict[int, Dict[str, float]]:
        with self._lock:
            return {r: dict(s) for r, (_, s) in self._ranks.items()}

    def snapshot(self) -> dict:
        now = time.time()
        with self._lock:
            per_rank = {
                r: {"age_seconds": max(now - t, 0.0), "metrics": dict(s)}
                for r, (t, s) in self._ranks.items()
            }
        agg: Dict[str, dict] = {}
        for r, entry in per_rank.items():
            for name, v in entry["metrics"].items():
                a = agg.get(name)
                if a is None:
                    agg[name] = {"min": v, "max": v, "sum": v, "count": 1,
                                 "min_rank": r, "max_rank": r}
                else:
                    if v < a["min"]:
                        a["min"], a["min_rank"] = v, r
                    if v > a["max"]:
                        a["max"], a["max_rank"] = v, r
                    a["sum"] += v
                    a["count"] += 1
        return {"size": self.size, "ranks": per_rank, "aggregate": agg}


# ---------------------------------------------------------------------------
# One-line step summaries (MetricsCallback in callbacks.py / keras).

class StepSummary:
    """Computes deltas between calls: step time, allreduce MB/s, response
    cache hit rate, plus the goodput plane's window view: goodput% of
    the window's wall-clock and exposed-comm ms per batch (the goodput
    series stay 0 until that plane is ported, ROADMAP A8.4)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or default_registry()
        self._t0 = time.monotonic()
        # Seed baselines from the live counters: the first window must
        # not absorb pre-training traffic (initial parameter broadcast,
        # cold-start negotiation misses).
        (self._bytes0, self._hits0, self._misses0, self._exposed0,
         self._stall0) = self._read()

    def _read(self) -> Tuple[float, float, float, float, float]:
        s = self.registry.scalars()
        return (
            s.get("horovod_allreduce_bytes_total", 0.0),
            s.get("horovod_response_cache_hits_total", 0.0),
            s.get("horovod_response_cache_misses_total", 0.0),
            s.get("horovod_exposed_comm_seconds_total", 0.0),
            s.get("horovod_ckpt_stall_seconds_total", 0.0),
        )

    def line(self, steps: int) -> str:
        """Summary line covering the `steps` batches since the last call."""
        now = time.monotonic()
        b, h, m, ex, stall = self._read()
        dt = max(now - self._t0, 1e-9)
        db = b - self._bytes0
        dh, dm = h - self._hits0, m - self._misses0
        dex = max(ex - self._exposed0, 0.0)
        dstall = max(stall - self._stall0, 0.0)
        (self._t0, self._bytes0, self._hits0, self._misses0,
         self._exposed0, self._stall0) = now, b, h, m, ex, stall
        step_ms = dt / max(steps, 1) * 1e3
        mbps = db / dt / 1e6
        lookups = dh + dm
        hit_pct = (100.0 * dh / lookups) if lookups else 0.0
        # Window goodput%: the share of this window's wall-clock NOT
        # lost to exposed comm or checkpoint stalls (the in-window form
        # of the ledger's job-level ratio).
        good_pct = 100.0 * max(dt - dex - dstall, 0.0) / dt
        comm_ms = dex / max(steps, 1) * 1e3
        return (f"step {step_ms:.1f}ms | allreduce {mbps:.1f}MB/s | "
                f"cache hit {hit_pct:.0f}% | goodput {good_pct:.0f}% | "
                f"comm {comm_ms:.1f}ms")


class StepSummaryLogger:
    """Interval gate + rank-0 filter around StepSummary (the body of the
    JAX package's MetricsCallback, whose port waits for ROADMAP A10)."""

    def __init__(self, interval: int = 100, log_fn=None,
                 root_only: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        if interval <= 0:
            raise ValueError("interval must be positive")
        if log_fn is None:
            from ..utils.logging import get_logger

            log_fn = lambda line: get_logger().info("%s", line)  # noqa: E731
        self.interval = interval
        self.root_only = root_only
        self._log = log_fn
        self._summary = StepSummary(registry)
        self._batches = 0

    def step(self):
        """Call once per batch; logs every `interval` batches (rank 0
        only when root_only)."""
        from . import basics

        self._batches += 1
        if self._batches % self.interval:
            return
        if self.root_only and basics.is_initialized() and basics.rank() != 0:
            return
        self._log(f"[metrics] {self._summary.line(self.interval)}")
