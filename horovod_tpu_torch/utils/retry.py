"""Retry with exponential backoff and full jitter (counterpart of
``horovod_tpu/utils/retry.py``; the port's own copy).

The rendezvous client retries its transport failures through it. Jitter
keeps N workers that lost the same peer from retrying in lockstep. Every
failed attempt the loop absorbs counts in the JAX package's
``horovod_retry_attempts_total``.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from ..common import env as env_cfg
from .logging import get_logger

logger = get_logger()

T = TypeVar("T")

_retry_counter_cache = None


def _retry_counter():
    # Lazy (the launcher imports utils before anything of common) and
    # cached: the loop runs inside polling loops and takes no registry
    # lookup a call.
    global _retry_counter_cache
    if _retry_counter_cache is None:
        from ..common import telemetry

        _retry_counter_cache = telemetry.counter(
            "horovod_retry_attempts_total",
            "Failed attempts absorbed by retry loops (connects, rendezvous KV)",
        )
    return _retry_counter_cache


def backoff_delays(attempts: int, base: float, cap: float):
    """Yield attempts-1 sleep durations: base doubling per attempt,
    capped, with +/-50% jitter."""
    for i in range(attempts - 1):
        d = min(base * (2 ** i), cap)
        yield d * (0.5 + random.random())


def call_with_retry(
    fn: Callable[[], T],
    what: str,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    no_retry_on: Tuple[Type[BaseException], ...] = (PermissionError,),
    attempts: Optional[int] = None,
    base: Optional[float] = None,
    cap: Optional[float] = None,
    deadline: Optional[float] = None,
) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping a jittered exponential
    backoff between failures. ``deadline`` (a monotonic time) bounds the
    whole loop. ``no_retry_on`` wins over ``retry_on`` (an auth rejection
    never heals by retrying). The last failure is re-raised as it was."""
    env_attempts, env_base, env_cap = env_cfg.connect_retry_policy()
    attempts = env_attempts if attempts is None else max(attempts, 1)
    base = env_base if base is None else base
    cap = env_cap if cap is None else cap
    delays = list(backoff_delays(attempts, base, cap)) + [0.0]
    counter = _retry_counter()
    for attempt, delay in enumerate(delays, 1):
        try:
            return fn()
        except no_retry_on:
            raise
        except retry_on as exc:
            counter.inc()
            expired = deadline is not None and time.monotonic() + delay > deadline
            if attempt >= attempts or expired:
                logger.warning("%s failed after %d attempt(s): %s; giving up",
                               what, attempt, exc)
                raise
            log = logger.warning if attempt == 1 else logger.debug
            log("%s failed (attempt %d/%d): %s; retrying in %.2fs",
                what, attempt, attempts, exc, delay)
            time.sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
