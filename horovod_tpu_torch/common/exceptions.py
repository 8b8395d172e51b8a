"""Framework exceptions (counterpart of ``horovod_tpu/common/exceptions.py``;
ref: horovod/common/exceptions.py:17-31)."""
import functools
import re


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective fails."""


class NotInitializedError(RuntimeError):
    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call horovod_tpu_torch.init() first."
        )


class HostsUpdatedInterrupt(RuntimeError):
    """Hosts were added or removed: the elastic loop resets the world
    (ref: horovod/common/exceptions.py:24-31). ``skip_sync`` is True when
    only removals happened, so the state needs no broadcast."""

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class WorkerPreempted(SystemExit):
    """Raised on a draining worker once its drain is done (the final
    checkpoint durable, the notice published): the announced-preemption
    exit (``common/drain.py``). A ``SystemExit`` with code 0, so the
    elastic loop's ``finally`` still runs, no ``except Exception`` swallows
    it, and the launcher records an intentional stop."""

    def __init__(self, reason: str = "preempted"):
        super().__init__(0)
        self.reason = reason


# Messages of the failures gloo raises as a plain RuntimeError (a closed
# or reset socket, a timeout); NCCL's come as torch.distributed.DistError.
_COMM_FAILURE = re.compile(r"gloo|NCCL|Connection (reset|closed|refused)|timed out|"
                           r"[Tt]imeout|abort", re.I)


def is_comm_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is a failed collective of torch.distributed (a dead
    peer, a timeout, an aborted communicator), not a misuse."""
    import torch.distributed as dist

    if isinstance(exc, HorovodInternalError):
        return False
    return isinstance(exc, getattr(dist, "DistError", ())) or (
        type(exc) is RuntimeError and bool(_COMM_FAILURE.search(str(exc))))


def comm_failures_raise_internal(fn):
    """Decorator of the direct collectives (those that do not go through
    the engine): a failed collective comes out as ``HorovodInternalError``,
    as the engine's do and the JAX package's transport failures do, so the
    elastic loop restores; and the world is marked failed, so
    ``shutdown()`` aborts its groups instead of waiting on peers."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except RuntimeError as exc:
            if not is_comm_failure(exc):
                raise
            from . import basics

            basics.note_failure()
            raise HorovodInternalError(f"{fn.__name__} failed: {exc}") from exc

    return wrapper
