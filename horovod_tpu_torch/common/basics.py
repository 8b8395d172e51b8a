"""Process-group lifecycle and rank topology over ``torch.distributed``.

Counterpart of ``horovod_tpu/common/basics.py:134-309``. One process per
rank: rank and size come from ``HOROVOD_RANK``/``HOROVOD_SIZE`` (or
``RANK``/``WORLD_SIZE``); with neither set the world is one process. The
device is ``cuda:<local_rank>`` with NCCL unless the caller passes
``device="cpu"``, which uses gloo; without CUDA and without that request,
``init`` raises.

Rendezvous: ``init_method`` if given, else ``HOROVOD_INIT_METHOD``, else
``env://`` when ``MASTER_ADDR`` is set; a world of one needs none and uses
a FileStore in a fresh temporary directory (no port to collide on when
many test workers run at once).

``init`` also starts the eager engine (``engine/engine.py``), as the JAX
package's process mode does (``horovod_tpu/common/basics.py:82-131``):
past a world of one it first makes the engine's groups, on every rank in
one order: a gloo group for its control plane, then one data group a
channel (NCCL on CUDA, gloo on the CPU), each NCCL one warmed by a one-
element all-reduce so that its communicator exists before the engine's
threads use it. ``shutdown`` stops the engine collectively, then the
process group. Set knobs of unported modules raise first
(``env.check_unported_knobs``), as do fault-injection rules the port does
not run (``common/fault_injection.py``).

Under the launcher (``runner/launch.py``), HOROVOD_STORE_PORT names the
``TCPStore`` the launcher hosts at the rendezvous address; the process
groups form on it under the prefix HOROVOD_MESH_SCOPE (the elastic
driver's epoch) and this process's count of inits at that scope, so no
key of an earlier world is read again and the store lives in no worker.
The card is the one of the local slot the process was spawned into
(HOROVOD_SPAWN_LOCAL_RANK, else the local rank), and an ``init()`` without
a device takes the device of the process's first one, so a live process
keeps its card (or the CPU) when an elastic reset reassigns local ranks.

A failed collective (the engine's fatal error, or a direct collective's,
``note_failure``) aborts every process group of this world at once: a
NCCL kernel waiting on a dead peer ends, and so does a gloo operation,
whose peers then fail too. NCCL's watchdog is set to abort on its own
errors and timeouts without ending the process
(TORCH_NCCL_ASYNC_ERROR_HANDLING=2 unless it is set). ``shutdown()``
after a failure is local: nothing waits for the other ranks, and the card
stays usable for the next ``init()``.

In a launched worker (HOROVOD_RANK or HOROVOD_ELASTIC set) ``init``
installs the drain plane's handler of HOROVOD_PREEMPT_SIGNAL
(``common/drain.py``).

The mode is the JAX package's rule: "process" when HOROVOD_RANK is set (a
launched worker), else "mesh" (one program over ``create_mesh``). The
engine runs in both (the port's world collectives go through it), but, as
in the JAX package, process mode lets the engine own the exporters the
environment asks for (HOROVOD_METRICS_PORT, HOROVOD_METRICS_FILE;
``common/metrics_export.py``), with its fleet view and ``/status``, while
mesh mode starts them here on the registry alone. Every init sets the
``horovod_world_size`` gauge and registers the build identity;
``metrics()`` is the JAX package's ``hvd.metrics()``; ``shutdown`` stops
the exporters, so that the next init binds the same port again.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import shutil
import tempfile
import threading
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import env, telemetry
from .exceptions import NotInitializedError


@dataclasses.dataclass
class _State:
    initialized: bool = False
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    device: Optional[torch.device] = None
    owns_group: bool = False
    store_dir: Optional[str] = None
    engine: Optional[object] = None
    mode: str = "mesh"
    exporters: list = dataclasses.field(default_factory=list)
    failed: bool = False
    # The device of this process's first init: a later init() without one
    # (the elastic loop's, after a reset) takes it again.
    home_device: Optional[torch.device] = None
    scope_inits: Dict[str, int] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


_state = _State()


def _env_int(names, default: int) -> int:
    for name in names:
        val = os.environ.get(name)
        if val is not None and val != "":
            return int(val)
    return default


def init(device=None, init_method: Optional[str] = None) -> None:
    """Join (or, for a world of one, create) the process group
    (ref: horovod/common/basics.py:33-65)."""
    with _state.lock:
        if _state.initialized:
            return
        rank = _env_int(("HOROVOD_RANK", "RANK"), 0)
        size = _env_int(("HOROVOD_SIZE", "WORLD_SIZE"), 1)
        local_rank = _env_int(("HOROVOD_LOCAL_RANK", "LOCAL_RANK"), rank)
        local_size = _env_int(("HOROVOD_LOCAL_SIZE", "LOCAL_WORLD_SIZE"), size)
        cross_size = _env_int(("HOROVOD_CROSS_SIZE",), max(1, size // local_size))
        cross_rank = _env_int(("HOROVOD_CROSS_RANK",), rank // local_size)
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a world of {size}")
        env.check_unported_knobs()
        from . import fault_injection

        fault_injection.get_injector()      # an unported rule raises here

        card = _env_int((env.SPAWN_LOCAL_RANK,), local_rank)
        if device is None and _state.home_device is not None:
            device = _state.home_device
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init(): CUDA is not available; pass "
                    "device='cpu' to run on the CPU with gloo")
            device = torch.device("cuda", card)
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", card)
            torch.cuda.set_device(device)
            backend = "nccl"
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        elif device.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"unsupported device {device}")

        store_dir = None
        owns = not dist.is_initialized()
        if owns:
            method = init_method or os.environ.get("HOROVOD_INIT_METHOD")
            if method is None and os.environ.get(env.STORE_PORT):
                dist.init_process_group(backend, store=_launcher_store(), rank=rank,
                                        world_size=size)
            else:
                if method is None and os.environ.get("MASTER_ADDR"):
                    method = "env://"
                if method is None:
                    if size != 1:
                        raise ValueError(
                            f"a world of {size} needs a rendezvous: pass init_method, "
                            "set HOROVOD_INIT_METHOD / MASTER_ADDR, or start it "
                            "with the launcher (horovod_tpu_torch.runner.launch)")
                    store_dir = tempfile.mkdtemp(prefix="hvd_torch_store_")
                    method = f"file://{os.path.join(store_dir, 'store')}"
                dist.init_process_group(backend, init_method=method, rank=rank,
                                        world_size=size)
        elif (dist.get_rank(), dist.get_world_size()) != (rank, size):
            raise ValueError(
                f"an existing process group is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the environment says {rank} of {size}")

        _state.rank, _state.size = rank, size
        _state.local_rank, _state.local_size = local_rank, local_size
        _state.cross_rank, _state.cross_size = cross_rank, cross_size
        _state.device = device
        _state.owns_group = owns
        _state.store_dir = store_dir
        _state.failed = False
        _state.mode = "process" if os.environ.get(env.RANK) is not None else "mesh"
        _state.engine = _start_engine(rank, size, device, backend)
        if _state.mode == "process":
            _state.engine.start_exporters()
        else:
            from . import metrics_export

            _state.exporters = metrics_export.start_exporters_from_env(
                status_fn=lambda: {"rank": _state.rank, "size": _state.size,
                                   "mode": _state.mode},
                rank=rank)
        _state.home_device = _state.home_device or device
        _state.initialized = True
        # The baseline for "the world shrank", on every init (an elastic
        # re-init too), and the build identity of every scrape.
        telemetry.gauge("horovod_world_size", "World size after the last (re)init").set(size)
        telemetry.register_build_info()
    # A launched worker takes the preemption signal as a notice (as the
    # JAX package's init does): an intentional stop (the launcher's
    # teardown, a platform's notice) exits 0 instead of dying on the
    # signal; the elastic run loop turns it into a drain at a commit.
    if os.environ.get(env.RANK) is not None or os.environ.get(env.ELASTIC) is not None:
        from . import drain

        drain.coordinator.install()


def _launcher_store():
    """The launcher's store, under this world's prefix."""
    scope = os.environ.get(env.MESH_SCOPE) or "hvd_mesh"
    n = _state.scope_inits.get(scope, 0)
    _state.scope_inits[scope] = n + 1
    store = dist.TCPStore(os.environ.get(env.RENDEZVOUS_ADDR) or "127.0.0.1",
                          int(os.environ[env.STORE_PORT]), None, False,
                          timeout=timedelta(seconds=env.elastic_reset_timeout()))
    return dist.PrefixStore(f"{scope}/{n}", store)


_abort_lock = threading.Lock()


def _abort_groups() -> None:
    """Abort every process group of this world (the default one, the
    engine's, the mesh's), once. Runs on any thread and takes no lock of
    ``_state``: the engine calls it from its own threads while
    ``shutdown`` may hold that lock and wait for them."""
    from torch.distributed import distributed_c10d as c10d

    with _abort_lock:
        if _state.failed:
            return
        _state.failed = True
        for pg in list(getattr(c10d._world, "pg_map", {})):
            try:
                if hasattr(pg, "abort"):
                    pg.abort()
                else:  # pragma: no cover - an older torch
                    c10d._abort_process_group(pg)
            except Exception:  # pragma: no cover - best effort, group may be gone
                pass


def note_failure() -> None:
    """A direct collective failed: abort the world's groups now, so the
    engine and every peer see the failure too."""
    if _state.initialized:
        _abort_groups()


def _start_engine(rank: int, size: int, device: torch.device, backend: str):
    from ..engine.engine import Engine
    from ..engine.transport import GlooTransport

    channels = env.num_channels()
    transport, groups = None, [None] * channels
    if size > 1:
        transport = GlooTransport(dist.new_group(backend="gloo"), rank, size)
        groups = [dist.new_group(backend=backend) for _ in range(channels)]
        if backend == "nccl":
            for g in groups:
                dist.all_reduce(torch.zeros(1, device=device), group=g)
            torch.cuda.synchronize(device)
    engine = Engine(rank, size, device, transport, groups,
                    on_fatal=_abort_groups if size > 1 else None)
    engine.start()
    return engine


def shutdown() -> None:
    """(ref: horovod/common/basics.py:74-80)"""
    with _state.lock:
        if not _state.initialized:
            return
        if _state.engine is not None:
            _state.engine.shutdown()
            _state.engine = None
        for exp in _state.exporters:
            try:
                exp.stop()
            except Exception:  # pragma: no cover - exporter already dead
                pass
        _state.exporters = []
        if _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        if _state.failed:
            # Free the failed world's groups now (exceptions and frames hold
            # them in cycles): their sockets close, and peers blocked on
            # this rank fail too.
            import gc

            gc.collect()
        _state.failed = False
        if _state.store_dir is not None:
            shutil.rmtree(_state.store_dir, ignore_errors=True)
        _state.initialized = False
        _state.owns_group = False
        from ..parallel import mesh   # its groups die with the process group

        mesh._current = None
        _state.store_dir = None
        _state.device = None
    from ..backend.elastic_env import notification_manager

    notification_manager.shutdown()


# As the JAX package does: a script that never calls shutdown() still stops
# its engine and process groups before the interpreter tears threads down.
atexit.register(shutdown)


def is_initialized() -> bool:
    return _state.initialized


def engine():
    """The eager engine the world collectives go through."""
    _require_init()
    return _state.engine


def mode() -> str:
    """"process" in a launched worker (HOROVOD_RANK set), else "mesh"."""
    _require_init()
    return _state.mode


def metrics() -> dict:
    """Snapshot of the telemetry registry (the JAX package's
    ``hvd.metrics()``): ``{"rank", "size", "mode", "metrics", "status"?,
    "fleet"?}``. ``metrics`` is the flat name -> value dict (histograms as
    {count, sum, bounds, counts}); in process mode ``status`` is the
    engine's live state and, on rank 0, ``fleet`` the cross-rank per-rank,
    min, max and sum view. Usable before init too: module-level counters
    (retries, faults) exist regardless."""
    eng = _state.engine if _state.initialized else None
    reg = eng.registry if eng is not None else telemetry.default_registry()
    out = {"rank": _state.rank, "size": _state.size, "mode": _state.mode,
           "metrics": reg.snapshot()}
    if eng is not None and _state.mode == "process":
        status = eng.status()
        # One fleet snapshot, at the top level.
        fleet = status.pop("fleet", None)
        out["status"] = status
        if fleet is not None:
            out["fleet"] = fleet
    return out


def _require_init():
    if not _state.initialized:
        raise NotInitializedError()


def rank() -> int:
    _require_init()
    return _state.rank


def size() -> int:
    _require_init()
    return _state.size


def local_rank() -> int:
    _require_init()
    return _state.local_rank


def local_size() -> int:
    _require_init()
    return _state.local_size


def cross_rank() -> int:
    _require_init()
    return _state.cross_rank


def cross_size() -> int:
    _require_init()
    return _state.cross_size


def device() -> torch.device:
    """The device this rank computes and communicates on."""
    _require_init()
    return _state.device


def is_homogeneous() -> bool:
    """Whether every host runs the same number of ranks
    (ref: mpi_controller.cc:26-82 homogeneity check)."""
    _require_init()
    return _state.size % _state.cross_size == 0


# What this build of the port can run on (ref: horovod/common/basics.py:
# 174-208 mpi_built/nccl_built...); the JAX package's names, the port's
# own answers.
def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def cuda_built() -> bool:
    return torch.version.cuda is not None


def mpi_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def tcp_built() -> bool:
    return False
