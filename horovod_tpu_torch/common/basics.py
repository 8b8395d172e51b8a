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
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
from typing import Optional

import torch
import torch.distributed as dist

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

        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init(): CUDA is not available; pass "
                    "device='cpu' to run on the CPU with gloo")
            device = torch.device("cuda", local_rank)
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
            backend = "nccl"
        elif device.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"unsupported device {device}")

        store_dir = None
        owns = not dist.is_initialized()
        if owns:
            method = init_method or os.environ.get("HOROVOD_INIT_METHOD")
            if method is None and os.environ.get("MASTER_ADDR"):
                method = "env://"
            if method is None:
                if size != 1:
                    raise ValueError(
                        f"a world of {size} needs a rendezvous: pass "
                        "init_method or set HOROVOD_INIT_METHOD / MASTER_ADDR")
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
        _state.initialized = True


def shutdown() -> None:
    """(ref: horovod/common/basics.py:74-80)"""
    with _state.lock:
        if not _state.initialized:
            return
        if _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        if _state.store_dir is not None:
            shutil.rmtree(_state.store_dir, ignore_errors=True)
        _state.initialized = False
        _state.owns_group = False
        _state.store_dir = None
        _state.device = None


def is_initialized() -> bool:
    return _state.initialized


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
