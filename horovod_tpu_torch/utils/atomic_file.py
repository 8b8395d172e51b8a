"""Crash-safe atomic file writes (counterpart of
``horovod_tpu/utils/atomic_file.py``).

A write fills ``<path>.tmp.<pid>.<mono_ns>`` and renames it over
``path``: a reader never sees a partial file, and a crash leaves only a
recognizable ``*.tmp.*`` orphan. On any failure the tmp file is unlinked
and the destination is untouched. With ``fsync=True`` the data reaches
stable storage before the rename, and the directory entry after it, so a
committed checkpoint survives power loss and not only the death of the
process.

Every write and checked read first asks the fault injector's disk hooks
(``diskfail``, ``diskslow``, ``common/fault_injection.py``): an injected
failure is an ``OSError``, what a real disk error raises, so callers run
their real error paths.
"""
from __future__ import annotations

import os
import time
from typing import Callable

TMP_MARKER = ".tmp."


def tmp_path_for(path: str) -> str:
    """The tmp name a write of ``path`` uses: unique per process and call,
    so concurrent writers never collide and an orphan never blocks a
    retry."""
    return f"{path}{TMP_MARKER}{os.getpid()}.{time.monotonic_ns()}"


def is_tmp_debris(name: str) -> bool:
    """Whether a file name is the orphan of an interrupted write."""
    return TMP_MARKER in name


def _fsync_dir(dirpath: str):
    """Force the directory entry (the rename) to stable storage. Best
    effort: some filesystems refuse fsync on a directory."""
    try:
        fd = os.open(dirpath or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _check_disk(op: str, path: str):
    from ..common.fault_injection import get_injector

    inj = get_injector()
    if inj.active:
        inj.check_disk(op, path)


def atomic_write(path: str, fill: Callable, mode: str = "wb",
                 make_dirs: bool = True, fsync: bool = False) -> str:
    """Write ``path`` atomically: ``fill(f)`` fills a tmp file, which is
    then renamed over ``path``. Returns ``path``."""
    _check_disk("write", path)
    if make_dirs:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    tmp = tmp_path_for(path)
    try:
        with open(tmp, mode) as f:
            fill(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(os.path.dirname(path))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_bytes(path: str, data: bytes, make_dirs: bool = True,
                       fsync: bool = False) -> str:
    return atomic_write(path, lambda f: f.write(data), mode="wb",
                        make_dirs=make_dirs, fsync=fsync)


def atomic_write_text(path: str, text: str, make_dirs: bool = True,
                      fsync: bool = False) -> str:
    return atomic_write(path, lambda f: f.write(text), mode="w",
                        make_dirs=make_dirs, fsync=fsync)


def checked_read_bytes(path: str) -> bytes:
    """Read a whole file through the disk fault hooks."""
    _check_disk("read", path)
    with open(path, "rb") as f:
        return f.read()
