"""The durability plane: sharded asynchronous checkpoints that survive the
death of the whole job (counterpart of ``horovod_tpu/common/checkpoint.py``,
in its file format: ``FORMAT_VERSION`` 1, the same manifest keys, a
pickled shard of numpy leaves, CRC32; each package reads the other's
checkpoints).

Every ``HOROVOD_CHECKPOINT_INTERVAL_STEPS`` commits, ``state.commit()``
hands the committed snapshot (``State.checkpoint_objects`` and
``checkpoint_trees``; ``save()`` rebinds the snapshot and never mutates
it) to this rank's writer thread, which:

* cuts the flat leaf list into one contiguous range a rank, balanced by
  bytes (``shard_ranges``: every rank computes the same cut);
* copies its range to the host, on a stream of its own after the commit's
  copies (``TorchState`` commits on the card: the copy to the host runs
  here, off the training thread), and lets go of every device leaf once
  it is on the host;
* pickles the range straight into its file, its CRC32 taken on the way
  (the bytes of ``pickle.dumps``, without a copy of the shard in memory),
  lands it crash-safe (``utils/atomic_file.py``: tmp, rename, fsync), then
  a ``.meta.json`` sidecar, and acks over the rendezvous KV
  (``ckpt_ack_s<step>``; the sidecar is the fallback).

A snapshot that finds the previous write still in flight is skipped and
counted. The coordinator (rank 0) two-phase-commits: once every rank of
the writing world has acked a shard that is on disk at the acked size, it
writes ``manifest-<step>.json`` atomically and publishes ``ckpt/latest``;
a manifest never names a missing shard. It then keeps the newest
``HOROVOD_CHECKPOINT_KEEP`` complete checkpoints (manifest first, then the
shards) and sweeps orphan shard directories and tmp debris.

Restore walks the manifests newest first and takes the first complete one
whose shards read back with their CRCs; every rank reads every shard and
rebuilds the state against the live structure, so a job restarted at
another world size restores the same bytes. Debris above the restore
point goes with its acks, which a later commit at the same step would
otherwise take for its own.

A numpy leaf is written as it is; a torch tensor as a numpy array, one of
a dtype numpy lacks (bfloat16, the float8 types) as the unsigned integer
of its width holding its bits (``host_leaf``); the state that loads it
knows its dtype (``TorchState.load_checkpoint``), so it round-trips
bitwise. Writes, bytes, failures, skips, commits and restores, the write
and commit seconds and the last committed step are the JAX module's
telemetry series (``horovod_checkpoint_*``); ``status()`` reads the same
counters, since this manager was made. The tracing, goodput and events
hooks of the JAX module wait for ROADMAP A8.2 and A8.4.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import atomic_file
from ..utils.logging import get_logger
from . import env as env_cfg
from . import telemetry

logger = get_logger()

FORMAT_VERSION = 1
MANIFEST_PREFIX = "manifest-"
STEP_DIR_PREFIX = "ckpt-"
ACK_SCOPE_PREFIX = "ckpt_ack_s"
LATEST_SCOPE = "ckpt"
LATEST_KEY = "latest"
RESUME_KEY = "resume"


# ---------------------------------------------------------------------------
# Layout and manifest discovery (no manager needed: the driver announces
# the resume point, the smoke harness checks a restore against them).

def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{STEP_DIR_PREFIX}{step:010d}")


def shard_file(step: int, rank: int) -> str:
    """Manifest-relative shard path."""
    return f"{STEP_DIR_PREFIX}{step:010d}/shard-{rank:05d}.pkl"


def manifest_path(root: str, step: int) -> str:
    return os.path.join(root, f"{MANIFEST_PREFIX}{step:010d}.json")


def list_manifests(root: str) -> List[Tuple[int, str]]:
    """(step, path) of every manifest, oldest first."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    for n in names:
        if not (n.startswith(MANIFEST_PREFIX) and n.endswith(".json")):
            continue
        if atomic_file.is_tmp_debris(n):
            continue
        try:
            out.append((int(n[len(MANIFEST_PREFIX):-len(".json")]), os.path.join(root, n)))
        except ValueError:
            continue
    out.sort()
    return out


def load_manifest(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_complete(root: str, manifest: dict) -> bool:
    """Every shard the manifest names exists at the recorded size."""
    for sh in manifest.get("shards", []):
        try:
            if os.path.getsize(os.path.join(root, sh["file"])) != sh["bytes"]:
                return False
        except OSError:
            return False
    return True


def find_latest_manifest(root: str) -> Optional[Tuple[int, dict, str]]:
    """The newest complete checkpoint: (step, manifest, manifest path)."""
    for step, path in reversed(list_manifests(root)):
        man = load_manifest(path)
        if man is None or man.get("format") != FORMAT_VERSION:
            continue
        if is_complete(root, man):
            return step, man, path
    return None


def load_checkpoint_arrays(root: str, manifest: dict, verify: bool = True
                           ) -> Tuple[dict, Dict[str, list]]:
    """Every shard of a manifest, CRC-checked (unless ``verify=False``),
    reassembled into ``(objects, {attr: leaves})``: the whole state,
    whatever world wrote it. The shard ranges must tile the leaf count."""
    shards = sorted(manifest["shards"], key=lambda s: s["leaves"][0])
    leaves: List = []
    objects: dict = {}
    cursor = 0
    for sh in shards:
        payload = atomic_file.checked_read_bytes(os.path.join(root, sh["file"]))
        if verify and zlib.crc32(payload) != sh["crc32"]:
            raise ValueError(f"checkpoint shard {sh['file']} failed CRC verification")
        doc = pickle.loads(payload)
        lo, hi = doc["leaf_range"]
        if lo != cursor:
            raise ValueError(f"checkpoint shard ranges do not tile: expected leaf "
                             f"{cursor}, shard {sh['file']} starts at {lo}")
        cursor = hi
        leaves.extend(doc["leaves"])
        if doc.get("objects") is not None:
            objects = doc["objects"]
    if cursor != manifest["num_leaves"]:
        raise ValueError(f"checkpoint covers {cursor} leaves, manifest says "
                         f"{manifest['num_leaves']}")
    trees: Dict[str, list] = {}
    i = 0
    for attr in manifest["attrs"]:
        n = manifest["attr_counts"][attr]
        trees[attr] = leaves[i:i + n]
        i += n
    return objects, trees


def _sweep_debris(root: str, keep) -> None:
    """Root-level ``*.tmp.*`` debris always goes; a ``ckpt-<step>``
    directory goes unless ``keep(step)``."""
    try:
        names = os.listdir(root)
    except OSError:
        return
    for name in names:
        full = os.path.join(root, name)
        if atomic_file.is_tmp_debris(name) and os.path.isfile(full):
            try:
                os.unlink(full)
            except OSError:
                pass
            continue
        if not (name.startswith(STEP_DIR_PREFIX) and os.path.isdir(full)):
            continue
        try:
            s = int(name[len(STEP_DIR_PREFIX):])
        except ValueError:
            continue
        if not keep(s):
            shutil.rmtree(full, ignore_errors=True)


def purge_newer_than(root: str, step: Optional[int]):
    """Disarm attempts newer than ``step`` (all when None), once a restore
    point is chosen: a shard directory above it without a manifest goes
    whole, and one with a manifest sheds its ``.meta.json`` acks, which a
    re-run reaching the same step would otherwise take for its own. A
    directory with a manifest is kept whatever the floor: a checkpoint
    committed concurrently is real. Every rank calls this with the same
    floor, so concurrent sweeps agree."""
    floor = -1 if step is None else step
    manifested = {s for s, _ in list_manifests(root)}
    _sweep_debris(root, keep=lambda s: s <= floor or s in manifested)
    for s in manifested:
        if s <= floor:
            continue
        d = step_dir(root, s)
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            if name.endswith(".meta.json"):
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    pass


def shard_ranges(leaf_bytes: List[int], nshards: int) -> List[Tuple[int, int]]:
    """Cut ``len(leaf_bytes)`` leaves into ``nshards`` contiguous ranges
    balanced by bytes; deterministic, so no cut travels. A range may be
    empty (more ranks than leaves): its shard is still written and acked,
    so the commit barrier stays the same on every rank."""
    total = sum(leaf_bytes)
    n = len(leaf_bytes)
    cuts = [0]
    acc = 0
    idx = 0
    for k in range(1, nshards):
        boundary = total * k / nshards
        while idx < n and acc + leaf_bytes[idx] <= boundary:
            acc += leaf_bytes[idx]
            idx += 1
        cuts.append(idx)
    cuts.append(n)
    return [(cuts[i], cuts[i + 1]) for i in range(nshards)]


# dtype -> (torch integer view, numpy type of its bits) for the dtypes
# numpy lacks.
_BIT_VIEWS = {torch.bfloat16: (torch.int16, np.uint16)}
for _name in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz"):
    if hasattr(torch, _name):
        _BIT_VIEWS[getattr(torch, _name)] = (torch.int8, np.uint8)


def host_leaf(x):
    """A leaf as a shard holds it: a numpy array. A tensor of a dtype
    numpy lacks becomes the unsigned integers of its bits."""
    if not isinstance(x, torch.Tensor):
        return x
    t = x.detach()
    view = _BIT_VIEWS.get(t.dtype)
    if view is not None:
        return t.view(view[0]).cpu().numpy().view(view[1])
    return t.cpu().numpy()


def leaf_to_tensor(leaf, like: torch.Tensor) -> torch.Tensor:
    """A shard's leaf as a tensor of ``like``'s dtype and shape on the
    CPU, bit for bit; raises if it cannot be."""
    arr = np.array(leaf, copy=True, order="C")     # keeps a 0-d leaf 0-d
    view = _BIT_VIEWS.get(like.dtype)
    if view is not None:
        if arr.dtype != view[1]:
            raise ValueError(f"checkpoint leaf of dtype {arr.dtype} cannot hold {like.dtype}")
        signed = np.int16 if view[0] == torch.int16 else np.int8
        t = torch.from_numpy(arr.view(signed)).view(like.dtype)
    else:
        t = torch.from_numpy(arr)
        if t.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf of dtype {arr.dtype} where the live state "
                             f"holds {like.dtype}")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} where the live "
                         f"state holds {tuple(like.shape)}")
    return t


def _cuda_device(leaves: list) -> Optional[torch.device]:
    return next((x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda),
                None)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return getattr(x, "nbytes", 64)


# ---------------------------------------------------------------------------
# Snapshot: what one checkpoint write carries.

class _Snapshot:
    __slots__ = ("step", "rank", "size", "objects", "attrs", "attr_counts", "leaves",
                 "num_leaves", "leaf_bytes", "ready", "done")

    def __init__(self, step: int, rank: int, size: int, objects: dict,
                 trees: Dict[str, list]):
        self.step = step
        self.rank = rank
        self.size = size
        self.objects = objects
        # One attr order on every rank: the manifest's leaf layout.
        self.attrs = sorted(trees)
        self.attr_counts = {a: len(trees[a]) for a in self.attrs}
        self.leaves = [leaf for a in self.attrs for leaf in trees[a]]
        self.num_leaves = len(self.leaves)
        self.leaf_bytes = [_nbytes(x) for x in self.leaves]
        # Device leaves are read on the writer's stream after this event,
        # recorded on the training thread's stream behind the commit.
        self.ready = None
        dev = _cuda_device(self.leaves)
        if dev is not None:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(dev))
        self.done = threading.Event()


def _to_host(leaves: list, ready) -> list:
    """The leaves on the host; device ones copied on a stream of the
    writer's own after ``ready``, so the training stream is not held."""
    dev = _cuda_device(leaves)
    if ready is None or dev is None:
        return [host_leaf(x) for x in leaves]
    stream = torch.cuda.Stream(dev)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        out = [host_leaf(x) for x in leaves]
    stream.synchronize()
    return out


class _CrcWriter:
    """Pickles a shard straight into its file, counting its bytes and
    their CRC32 on the way: the bytes are ``pickle.dumps``'s, with no copy
    of the whole shard in memory and little time under the GIL (the
    arrays' buffers go to ``write`` as they are, and ``zlib.crc32`` and
    the file's write release the GIL)."""

    def __init__(self):
        self.crc = 0
        self.nbytes = 0
        self._f = None

    def dump(self, doc: dict, f):
        self._f = f
        pickle.dump(doc, self, protocol=pickle.HIGHEST_PROTOCOL)
        self._f = None

    def write(self, b) -> int:
        mv = memoryview(b).cast("B")
        self.crc = zlib.crc32(mv, self.crc)
        self.nbytes += mv.nbytes
        self._f.write(mv)
        return mv.nbytes


# ---------------------------------------------------------------------------
# The manager

class CheckpointManager:
    """A rank's durability agent: snapshot at commit, this rank's shard
    written in the background, the manifest committed by the coordinator,
    GC, restore. One a rank; all share ``directory``."""

    def __init__(self, directory: str, rank: int = 0, size: int = 1,
                 interval_steps: Optional[int] = None, keep: Optional[int] = None,
                 commit_timeout: Optional[float] = None, rendezvous=None,
                 fsync: Optional[bool] = None, registry=None):
        self.directory = os.path.abspath(directory)
        self.rank = rank
        self.size = size
        self.interval_steps = (env_cfg.checkpoint_interval_steps()
                               if interval_steps is None else interval_steps)
        self.keep = env_cfg.checkpoint_keep() if keep is None else max(keep, 1)
        self.commit_timeout = (env_cfg.checkpoint_commit_timeout()
                               if commit_timeout is None else commit_timeout)
        self.fsync = env_cfg.checkpoint_fsync() if fsync is None else fsync
        self.rendezvous = rendezvous
        if registry is None:
            registry = telemetry.default_registry()
        self._m_writes = registry.counter(
            "horovod_checkpoint_writes_total",
            "Checkpoint shards durably written by this rank")
        self._m_bytes = registry.counter(
            "horovod_checkpoint_bytes_total",
            "Serialized checkpoint shard bytes written by this rank")
        self._m_failures = registry.counter(
            "horovod_checkpoint_failures_total",
            "Checkpoint shard writes or manifest commits that failed "
            "(a failed checkpoint is skipped — training never blocks, "
            "and no manifest ever references a missing shard)")
        self._m_skipped = registry.counter(
            "horovod_checkpoint_skipped_total",
            "Checkpoint snapshots skipped because the previous shard "
            "write was still in flight (writer backpressure)")
        self._m_commits = registry.counter(
            "horovod_checkpoint_commits_total",
            "Manifests two-phase-committed by the coordinator")
        self._m_restores = registry.counter(
            "horovod_checkpoint_restores_total",
            "States restored from a committed checkpoint")
        self._m_write_s = registry.histogram(
            "horovod_checkpoint_write_seconds",
            "Background shard serialize+write+ack latency")
        self._m_commit_s = registry.histogram(
            "horovod_checkpoint_commit_seconds",
            "Coordinator ack-collection + manifest commit latency")
        self._m_last_step = registry.gauge(
            "horovod_checkpoint_last_step",
            "Step of the last successfully committed checkpoint")
        self._counted = {"writes": self._m_writes, "bytes": self._m_bytes,
                         "failures": self._m_failures, "skipped": self._m_skipped,
                         "commits": self._m_commits, "restores": self._m_restores}
        self._counts_base = {k: m.value for k, m in self._counted.items()}
        # The last write's and commit's seconds (status()).
        self.last_write_s: Optional[float] = None
        self.last_commit_s: Optional[float] = None
        self._commit_count = 0
        self._last_committed_step: Optional[int] = None
        self._last_write_step: Optional[int] = None
        self._last_error: Optional[str] = None
        self._pending: Optional[_Snapshot] = None
        self._cancel_commit = threading.Event()
        self._deferred_purge_floor: Optional[int] = None
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.directory, exist_ok=True)

    @property
    def counts(self) -> Dict[str, int]:
        """Writes, bytes, failures, skips, commits and restores since this
        manager was made (its counters count on across managers)."""
        return {k: int(m.value - self._counts_base[k]) for k, m in self._counted.items()}

    # -- plumbing ------------------------------------------------------
    def _world(self) -> Tuple[int, int]:
        """(rank, size) of the live world, so shards are cut anew after an
        elastic reset."""
        from . import basics

        if basics.is_initialized():
            return basics.rank(), basics.size()
        return self.rank, self.size

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._writer_loop,
                                            name="hvd-ckpt-writer", daemon=True)
            self._thread.start()

    # -- the commit path -----------------------------------------------
    def maybe_save(self, state) -> bool:
        """Once a ``state.commit()``: a checkpoint every ``interval_steps``
        commits; whether one was handed to the writer. Never waits for
        I/O."""
        self._commit_count += 1
        if self.interval_steps <= 0:
            return False
        if self._commit_count % self.interval_steps != 0:
            return False
        return self.save(state, step=self._commit_count)

    def save(self, state, step: Optional[int] = None, blocking: bool = False,
             timeout: float = 300.0) -> bool:
        """Hand ``state``'s last commit to the writer; skipped (False) while
        the previous write is in flight. ``blocking=True`` waits until the
        shard is durable and, on the coordinator, the manifest committed."""
        if step is None:
            step = self._commit_count
        rank, size = self._world()
        snap = _Snapshot(step, rank, size, state.checkpoint_objects(),
                         state.checkpoint_trees())
        with self._cond:
            if self._pending is not None:
                self._m_skipped.inc()
                logger.warning("checkpoint at step %d skipped: previous shard write "
                               "still in flight", step)
                return False
            self._pending = snap
            self._ensure_thread()
            self._cond.notify_all()
        if blocking and not snap.done.wait(timeout):
            raise TimeoutError(f"checkpoint write at step {step} did not finish in "
                               f"{timeout:.0f}s")
        return True

    def save_now(self, state, timeout: float = 60.0) -> bool:
        """Make the current commit durable before the process exits (the
        drain, ``common/drain.py``): if this commit's interval checkpoint
        just went out, wait for it; else drain the writer and write this
        commit, blocking. Called at the same commit on every rank, so the
        coordinator's ack barrier fills."""
        deadline = time.monotonic() + max(timeout, 1.0)

        def left() -> float:
            return max(0.5, deadline - time.monotonic())

        if (self.interval_steps > 0 and self._commit_count > 0
                and self._commit_count % self.interval_steps == 0):
            return self.flush(timeout=left())
        if not self.flush(timeout=left()):
            return False
        return self.save(state, step=self._commit_count, blocking=True, timeout=left())

    def resync_after_reset(self, flush_timeout: float = 30.0):
        """Re-anchor the commit counter on the newest complete manifest
        after an elastic reset, which every rank reads alike: a worker that
        joined counted from its restore while the survivors counted on,
        and counters that drift make ranks snapshot on different commits
        (the ack barrier never fills). A coordinator waiting on acks of
        the world that is gone gives up now."""
        self._cancel_commit.set()
        try:
            drained = self.flush(timeout=flush_timeout)
        finally:
            self._cancel_commit.clear()
        found = find_latest_manifest(self.directory)
        anchor = found[0] if found is not None else 0
        if drained:
            purge_newer_than(self.directory, anchor)
        else:
            # The writer still writes: it sweeps once its write lands.
            logger.warning("checkpoint writer still busy after %.0fs at reset; "
                           "deferring the debris sweep until its write lands",
                           flush_timeout)
            with self._cond:
                self._deferred_purge_floor = anchor
        self._commit_count = anchor

    def flush(self, timeout: float = 300.0) -> bool:
        """Wait for the write in flight; False if still busy at the bound."""
        with self._cond:
            snap = self._pending
        if snap is not None:
            return snap.done.wait(timeout)
        return True

    def stop(self, timeout: float = 30.0):
        """Stop the writer once its write in flight is done."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    # -- the writer thread ---------------------------------------------
    def _writer_loop(self):
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                snap = self._pending
                if snap is None:
                    return
            try:
                self._write_shard(snap)
            except Exception:
                # Checkpointing never kills training: counted, and the next
                # interval tries again.
                self._m_failures.inc()
                logger.exception("checkpoint write at step %d failed", snap.step)
            finally:
                snap.leaves = None
                with self._cond:
                    self._pending = None
                    deferred = self._deferred_purge_floor
                    self._deferred_purge_floor = None
                    self._cond.notify_all()
                if deferred is not None:
                    try:
                        purge_newer_than(self.directory, deferred)
                    except OSError:  # pragma: no cover - best effort
                        pass
                snap.done.set()
            if self._stop:
                return

    def _write_shard(self, snap: _Snapshot):
        t0 = time.perf_counter()
        lo, hi = shard_ranges(snap.leaf_bytes, snap.size)[snap.rank]
        mine = snap.leaves[lo:hi]
        # The other ranks' leaves are theirs to write: let go of them, and
        # of this range's device tensors once they are on the host.
        snap.leaves = None
        leaves = _to_host(mine, snap.ready)
        del mine
        rel = shard_file(snap.step, snap.rank)
        path = os.path.join(self.directory, rel)
        doc = {
            "format": FORMAT_VERSION,
            "step": snap.step,
            "rank": snap.rank,
            "world_size": snap.size,
            "leaf_range": (lo, hi),
            "leaves": leaves,
            # Scalars ride rank 0's shard: one copy.
            "objects": snap.objects if snap.rank == 0 else None,
            "attrs": snap.attrs,
            "attr_counts": snap.attr_counts,
        }
        try:
            out = _CrcWriter()
            atomic_file.atomic_write(path, lambda f: out.dump(doc, f), fsync=self.fsync)
            del doc, leaves
            meta = {
                "format": FORMAT_VERSION,
                "step": snap.step,
                "rank": snap.rank,
                "world_size": snap.size,
                "file": rel,
                "leaves": [lo, hi],
                "bytes": out.nbytes,
                "crc32": out.crc,
            }
            # The ack, twice: the sidecar (the filesystem is shared, and
            # restore reads it) and the rendezvous KV where there is one.
            atomic_file.atomic_write_text(f"{path}.meta.json", json.dumps(meta),
                                          fsync=self.fsync)
            if self.rendezvous is not None:
                try:
                    self.rendezvous.put(f"{ACK_SCOPE_PREFIX}{snap.step}", str(snap.rank),
                                        json.dumps(meta).encode())
                except Exception as e:  # the KV down is not the shard lost
                    logger.warning("checkpoint ack via KV failed (%s); the coordinator "
                                   "falls back to the sidecar", e)
        except OSError as e:
            self._m_failures.inc()
            self._last_error = f"step {snap.step}: {e}"
            logger.error("checkpoint shard write at step %d failed: %s; no ack sent, "
                         "the coordinator will not commit this checkpoint", snap.step, e)
            return
        self._m_writes.inc()
        self._m_bytes.inc(out.nbytes)
        self.last_write_s = time.perf_counter() - t0
        self._m_write_s.observe(self.last_write_s)
        self._last_write_step = snap.step
        if snap.rank == 0:
            self._commit(snap)

    # -- the coordinator's two-phase commit ----------------------------
    def _ack_backed_by_shard(self, meta: dict) -> bool:
        """An ack counts only if its shard is on disk at the acked size: a
        stale KV ack of an earlier attempt at this step must not fill the
        barrier."""
        try:
            return os.path.getsize(os.path.join(self.directory, meta["file"])) \
                == meta["bytes"]
        except (OSError, KeyError, TypeError):
            return False

    def _cleanup_attempt(self, step: int):
        """An abandoned attempt's shards and acks go, so none of it fills a
        later attempt at the same step."""
        shutil.rmtree(step_dir(self.directory, step), ignore_errors=True)
        if self.rendezvous is not None:
            try:
                self.rendezvous.delete(f"{ACK_SCOPE_PREFIX}{step}")
            except Exception:
                pass

    def _read_ack(self, step: int, rank: int) -> Optional[dict]:
        if self.rendezvous is not None:
            try:
                raw = self.rendezvous.get(f"{ACK_SCOPE_PREFIX}{step}", str(rank))
                if raw:
                    return json.loads(raw.decode())
            except Exception:
                pass  # the sidecar
        p = os.path.join(self.directory, f"{shard_file(step, rank)}.meta.json")
        try:
            with open(p) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _commit(self, snap: _Snapshot):
        t0 = time.perf_counter()
        deadline = time.monotonic() + self.commit_timeout
        acks: Dict[int, dict] = {}
        missing = set(range(snap.size))
        while missing:
            for r in sorted(missing):
                meta = self._read_ack(snap.step, r)
                if (meta is not None and meta.get("step") == snap.step
                        and self._ack_backed_by_shard(meta)):
                    acks[r] = meta
            missing -= set(acks)
            if not missing:
                break
            # A reset moved on while this write was in flight: its world
            # is gone and will never ack.
            cancelled = (self._cancel_commit.is_set()
                         or self._deferred_purge_floor is not None)
            if cancelled or time.monotonic() > deadline:
                reason = ("cancelled by elastic reset" if cancelled else
                          f"no durability ack from ranks {sorted(missing)} within "
                          f"{self.commit_timeout:.0f}s")
                self._m_failures.inc()
                self._last_error = f"step {snap.step}: {reason}"
                logger.error("checkpoint commit at step %d abandoned: %s; the previous "
                             "committed checkpoint remains the restore point",
                             snap.step, reason)
                self._cleanup_attempt(snap.step)
                return
            time.sleep(0.02)
        manifest = {
            "format": FORMAT_VERSION,
            "step": snap.step,
            "time": time.time(),
            "world_size": snap.size,
            "num_leaves": snap.num_leaves,
            "attrs": snap.attrs,
            "attr_counts": snap.attr_counts,
            "objects_shard": 0,
            "shards": [
                {"rank": r, "file": acks[r]["file"], "leaves": acks[r]["leaves"],
                 "bytes": acks[r]["bytes"], "crc32": acks[r]["crc32"]}
                for r in range(snap.size)
            ],
        }
        try:
            atomic_file.atomic_write_text(manifest_path(self.directory, snap.step),
                                          json.dumps(manifest, indent=1, sort_keys=True),
                                          fsync=self.fsync)
        except OSError as e:
            self._m_failures.inc()
            self._last_error = f"step {snap.step}: manifest: {e}"
            logger.error("checkpoint manifest commit at step %d failed: %s", snap.step, e)
            self._cleanup_attempt(snap.step)
            return
        # The commit is done once the manifest's rename lands; the KV
        # publish is for operators.
        if self.rendezvous is not None:
            try:
                self.rendezvous.put(LATEST_SCOPE, LATEST_KEY,
                                    json.dumps({"step": snap.step,
                                                "world_size": snap.size}).encode())
            except Exception:
                pass
        self._last_committed_step = snap.step
        self._m_commits.inc()
        self._m_last_step.set(snap.step)
        self.last_commit_s = time.perf_counter() - t0
        self._m_commit_s.observe(self.last_commit_s)
        logger.info("checkpoint committed at step %d (%d shards)", snap.step, snap.size)
        try:
            self._gc()
        except OSError as e:  # pragma: no cover - GC is best effort
            logger.warning("checkpoint GC failed: %s", e)

    def _gc(self):
        """Keep the newest ``keep`` complete checkpoints: older manifests go
        first, then their shards (a crash between leaves an orphan
        directory, never a manifest without its shards); orphan
        directories older than the newest manifest and root tmp debris go
        too."""
        manifests = list_manifests(self.directory)
        if not manifests:
            return
        newest_step = manifests[-1][0]
        kept = {s for s, _ in manifests[-self.keep:]}
        for s, path in manifests[:-self.keep]:
            try:
                os.unlink(path)
            except OSError:
                pass
            shutil.rmtree(step_dir(self.directory, s), ignore_errors=True)
        _sweep_debris(self.directory, keep=lambda s: s in kept or s > newest_step)

    # -- restore -------------------------------------------------------
    def restore_latest(self, state) -> Optional[int]:
        """Load the newest complete, readable checkpoint into ``state``
        (which snapshots it again, so an in-memory ``restore()`` rolls back
        to it); the step, or None. A corrupt shard falls back to the
        checkpoint before. The caller still runs ``state.sync()``."""
        for step, path in reversed(list_manifests(self.directory)):
            man = load_manifest(path)
            if (man is None or man.get("format") != FORMAT_VERSION
                    or not is_complete(self.directory, man)):
                continue
            try:
                objects, trees = load_checkpoint_arrays(self.directory, man)
            except (OSError, ValueError, pickle.UnpicklingError) as e:
                self._m_failures.inc()
                logger.error("checkpoint at step %d unreadable (%s); falling back to the "
                             "previous complete checkpoint", step, e)
                continue
            state.load_checkpoint(objects, trees)
            self._commit_count = step
            self._last_committed_step = step
            self._m_restores.inc()
            self._m_last_step.set(step)
            purge_newer_than(self.directory, step)
            logger.info("restored checkpoint step %d (written at world size %d, restoring "
                        "at world size %d)", step, man["world_size"], self._world()[1])
            return step
        # Nothing restorable: sweep every attempt, so its acks cannot fill
        # the fresh run's barriers.
        purge_newer_than(self.directory, None)
        return None

    def status(self) -> dict:
        with self._cond:
            pending = self._pending.step if self._pending else None
        return {
            "directory": self.directory,
            "interval_steps": self.interval_steps,
            "keep": self.keep,
            "commit_count": self._commit_count,
            "last_committed_step": self._last_committed_step,
            "last_write_step": self._last_write_step,
            "pending_step": pending,
            "last_error": self._last_error,
            "last_write_s": self.last_write_s,
            "last_commit_s": self.last_commit_s,
            **self.counts,
        }


# ---------------------------------------------------------------------------
# The process's current manager (set by the elastic run loop, which owns
# its lifetime).

_current: Optional[CheckpointManager] = None


def set_current(mgr: Optional[CheckpointManager]):
    global _current
    _current = mgr


def current() -> Optional[CheckpointManager]:
    return _current


def manager_from_env(rank: Optional[int] = None,
                     size: Optional[int] = None) -> Optional[CheckpointManager]:
    """The manager the environment asks for, or None without
    ``HOROVOD_CHECKPOINT_DIR``; acks ride the launcher's rendezvous KV
    where there is one."""
    root = env_cfg.checkpoint_dir()
    if not root:
        return None
    if rank is None:
        rank = env_cfg.get_int(env_cfg.RANK, 0)
    if size is None:
        size = env_cfg.get_int(env_cfg.SIZE, 1)
    rdv = None
    addr = env_cfg.get_str(env_cfg.RENDEZVOUS_ADDR)
    port = env_cfg.get_int(env_cfg.RENDEZVOUS_PORT, 0)
    if addr and port:
        from ..backend.rendezvous import RendezvousClient

        rdv = RendezvousClient(addr, port)
    return CheckpointManager(root, rank=rank, size=size, rendezvous=rdv)
