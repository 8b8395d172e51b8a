"""Elastic driver: discovery polling, stable rank reassignment, worker
lifecycle (counterpart of ``horovod_tpu/runner/elastic/driver.py``; ref:
horovod/runner/elastic/driver.py:30-308).

Topology changes are versioned by an **epoch**. Each activation publishes
into the rendezvous KV:

    rank_and_size_e<E>/<host>:<spawn_local_rank> -> "rank,size,..." rows
        (INVALID row = the worker lost its slot and exits;
         ref: gloo_context.cc:157-200 rank==-1 contract)
    meta/epoch -> E        (written last: epoch visible => rows complete)

A resetting worker (``backend/elastic_env.refresh_topology_from_
rendezvous``) announces ``ready_e<E>/<key>``, waits for a newer epoch and
reads its row. The epoch also names the store prefix its process groups
form under (HOROVOD_MESH_SCOPE=hvd_mesh_e<E>), so no key of an earlier
epoch is ever read again. Every reset barrier gets a deadline
(HOROVOD_ELASTIC_READY_TIMEOUT): a slot with no verdict by then is killed
and recorded failed, so survivors never park behind a wedged worker.

The liveness verdicts and recovery metrics wait for ROADMAP A8, the drain
notices and the resume point of durable checkpoints for A7.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ...common import env as env_cfg
from ...utils.logging import get_logger
from ..hosts import HostInfo, SlotInfo, get_host_assignments
from ..rendezvous_server import RendezvousServer
from .discovery import HostManager, HostUpdateResult
from .registration import READY, WorkerStateRegistry

logger = get_logger()

INVALID_ROW = "-1,-1,-1,-1,-1,-1"
READY_PREFIX = "ready_e"


class _WorkerRecord:
    def __init__(self, key: Tuple[str, int], proc):
        self.key = key
        self.proc = proc
        self.thread: Optional[threading.Thread] = None


class ElasticDriver:
    def __init__(self, rendezvous: RendezvousServer, discovery, min_np: int,
                 max_np: Optional[int] = None, reset_limit: Optional[int] = None,
                 poll_interval: Optional[float] = None):
        self.rendezvous = rendezvous
        self.host_manager = HostManager(discovery)
        self.registry = WorkerStateRegistry(self, self.host_manager, reset_limit)
        self.min_np = min_np
        self.max_np = max_np
        self.poll_interval = env_cfg.elastic_discovery_interval() \
            if poll_interval is None else poll_interval
        self.epoch = -1
        self._create_worker: Optional[Callable] = None
        self._workers: Dict[Tuple[str, int], _WorkerRecord] = {}
        self._assignments: Dict[Tuple[str, int], SlotInfo] = {}
        self._lock = threading.RLock()
        self._finished = threading.Event()
        self.exit_code: Optional[int] = None
        self._discovery_thread: Optional[threading.Thread] = None
        self._ready_timeout = env_cfg.elastic_ready_timeout()
        # The ready-deadline watchdog has a leaf lock of its own: it is
        # armed from the registry's record path on any thread.
        self._watchdog_lock = threading.Lock()
        self._watchdog: Optional[threading.Timer] = None
        self._watchdog_token: Optional[int] = None
        rendezvous.put_hook = self._observe_put

    def _put(self, key: str, value: bytes):
        self.rendezvous.handle_put(key, value)

    def _get(self, key: str):
        return self.rendezvous.handle_get(key)

    @property
    def finished(self) -> bool:
        return self._finished.is_set()

    def finish(self, code: int):
        with self._lock:
            if not self._finished.is_set():
                self.exit_code = code
                self._finished.set()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        self._finished.wait(timeout)
        return self.exit_code

    def start(self, create_worker: Callable):
        """create_worker(slot: SlotInfo, extra_env: dict) -> Popen."""
        self._create_worker = create_worker
        self.wait_for_available_slots(self.min_np)
        self._activate()
        self._discovery_thread = threading.Thread(
            target=self._discover_loop, name="elastic-discovery", daemon=True)
        self._discovery_thread.start()

    def wait_for_available_slots(self, min_np: int, timeout: float = 600.0):
        """(ref: driver.py:145 wait_for_available_slots)"""
        deadline = time.monotonic() + timeout
        while True:
            self.host_manager.update_available_hosts()
            if self.host_manager.available_slots() >= min_np:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"timed out waiting for {min_np} slots; available: "
                                   f"{self.host_manager.current_hosts}")
            time.sleep(self.poll_interval)

    def _discover_loop(self):
        """(ref: driver.py:176-195)"""
        while not self._finished.is_set():
            time.sleep(self.poll_interval)
            try:
                res = self.host_manager.update_available_hosts()
            except Exception as e:  # a discovery script hiccup
                logger.warning("host discovery failed: %s", e)
                continue
            if res != HostUpdateResult.NO_UPDATE and not self._finished.is_set():
                if self.host_manager.available_slots() < self.min_np:
                    logger.warning("hosts dropped below min_np=%d; waiting", self.min_np)
                    continue
                logger.info("host changes detected (%d); re-assigning", res)
                self._activate(notify_update=res)

    def resume(self):
        """Reactivation after a failure (ref: registration.py barrier action
        -> driver.resume); parked until discovery finds enough slots."""
        if self.host_manager.available_slots() >= self.min_np:
            self._activate()
        else:
            logger.warning("resume deferred: not enough slots")

    def _activate(self, notify_update: int = 0):
        with self._lock:
            if self._finished.is_set():
                return
            hosts = [HostInfo(h, s) for h, s in self.host_manager.current_hosts]
            slots = get_host_assignments(hosts, self.min_np, self.max_np)
            self.epoch += 1
            new_assignments: Dict[Tuple[str, int], SlotInfo] = {
                (s.hostname, s.local_rank): s for s in slots}
            # Rows of the assigned slots, INVALID rows for live workers that
            # lost theirs, the epoch key last.
            scope = f"rank_and_size_e{self.epoch}"
            for (host, idx), slot in new_assignments.items():
                self._put(f"{scope}/{host}:{idx}", slot.to_response_string().encode())
            for key in self._workers:
                if key not in new_assignments:
                    self._put(f"{scope}/{key[0]}:{key[1]}", INVALID_ROW.encode())
            self._put("meta/epoch", str(self.epoch).encode())
            self._assignments = new_assignments
            self._prune_dead_workers()
            for key, slot in new_assignments.items():
                if key not in self._workers:
                    self._spawn(key, slot)
            # Cancel the previous barrier's deadline before the registry
            # reset, or a verdict in the gap would see it as armed.
            self._cancel_watchdog()
            self.registry.reset(len(new_assignments),
                                expected={f"{h}:{i}" for (h, i) in new_assignments})
        if notify_update:
            self._notify_workers(notify_update)

    def _on_barrier_opened(self, reg_epoch: int):
        """The first verdict of registry epoch ``reg_epoch`` landed: give
        that barrier a deadline. A timer of a barrier that has resolved
        meanwhile is inert (its token no longer matches)."""
        if self._ready_timeout <= 0 or self._finished.is_set():
            return
        with self._watchdog_lock:
            if self._watchdog is not None:
                if self._watchdog_token == reg_epoch:
                    return
                self._watchdog.cancel()
            t = threading.Timer(self._ready_timeout, self._evict_stragglers,
                                args=(reg_epoch,))
            t.daemon = True
            t.name = f"elastic-watchdog-r{reg_epoch}"
            self._watchdog, self._watchdog_token = t, reg_epoch
            t.start()

    def _cancel_watchdog(self):
        with self._watchdog_lock:
            if self._watchdog is not None:
                self._watchdog.cancel()
                self._watchdog = None
                self._watchdog_token = None

    def _evict_stragglers(self, reg_epoch: int):
        """Kill every assigned slot with no verdict at the ready deadline
        and record it failed, so the barrier fires."""
        with self._watchdog_lock:
            if self._watchdog_token != reg_epoch:
                return
            self._watchdog = None
            self._watchdog_token = None
        with self._lock:
            if self._finished.is_set() or reg_epoch != self.registry.epoch:
                return
            verdicts = self.registry.verdicts()
            stragglers = [(k, self._workers.get(k)) for k in self._assignments
                          if f"{k[0]}:{k[1]}" not in verdicts]
        for (host, idx), rec in stragglers:
            logger.error("evicting worker %s:%d: no verdict %.0fs after the reset "
                         "barrier opened (HOROVOD_ELASTIC_READY_TIMEOUT)",
                         host, idx, self._ready_timeout)
            if rec is not None and rec.proc.poll() is None:
                try:
                    rec.proc.kill()
                except OSError:  # pragma: no cover - already gone
                    pass
            self.registry.record_failure(host, idx, epoch=reg_epoch)

    def _prune_dead_workers(self):
        for key in [k for k, w in self._workers.items() if w.proc.poll() is not None]:
            del self._workers[key]

    def _spawn(self, key: Tuple[str, int], slot: SlotInfo):
        extra_env = {
            env_cfg.ELASTIC: "1",
            env_cfg.MESH_SCOPE: f"hvd_mesh_e{self.epoch}",
            env_cfg.SPAWN_LOCAL_RANK: str(slot.local_rank),
        }
        proc = self._create_worker(slot, extra_env)
        rec = _WorkerRecord(key, proc)
        rec.thread = threading.Thread(target=self._monitor, args=(rec,), daemon=True,
                                      name=f"worker-{key[0]}:{key[1]}")
        self._workers[key] = rec
        rec.thread.start()

    def _monitor(self, rec: _WorkerRecord):
        """Wait for the process to exit; record its verdict."""
        rc = rec.proc.wait()
        if self._finished.is_set():
            return
        host, idx = rec.key
        with self._lock:
            cur = self._workers.get(rec.key)
            if cur is rec:
                del self._workers[rec.key]
            # A superseded process or an unassigned slot must not feed the
            # current epoch's barrier.
            stale = cur is not rec
            assigned = rec.key in self._assignments
        if rc == 0:
            if assigned and not stale:
                self.registry.record_success(host, idx)
        else:
            logger.warning("worker %s:%d exited with %d", host, idx, rc)
            if assigned and not stale:
                self.registry.record_failure(host, idx)

    def _observe_put(self, key: str, value: bytes):
        """Rendezvous put hook: READY announcements of resetting workers
        feed the registry's barrier."""
        if not key.startswith(READY_PREFIX):
            return
        epoch_part, _, ident = key[len(READY_PREFIX):].partition("/")
        try:
            epoch = int(epoch_part)
        except ValueError:
            return
        if not ident:
            return
        # The registry token before the epoch check: a late READY can never
        # count toward the next epoch's barrier.
        reg_epoch = self.registry.epoch
        if epoch == self.epoch:
            host, _, idx = ident.rpartition(":")
            try:
                self.registry.record(f"{host}:{int(idx)}", READY, epoch=reg_epoch)
            except ValueError:
                pass

    def _notify_workers(self, update_res: int):
        """Ping every live worker's notification endpoint (ref:
        runner/elastic/worker.py HostsUpdatedRequest)."""
        import http.client

        ts = time.time()
        with self._lock:
            keys = list(self._workers)
        for host, idx in keys:
            addr = self._get(f"workers_notify/{host}:{idx}")
            if addr is None:
                continue
            h, _, p = addr.decode().rpartition(":")
            try:
                c = http.client.HTTPConnection(h or "127.0.0.1", int(p), timeout=5)
                c.request("PUT", "/hosts_updated", body=f"{ts},{update_res}")
                c.getresponse().read()
                c.close()
            except OSError as e:
                logger.debug("notify %s:%s failed: %s", host, idx, e)

    def stop(self):
        self.finish(self.exit_code if self.exit_code is not None else 1)
        self._cancel_watchdog()
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            if w.proc.poll() is None:
                try:
                    w.proc.terminate()
                except OSError:
                    pass
        from ..launch import TERMINATE_GRACE_S

        for w in workers:
            try:
                w.proc.wait(timeout=TERMINATE_GRACE_S)
            except Exception:
                try:
                    w.proc.kill()
                except OSError:
                    pass
