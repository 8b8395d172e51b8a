"""The worker's side of elastic training: its rank after a reset, and the
host-update notifications (counterpart of ``horovod_tpu/backend/
elastic_env.py``; ref: horovod/common/gloo/gloo_context.cc:157-200 — on a
reset a worker reads its new rank and size from the rendezvous
``rank_and_size`` scope under hostname:local_rank, rank -1 meaning it was
removed; horovod/runner/elastic/worker.py — WorkerNotificationService)."""
from __future__ import annotations

import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..common import env as env_cfg
from ..utils.logging import get_logger
from .rendezvous import RendezvousClient

logger = get_logger()

NOTIFY_SCOPE = "workers_notify"
SCOPE_PREFIX = "hvd_mesh_e"


def _rendezvous() -> Optional[RendezvousClient]:
    addr = env_cfg.get_str(env_cfg.RENDEZVOUS_ADDR)
    port = env_cfg.get_int(env_cfg.RENDEZVOUS_PORT, 0)
    if not addr or not port:
        return None
    return RendezvousClient(addr, port)


def spawn_identity() -> str:
    """The worker's identity across resets: its host and the local slot it
    was spawned into (HOROVOD_LOCAL_RANK changes with reassignment)."""
    hostname = env_cfg.get_str(env_cfg.HOSTNAME, "localhost")
    spawn_lr = env_cfg.get_str(env_cfg.SPAWN_LOCAL_RANK) or str(
        env_cfg.get_int(env_cfg.LOCAL_RANK, 0))
    return f"{hostname}:{spawn_lr}"


def current_epoch() -> Optional[int]:
    scope = env_cfg.get_str(env_cfg.MESH_SCOPE)
    if scope.startswith(SCOPE_PREFIX):
        try:
            return int(scope[len(SCOPE_PREFIX):])
        except ValueError:
            return None
    return None


def refresh_topology_from_rendezvous(timeout: Optional[float] = None):
    """Take this worker's row of the driver's next epoch into HOROVOD_RANK,
    SIZE, ... (ref: gloo_context.cc:157-200). Announces readiness, waits
    for an epoch newer than this worker's (at most
    HOROVOD_ELASTIC_RESET_TIMEOUT), then reads its row; an INVALID row
    (rank -1) means this worker lost its slot, and it exits 0."""
    if timeout is None:
        timeout = env_cfg.elastic_reset_timeout()
    rdv = _rendezvous()
    if rdv is None:
        return
    key = spawn_identity()
    my_epoch = current_epoch()
    rdv.put(f"ready_e{my_epoch if my_epoch is not None else 0}", key, b"1")
    deadline = time.monotonic() + timeout
    while True:
        raw = rdv.get("meta", "epoch")
        if raw is not None:
            epoch = int(raw.decode())
            if my_epoch is None or epoch > my_epoch:
                break
        if time.monotonic() > deadline:
            raise TimeoutError("no new topology epoch from the elastic driver")
        time.sleep(0.1)
    data = rdv.wait_get(f"rank_and_size_e{epoch}", key).decode()
    rank, size, lrank, lsize, crank, csize = (int(v) for v in data.split(","))
    if rank == -1:
        logger.info("this worker was removed from the job; exiting")
        sys.exit(0)
    os.environ[env_cfg.RANK] = str(rank)
    os.environ[env_cfg.SIZE] = str(size)
    os.environ[env_cfg.LOCAL_RANK] = str(lrank)
    os.environ[env_cfg.LOCAL_SIZE] = str(lsize)
    os.environ[env_cfg.CROSS_RANK] = str(crank)
    os.environ[env_cfg.CROSS_SIZE] = str(csize)
    # The epoch names the store prefix of the next process groups.
    os.environ[env_cfg.MESH_SCOPE] = f"{SCOPE_PREFIX}{epoch}"


class _NotifyHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def do_PUT(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0))).decode()
        self.server.manager._on_hosts_updated(body)  # type: ignore
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


class WorkerNotificationManager:
    """Receives the driver's host-update pings and fans them out to the
    registered State listeners (ref: horovod/runner/elastic/worker.py:
    20-110). An epoch watcher polls ``meta/epoch`` besides, since a ping
    to a worker that had not registered yet is lost."""

    def __init__(self):
        self._listeners: List = []
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._initialized = False
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def init(self):
        with self._lock:
            if self._initialized:
                return
            rdv = _rendezvous()
            if rdv is None or not env_cfg.get_bool(env_cfg.ELASTIC, False):
                self._initialized = True
                return
            self._stop = threading.Event()
            self._httpd = ThreadingHTTPServer(("0.0.0.0", 0), _NotifyHandler)
            self._httpd.manager = self  # type: ignore
            server_t = threading.Thread(target=self._httpd.serve_forever,
                                        name="hvd-notify", daemon=True)
            server_t.start()
            port = self._httpd.server_address[1]
            hostname = env_cfg.get_str(env_cfg.HOSTNAME, "localhost")
            reach = ("127.0.0.1" if hostname in ("localhost", "127.0.0.1", "")
                     or os.environ.get("HVDRUN_FORCE_LOCAL") else hostname)
            rdv.put(NOTIFY_SCOPE, spawn_identity(), f"{reach}:{port}".encode())
            watch_t = threading.Thread(target=self._epoch_watch, args=(rdv, self._stop),
                                       name="hvd-epoch-watch", daemon=True)
            watch_t.start()
            self._threads = [server_t, watch_t]
            self._initialized = True

    def shutdown(self):
        """Stop the notify server and the epoch watcher (``hvd.shutdown()``
        calls it); the listeners stay registered across a reset."""
        with self._lock:
            if not self._initialized:
                return
            self._stop.set()
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._httpd = None
            threads, self._threads = self._threads, []
            self._initialized = False
        for t in threads:
            t.join(timeout=10)

    def _epoch_watch(self, rdv: RendezvousClient, stop: threading.Event):
        notified_epoch: Optional[int] = None
        while not stop.wait(env_cfg.elastic_epoch_poll()):
            try:
                raw = rdv.get("meta", "epoch")
                epoch = int(raw.decode()) if raw is not None else None
            except (OSError, ValueError):
                continue
            if epoch is None:
                continue
            current = current_epoch() or 0
            if epoch > current and epoch != notified_epoch:
                # ADDED forces a sync, the safe guess when the watcher cannot
                # know the change; latched only once a listener got it.
                if self._on_hosts_updated(f"{time.time()},2"):
                    notified_epoch = epoch

    def register_listener(self, state):
        with self._lock:
            self._listeners.append(state)

    def remove_listener(self, state):
        with self._lock:
            if state in self._listeners:
                self._listeners.remove(state)

    def _on_hosts_updated(self, body: str) -> int:
        """Fan a notification out; returns how many listeners got it."""
        parts = body.split(",")
        ts = float(parts[0]) if parts and parts[0] else time.time()
        res = int(parts[1]) if len(parts) > 1 else 0
        with self._lock:
            for listener in self._listeners:
                listener.on_hosts_updated(ts, res)
            return len(self._listeners)


notification_manager = WorkerNotificationManager()
