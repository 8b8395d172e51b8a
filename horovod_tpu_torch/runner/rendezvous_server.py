"""Threaded HTTP key-value rendezvous server (counterpart of
``horovod_tpu/runner/rendezvous_server.py``; ref: horovod/runner/http/
http_server.py:35-242).

Workers PUT/GET small values under scoped keys; the elastic driver hands
out rank assignments through it (ref: horovod/runner/elastic/
rendezvous.py:28-52). With a per-job secret (the launcher makes one and
ships it as HOROVOD_SECRET_KEY), every request carries an HMAC-SHA256
digest over ``method\\npath\\ntimestamp\\nbody`` in ``X-Horovod-Digest``
beside ``X-Horovod-Timestamp``; a request without a good one gets 403,
with the reason in ``X-Horovod-Reject-Reason``. A mutating request is
accepted once inside the replay window. The wire is the JAX package's:
either package's client talks to either's server.

The JAX server's capacity arbitration between jobs that share it
(HOROVOD_FLEET_SLOTS) serves the serving plane and waits for ROADMAP A9.
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from ..common import env as env_cfg
from ..utils.logging import get_logger
from .util import secret as secret_util

logger = get_logger()

REPLAY_WINDOW_S = env_cfg.DEFAULT_REPLAY_WINDOW_S


def sign_request(key: bytes, method: str, path: str, body: bytes,
                 ts: Optional[str] = None) -> Tuple[str, str]:
    """(digest_hex, timestamp) for the request headers."""
    if ts is None:
        ts = repr(time.time())
    msg = b"\n".join((method.encode(), path.encode(), ts.encode(), body))
    return secret_util.compute_digest(key, msg).hex(), ts


def _check_request(key: bytes, method: str, path: str, body: bytes,
                   digest_hex: Optional[str], ts: Optional[str]) -> Tuple[bool, str]:
    """(ok, reason): the reason tells clock skew from a wrong key."""
    if not digest_hex or not ts:
        return False, "missing digest or timestamp header"
    try:
        digest = bytes.fromhex(digest_hex)
        tval = float(ts)
    except ValueError:
        return False, "malformed digest or timestamp"
    window = env_cfg.replay_window()
    if window > 0 and abs(time.time() - tval) > window:
        # ASCII only: this string travels in an HTTP header (latin-1).
        return False, (
            f"timestamp {abs(time.time() - tval):.0f}s outside the "
            f"{window:.0f}s replay window - check host clocks (NTP) or "
            "raise HOROVOD_REPLAY_WINDOW")
    msg = b"\n".join((method.encode(), path.encode(), ts.encode(), body))
    if not secret_util.check_digest(key, msg, digest):
        return False, "bad digest (HOROVOD_SECRET_KEY mismatch?)"
    return True, ""


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _key(self) -> str:
        return self.path.lstrip("/")

    def _empty(self, status: int, reason: Optional[str] = None):
        self.send_response(status)
        if reason:
            self.send_header("X-Horovod-Reject-Reason", reason)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _authorized(self, body: bytes = b"") -> bool:
        server: RendezvousServer = self.server.rendezvous  # type: ignore
        if server.secret_key is None:
            return True
        digest_hex = self.headers.get("X-Horovod-Digest")
        ok, reason = _check_request(server.secret_key, self.command, self.path,
                                    body, digest_hex,
                                    self.headers.get("X-Horovod-Timestamp"))
        # A GET may retry; a mutating request replayed verbatim may not.
        if ok and self.command in ("PUT", "DELETE") \
                and not server._accept_once(digest_hex):
            ok, reason = False, "replayed request (digest already seen)"
        if not ok:
            self._empty(403, reason)
        return ok

    def do_GET(self):
        if not self._authorized():
            return
        server: RendezvousServer = self.server.rendezvous  # type: ignore
        val = server.handle_get(self._key())
        if val is None:
            self._empty(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_PUT(self):
        server: RendezvousServer = self.server.rendezvous  # type: ignore
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if not self._authorized(body):
            return
        server.handle_put(self._key(), body)
        self._empty(200)

    def do_DELETE(self):
        # Scope finalization (ref: http_server.py RendezvousHandler DELETE).
        if not self._authorized():
            return
        server: RendezvousServer = self.server.rendezvous  # type: ignore
        server.handle_delete(self._key())
        self._empty(200)


class RendezvousServer:
    def __init__(self, secret_key: Optional[bytes] = None):
        self.secret_key = secret_key
        self._store: Dict[str, bytes] = {}
        self._seen_digests: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # The elastic driver's hook on every PUT.
        self.put_hook: Optional[Callable[[str, bytes], None]] = None

    def start(self, port: int = 0) -> int:
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), _KVHandler)
        self._httpd.rendezvous = self  # type: ignore
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="rendezvous", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_address[1]

    def _accept_once(self, digest_hex: str) -> bool:
        """True the first time a digest is seen inside the window. With
        the window off, the memory of digests is bounded by count."""
        now = time.time()
        with self._lock:
            window = env_cfg.replay_window()
            if window <= 0:
                while len(self._seen_digests) >= 65536:
                    del self._seen_digests[next(iter(self._seen_digests))]
            elif len(self._seen_digests) > 4096:
                cutoff = now - max(window, REPLAY_WINDOW_S)
                for d in [d for d, t in self._seen_digests.items() if t < cutoff]:
                    del self._seen_digests[d]
            if digest_hex in self._seen_digests:
                return False
            self._seen_digests[digest_hex] = now
            return True

    def handle_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._store.get(key)

    def handle_put(self, key: str, value: bytes):
        if self.put_hook is not None:
            self.put_hook(key, value)
        with self._lock:
            self._store[key] = value

    def handle_delete(self, key: str):
        with self._lock:
            prefix = key.rstrip("/") + "/"
            for k in [k for k in self._store if k == key or k.startswith(prefix)]:
                del self._store[k]

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
