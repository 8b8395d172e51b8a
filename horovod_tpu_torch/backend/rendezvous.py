"""HTTP KV rendezvous client, the worker's side (counterpart of
``horovod_tpu/backend/rendezvous.py``; ref: horovod/runner/http/
http_client.py:17-45).

Requests are HMAC-signed with the job secret from HOROVOD_SECRET_KEY when
one is set (``runner/rendezvous_server.py``). Transport failures retry
with jittered backoff (``utils/retry.py``); a 403 raises
``PermissionError`` at once. Every attempt counts in the JAX package's
``horovod_rendezvous_requests_total``. The JAX client's per-job key
namespace (HOROVOD_JOB_NAME), for jobs that share one server, waits for
ROADMAP A9.
"""
from __future__ import annotations

import http.client
import time
from typing import Optional

from ..utils.logging import get_logger
from ..utils.retry import call_with_retry

logger = get_logger()

_request_counter_cache = None


def _request_counter():
    # Cached: a wait polls the KV store at 20 Hz; the registry lookup
    # happens once, not a poll.
    global _request_counter_cache
    if _request_counter_cache is None:
        from ..common import telemetry

        _request_counter_cache = telemetry.counter(
            "horovod_rendezvous_requests_total",
            "HTTP requests issued against the rendezvous server "
            "(retries included)",
        )
    return _request_counter_cache


class RendezvousClient:
    def __init__(self, addr: str, port: int, timeout: float = 60.0,
                 secret_key: Optional[bytes] = None):
        self.addr = addr
        self.port = port
        self.timeout = timeout
        if secret_key is None:
            from ..runner.util import secret as secret_util

            secret_key = secret_util.key_from_env()
        self.secret_key = secret_key

    @staticmethod
    def _path(suffix: str) -> str:
        return f"/{suffix}"

    def _conn(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.addr, self.port, timeout=10.0)

    def _retry(self, fn, what: str):
        counter = _request_counter()

        def counted():
            counter.inc()
            return fn()

        return call_with_retry(counted, what, retry_on=(OSError, http.client.HTTPException))

    def _headers(self, method: str, path: str, body: bytes = b"") -> dict:
        if self.secret_key is None:
            return {}
        from ..runner.rendezvous_server import sign_request

        digest, ts = sign_request(self.secret_key, method, path, body)
        return {"X-Horovod-Digest": digest, "X-Horovod-Timestamp": ts}

    def _request(self, method: str, path: str, body: bytes = b""):
        """(status, body) of one request; a 403 raises PermissionError."""
        c = self._conn()
        try:
            c.request(method, path, body=body or None,
                      headers=self._headers(method, path, body))
            r = c.getresponse()
            data = r.read()
            if r.status == 403:
                raise PermissionError(
                    "rendezvous rejected request: "
                    + (r.getheader("X-Horovod-Reject-Reason")
                       or "bad or missing HOROVOD_SECRET_KEY digest"))
            return r.status, data
        finally:
            c.close()

    def put(self, scope: str, key: str, value: bytes):
        def _put():
            status, _ = self._request("PUT", self._path(f"{scope}/{key}"), value)
            if status != 200:
                raise RuntimeError(f"rendezvous PUT failed: {status}")

        self._retry(_put, f"rendezvous PUT {scope}/{key}")

    def get(self, scope: str, key: str) -> Optional[bytes]:
        def _get():
            status, data = self._request("GET", self._path(f"{scope}/{key}"))
            return data if status == 200 else None

        return self._retry(_get, f"rendezvous GET {scope}/{key}")

    def wait_get(self, scope: str, key: str) -> bytes:
        """Poll until the key exists; one warning when the wait turns long."""
        start = time.monotonic()
        deadline = start + self.timeout
        warn_at: Optional[float] = start + min(self.timeout / 2, 15.0)
        while True:
            v = self.get(scope, key)
            if v is not None:
                return v
            now = time.monotonic()
            if warn_at is not None and now > warn_at:
                logger.warning("still waiting for rendezvous key %s/%s after %.0fs "
                               "(peer slow to register?)", scope, key, now - start)
                warn_at = None
            if now > deadline:
                raise TimeoutError(f"rendezvous key {scope}/{key} never appeared")
            time.sleep(0.05)

    def delete(self, scope: str):
        self._retry(lambda: self._request("DELETE", self._path(scope)),
                    f"rendezvous DELETE {scope}")
