"""Shared-secret HMAC helpers of the launcher (counterpart of
``horovod_tpu/runner/util/secret.py``; ref: horovod/runner/common/util/
secret.py:21-37): a per-job 32-byte secret reaches the workers through
their environment, and every rendezvous request carries an HMAC-SHA256
digest checked before the server acts on it."""
from __future__ import annotations

import hashlib
import hmac
import os
from typing import Optional

from ...common import env as env_cfg

SECRET_LENGTH = 32  # bytes
DIGEST_LENGTH = 32  # bytes (sha256)
SECRET_ENV = env_cfg.SECRET_KEY


def make_secret_key() -> bytes:
    return os.urandom(SECRET_LENGTH)


def compute_digest(key: bytes, message: bytes) -> bytes:
    return hmac.new(key, message, hashlib.sha256).digest()


def check_digest(key: bytes, message: bytes, digest: bytes) -> bool:
    return hmac.compare_digest(compute_digest(key, message), digest)


def key_from_env() -> Optional[bytes]:
    """The job secret from the environment, if it is set and is hex."""
    v = os.environ.get(SECRET_ENV)
    if not v:
        return None
    try:
        return bytes.fromhex(v)
    except ValueError:
        return None


def key_to_env(key: bytes) -> str:
    return key.hex()
