"""Dropout with masks drawn from explicit seeds (counterpart of flax
``nn.Dropout`` under the JAX step's per-step ``dropout`` rng,
``horovod_tpu/parallel/train.py:227-231``).

The masks cannot match JAX's PRNG bits; the rule is the same: an element
is kept with probability ``1 - rate`` and the kept ones are divided by
``1 - rate`` in the input's dtype (flax: ``lax.select(mask, x / keep, 0)``).

Nothing is dropped unless a forward runs with ``deterministic=False``
inside ``dropout_key(*key)``: a model's ``forward(..., deterministic=True)``
(the default, as in JAX) runs under ``deterministic()``, which clears the
key. Each ``Dropout`` layer holds a site number, fixed when the model is
built (``number_sites``); under a key it draws its mask from a
``torch.Generator`` on the input's device seeded by a hash of (key, site).
So a mask depends on the key and the layer only, never on the global RNG
or on how often a layer ran:

* ``remat`` recomputes a block's forward in backward under the key of
  the forward (``run_blocks``), which redraws the forward's masks bit for
  bit;
* the training step's key is (``dropout_seed``, step, dp coordinate, sp
  coordinate): the ranks of a tp line (and of an ep line), which hold the
  same activations, draw the same masks; ranks with other rows or another
  sequence block draw others.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import struct
from typing import Optional, Tuple

import torch
from torch import nn

_KEY: contextvars.ContextVar[Optional[Tuple[int, ...]]] = contextvars.ContextVar(
    "dropout_key", default=None)


@contextlib.contextmanager
def dropout_key(*key: int):
    """Run the ``Dropout`` layers of forwards with ``deterministic=False``
    inside on masks seeded by ``key`` (integers)."""
    token = _KEY.set(tuple(int(k) for k in key))
    try:
        yield
    finally:
        _KEY.reset(token)


@contextlib.contextmanager
def deterministic():
    """No dropout inside, whatever key an outer scope set."""
    token = _KEY.set(None)
    try:
        yield
    finally:
        _KEY.reset(token)


def current_key() -> Optional[Tuple[int, ...]]:
    return _KEY.get()


def scope(model: nn.Module, no_dropout: bool):
    """The context a model's ``forward(..., deterministic=no_dropout)``
    runs in: ``deterministic()``, or the caller's key, which a model
    holding a dropout layer of a positive rate needs."""
    if no_dropout:
        return deterministic()
    if _KEY.get() is None and any(isinstance(m, Dropout) and m.rate > 0
                                  for m in model.modules()):
        raise ValueError("a forward with deterministic=False draws dropout masks: run it "
                         "inside dropout_key(...) (make_train_step(dropout=True) does)")
    return contextlib.nullcontext()


def number_sites(model: nn.Module) -> None:
    """Give each ``Dropout`` layer of ``model`` its site: its index among
    them in module order."""
    for i, m in enumerate(m for m in model.modules() if isinstance(m, Dropout)):
        m.site = i


def _seed(key: Tuple[int, ...], site: int) -> int:
    digest = hashlib.blake2b(struct.pack(f"<{len(key) + 1}q", *key, site),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``; see the module docstring for where its
    masks come from."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1]")
        self.rate = rate
        self.site = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        key = _KEY.get()
        if key is None or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        gen = torch.Generator(device=x.device).manual_seed(_seed(key, self.site))
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}, site={self.site}"
