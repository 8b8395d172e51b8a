"""Model registry: name -> (model factory, synthetic-batch factory).
Counterpart of ``horovod_tpu/models/registry.py``; the port has the GPT-2
entries so far."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np

from .transformer import GPT2_CONFIGS, TransformerLM


@dataclasses.dataclass
class ModelSpec:
    name: str
    make_model: Callable[..., Any]     # (device=None, generator=None, **cfg overrides)
    make_batch: Callable[..., Any]     # batch_size -> example inputs tuple
    kind: str                          # "lm"


def _token_batch(seq_len: int, vocab: int):
    """Seeded synthetic token ids, the same numpy draw as the JAX registry."""
    def make(batch_size: int, seed: int = 0, seq_len: int = seq_len):
        rng = np.random.RandomState(seed)
        return (rng.randint(0, vocab, size=(batch_size, seq_len),
                            dtype=np.int32),)

    return make


def _lm_factory(cfg):
    def make(device=None, generator=None, **overrides):
        c = dataclasses.replace(cfg, **overrides) if overrides else cfg
        return TransformerLM(c, device=device, generator=generator)

    return make


def _registry() -> Dict[str, ModelSpec]:
    reg: Dict[str, ModelSpec] = {}
    for name, cfg in GPT2_CONFIGS.items():
        reg[name] = ModelSpec(name, _lm_factory(cfg),
                              _token_batch(min(cfg.max_len, 512), cfg.vocab_size),
                              "lm")
    return reg


REGISTRY = _registry()


def get_model(name: str) -> ModelSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_models():
    return sorted(REGISTRY)
