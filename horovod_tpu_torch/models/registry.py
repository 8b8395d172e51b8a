"""Model registry: name -> (model factory, synthetic-batch factory).
Counterpart of ``horovod_tpu/models/registry.py``, with every entry of it:
``mnist-mlp`` and ``mnist-cnn`` (28x28x1 images), the ResNets (224x224x3),
the GPT-2 and BERT sizes (token ids) and ``vit-tiny`` to ``vit-l16``
(images of the configuration's size), each with the JAX registry's batch.

``make_model(device=None, ...)`` builds on ``hvd.device()`` once
``hvd.init()`` has run, else on the current CUDA card; without CUDA it
raises, as ``hvd.init()`` does. The CPU is used only when
``device="cpu"`` is passed."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..common import basics
from ..parallel.sharding import DEFAULT_RULES
from .mnist import MnistCNN, MnistMLP
from .resnet import RESNET_CONFIGS
from .transformer import BERT_CONFIGS, GPT2_CONFIGS, TransformerEncoder, TransformerLM
from .vit import VIT_CONFIGS, ViT


@dataclasses.dataclass
class ModelSpec:
    name: str
    make_model: Callable[..., Any]     # (device=None, generator=None, [mesh=None, rules=,] **overrides)
    make_batch: Callable[..., Any]     # batch_size -> example inputs tuple
    kind: str                          # "image" | "lm" | "encoder"


def _resolve_device(device):
    if device is not None:
        return torch.device(device)
    if basics.is_initialized():
        return basics.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_model(): CUDA is not available; pass device='cpu' to build "
            "the model on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _image_batch(hw: int, channels: int = 3):
    """Seeded synthetic images, the same numpy draw as the JAX registry."""
    def make(batch_size: int, seed: int = 0):
        rng = np.random.RandomState(seed)
        return (rng.rand(batch_size, hw, hw, channels).astype(np.float32),)

    return make


def _token_batch(seq_len: int, vocab: int):
    """Seeded synthetic token ids, the same numpy draw as the JAX registry."""
    def make(batch_size: int, seed: int = 0, seq_len: int = seq_len):
        rng = np.random.RandomState(seed)
        return (rng.randint(0, vocab, size=(batch_size, seq_len),
                            dtype=np.int32),)

    return make


def _transformer_factory(cls, cfg):
    def make(device=None, generator=None, mesh=None, rules=DEFAULT_RULES, **overrides):
        c = dataclasses.replace(cfg, **overrides) if overrides else cfg
        return cls(c, device=_resolve_device(device), generator=generator, mesh=mesh,
                   rules=rules)

    return make


def _vit_factory(cfg):
    def make(device=None, generator=None, mesh=None, **overrides):
        c = dataclasses.replace(cfg, **overrides) if overrides else cfg
        return ViT(c, device=_resolve_device(device), generator=generator, mesh=mesh)

    return make


def _module_factory(ctor):
    def make(device=None, generator=None, **overrides):
        return ctor(device=_resolve_device(device), generator=generator, **overrides)

    return make


def _registry() -> Dict[str, ModelSpec]:
    reg: Dict[str, ModelSpec] = {}
    reg["mnist-mlp"] = ModelSpec("mnist-mlp", _module_factory(MnistMLP),
                                 _image_batch(28, 1), "image")
    reg["mnist-cnn"] = ModelSpec("mnist-cnn", _module_factory(MnistCNN),
                                 _image_batch(28, 1), "image")
    for name, ctor in RESNET_CONFIGS.items():
        reg[name] = ModelSpec(name, _module_factory(ctor), _image_batch(224), "image")
    for name, cfg in GPT2_CONFIGS.items():
        reg[name] = ModelSpec(name, _transformer_factory(TransformerLM, cfg),
                              _token_batch(min(cfg.max_len, 512), cfg.vocab_size),
                              "lm")
    for name, cfg in BERT_CONFIGS.items():
        reg[name] = ModelSpec(name, _transformer_factory(TransformerEncoder, cfg),
                              _token_batch(min(cfg.max_len, 128), cfg.vocab_size),
                              "encoder")
    for name, cfg in VIT_CONFIGS.items():
        reg[name] = ModelSpec(name, _vit_factory(cfg), _image_batch(cfg.image_size), "image")
    return reg


REGISTRY = _registry()


def get_model(name: str) -> ModelSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_models():
    return sorted(REGISTRY)
