"""flax parameters -> the port's ``state_dict``.

``flax_to_torch(params, cfg)`` takes the ``params`` tree of the JAX
``TransformerLM`` as nested dicts of numpy arrays (unboxed) and returns the
``state_dict`` of ``models.transformer.TransformerLM(cfg)``. flax kernels
are (in, out), the transpose of ``nn.Linear.weight``; the qkv kernel
(D, 3, H, Hd) keeps its (3, H, Hd) order when flattened, and the out
kernel (H, Hd, D) flattens to (H*Hd, D). A missing or extra key raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .transformer import TransformerConfig


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _dense(kernel: np.ndarray, in_features: int) -> np.ndarray:
    return kernel.reshape(in_features, -1).T


def flax_to_torch(params: Mapping, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    flat = _flatten(params)
    D = cfg.d_model
    HHd = cfg.n_heads * cfg.head_dim
    plan = {   # flax path -> (torch key, transform)
        "embed/embedding": ("embed.embedding", None),
        "embed/pos_embedding": ("embed.pos_embedding", None),
        "ln_f/scale": ("ln_f.weight", None),
        "ln_f/bias": ("ln_f.bias", None),
        "lm_head/kernel": ("lm_head.weight", lambda a: _dense(a, D)),
    }
    for i in range(cfg.n_layers):
        src, dst = f"stack/layer_{i}", f"stack.layers.{i}"
        for ln in ("ln1", "ln2"):
            plan[f"{src}/{ln}/scale"] = (f"{dst}.{ln}.weight", None)
            plan[f"{src}/{ln}/bias"] = (f"{dst}.{ln}.bias", None)
        plan[f"{src}/attn/qkv/kernel"] = (f"{dst}.attn.qkv.weight",
                                          lambda a: _dense(a, D))
        plan[f"{src}/attn/qkv/bias"] = (f"{dst}.attn.qkv.bias",
                                        lambda a: a.reshape(-1))
        plan[f"{src}/attn/out/kernel"] = (f"{dst}.attn.out.weight",
                                          lambda a: _dense(a, HHd))
        plan[f"{src}/attn/out/bias"] = (f"{dst}.attn.out.bias", None)
        for name, fan_in in (("wi", D), ("wo", cfg.d_ff)):
            plan[f"{src}/mlp/{name}/kernel"] = (
                f"{dst}.mlp.{name}.weight", lambda a, n=fan_in: _dense(a, n))
            plan[f"{src}/mlp/{name}/bias"] = (f"{dst}.mlp.{name}.bias", None)

    missing = sorted(set(plan) - set(flat))
    extra = sorted(set(flat) - set(plan))
    if missing or extra:
        raise KeyError(f"flax params do not match the config: missing {missing}, "
                       f"extra {extra}")
    out = {}
    for path, (key, fn) in plan.items():
        arr = flat[path] if fn is None else fn(flat[path])
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(cfg.param_dtype)
    return out
