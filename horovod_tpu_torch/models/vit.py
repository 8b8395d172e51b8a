"""Vision Transformer (counterpart of ``horovod_tpu/models/vit.py``; the
"ViT-L/16 ImageNet DP" configuration of BASELINE.json).

The encoder is the port's ``TransformerStack`` (dense, non-causal
attention, as the JAX model runs: ``ViTConfig.transformer()`` sets no
``attn_impl``), between the same pieces as the flax model:

* the patch embedding, a ``patch_size``-strided convolution with a bias,
  takes the registry's (B, H, W, 3) float32 images (viewed NCHW, as the
  port's ResNet does), casts them and its f32 weights to ``dtype`` and
  adds the bias after the product, in ``dtype``, as flax ``nn.Conv`` does;
* a zero-initialised CLS token (1, 1, D) is put before the patches, then
  the learned ``pos_embedding`` (n_patches + 1, D) is added in ``dtype``;
* ``ln_f``, then the head (``Dense``, with a bias) on token 0; the logits
  are f32.

Dropout follows ``ViTConfig.dropout_rate`` through the stack's FFNs in a
forward with ``deterministic=False`` (``models/dropout.py``). ViT runs
over dp only: a mesh with pp, ep, sp or tp above one raises
``NotImplementedError`` (ROADMAP A3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dropout
from .transformer import (Dense, LayerNorm, TransformerConfig, TransformerStack,
                          init_param_)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    scan_layers: bool = False

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def transformer(self) -> TransformerConfig:
        """The encoder's configuration, as the JAX ``ViTConfig.transformer()``."""
        return TransformerConfig(
            vocab_size=self.num_classes, d_model=self.d_model, n_heads=self.n_heads,
            n_layers=self.n_layers, d_ff=self.d_ff, max_len=self.n_patches + 1,
            dropout_rate=self.dropout_rate, dtype=self.dtype,
            param_dtype=self.param_dtype, causal=False, remat=self.remat,
            scan_layers=self.scan_layers)


VIT_CONFIGS = {
    "vit-tiny": ViTConfig(image_size=32, patch_size=4, num_classes=10,
                          d_model=64, n_heads=4, n_layers=2, d_ff=256),
    "vit-s16": ViTConfig(d_model=384, n_heads=6, n_layers=12, d_ff=1536),
    "vit-b16": ViTConfig(d_model=768, n_heads=12, n_layers=12, d_ff=3072),
    "vit-l16": ViTConfig(d_model=1024, n_heads=16, n_layers=24, d_ff=4096),
}


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(D, (p, p), strides=(p, p), padding="VALID")``: an
    (D, 3, p, p) kernel and a bias, in ``dtype`` (the bias added after the
    product); (B, 3, H, W) in, (B, HW / p², D) out, patches in row-major
    order as the flax (B, H/p, W/p, D) output reshapes."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        D, p, pd = cfg.d_model, cfg.patch_size, cfg.param_dtype
        self.weight = nn.Parameter(torch.empty(D, 3, p, p, dtype=pd, device=device))
        self.bias = nn.Parameter(torch.empty(D, dtype=pd, device=device))
        self.patch, self.dtype = p, cfg.dtype

    def forward(self, x):
        dt = self.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), stride=self.patch)
        return y.flatten(2).transpose(1, 2) + self.bias.to(dt)


class ViT(nn.Module):
    """``forward(images, deterministic=True)``: (B, H, W, 3) float32 images
    to (B, num_classes) f32 logits."""

    def __init__(self, cfg: ViTConfig, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        if mesh is not None:
            for axis in ("pp", "ep", "sp", "tp"):
                if mesh.shape.get(axis, 1) > 1:
                    raise NotImplementedError(f"ViT over {axis}={mesh.shape[axis]} is not "
                                              "ported (ROADMAP A3); it runs over dp")
        self.cfg, self.mesh = cfg, mesh
        tcfg = cfg.transformer()
        D, pd = cfg.d_model, cfg.param_dtype
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, D, dtype=pd, device=device))
        self.pos_embedding = nn.Parameter(torch.empty(cfg.n_patches + 1, D, dtype=pd,
                                                      device=device))
        self.stack = TransformerStack(tcfg, device=device)
        self.ln_f = LayerNorm(D, tcfg, device=device)
        self.head = Dense(D, cfg.num_classes, tcfg, device=device)
        dropout.number_sites(self)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers: normal(0.02) for the patch kernel, the
        positions and every dense kernel, zeros for the CLS token and the
        biases, ones for the LayerNorm scales. Draws from ``generator`` in
        ``named_parameters`` order."""
        for name, p in self.named_parameters():
            if name == "cls":
                p.zero_()
            else:
                init_param_(name, p, generator)

    def forward(self, images: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        dt = self.cfg.dtype
        with dropout.scope(self, deterministic):
            x = self.patch_embed(images.permute(0, 3, 1, 2))     # (B, HW, D)
            cls = self.cls.to(dt).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)[None]
            x = self.ln_f(self.stack(x))
            return self.head(x[:, 0]).float()
