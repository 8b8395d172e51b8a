"""GPT-2 causal LM and the BERT-shaped encoder in ``torch.nn`` (counterpart
of ``horovod_tpu/models/transformer.py:45-571``).

The numerics follow the flax model, so weights carried across with
``models/convert.py`` give the same logits:

* parameters in ``param_dtype`` (f32), compute in ``dtype`` (bf16 by
  default): each dense layer casts its input and its weights to ``dtype``;
* LayerNorm reduces in f32 with epsilon 1e-6, E[x^2] - E[x]^2 variance,
  and casts its output to ``dtype``;
* GELU is the tanh form (flax ``nn.gelu`` default);
* the token embedding is a lookup in f32 then a cast; positions are added
  in ``dtype``;
* logits are cast to ``logits_dtype`` (f32 by default; the training path
  opts into bf16).

Attention is ``dense`` (the einsum path, scores materialised) or
``flash`` (``ops/flash_attention.py``: the CUDA kernels on the card, their
plain version on the CPU). Ring/Ulysses attention and the Switch MoE FFN
are later slices and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Hyperparameters for the transformer family (the JAX config's fields
    that this slice uses, with the same defaults)."""

    vocab_size: int = 50257
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    causal: bool = True
    n_experts: int = 0
    logits_dtype: torch.dtype = torch.float32
    attn_impl: str = "dense"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


GPT2_CONFIGS = {
    "gpt2-tiny": TransformerConfig(vocab_size=1024, d_model=128, n_heads=4,
                                   n_layers=2, d_ff=512, max_len=256),
    "gpt2-small": TransformerConfig(d_model=768, n_heads=12, n_layers=12,
                                    d_ff=3072),
    "gpt2-medium": TransformerConfig(d_model=1024, n_heads=16, n_layers=24,
                                     d_ff=4096),
    "gpt2-large": TransformerConfig(d_model=1280, n_heads=20, n_layers=36,
                                    d_ff=5120),
    "gpt2-xl": TransformerConfig(d_model=1600, n_heads=25, n_layers=48,
                                 d_ff=6400),
    "gpt2-1p3b": TransformerConfig(d_model=2048, n_heads=16, n_layers=24,
                                   d_ff=8192, max_len=2048),
}

BERT_CONFIGS = {
    "bert-tiny": TransformerConfig(vocab_size=30522, d_model=128, n_heads=2,
                                   n_layers=2, d_ff=512, max_len=128,
                                   causal=False),
    "bert-base": TransformerConfig(vocab_size=30522, d_model=768, n_heads=12,
                                   n_layers=12, d_ff=3072, max_len=512,
                                   causal=False),
    "bert-large": TransformerConfig(vocab_size=30522, d_model=1024, n_heads=16,
                                    n_layers=24, d_ff=4096, max_len=512,
                                    causal=False),
}

INIT_STD = 0.02   # flax default_kernel_init: normal(stddev=0.02)


def _dense_attention_masked(cfg: TransformerConfig, q, k, v, mask):
    """Materialised attention, step for step as the JAX function: scores
    divided in the compute dtype, softmax in f32, -1e30 masking, and fully
    masked query rows give zeros."""
    Hd = q.shape[-1]
    S = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Hd)
    scores = scores.float()
    valid = None
    if cfg.causal:
        valid = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()[None, None]
    if mask is not None:
        km = mask[:, None, None, :].bool()
        valid = km if valid is None else valid & km
    if valid is not None:
        scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if valid is not None:
        probs = probs.masked_fill(~valid, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.dtype), v)


def _attention_dispatch(cfg: TransformerConfig, q, k, v, mask):
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, mask, causal=cfg.causal).to(cfg.dtype)
    if cfg.attn_impl == "dense":
        return _dense_attention_masked(cfg, q, k, v, mask)
    raise NotImplementedError(
        f"attn_impl={cfg.attn_impl!r} is not ported yet (dense, flash)")


class Dense(nn.Linear):
    """``nn.Linear`` holding ``param_dtype`` weights and computing in
    ``dtype``, as flax ``Dense(dtype=...)`` does."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: TransformerConfig, bias: bool = True, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def reset_parameters(self):
        nn.init.normal_(self.weight, std=INIT_STD)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics (fast variance,
    clipped at 0), epsilon 1e-6, output in ``dtype``."""

    def __init__(self, d: int, cfg: TransformerConfig, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=cfg.param_dtype, device=device))
        self.eps = eps
        self.dtype = cfg.dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Fused qkv projection laid out (3, H, Hd) as the flax DenseGeneral
    kernel is; q, k, v are strided views of its output, which the flash
    kernels read in place."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, Hd = cfg.n_heads, cfg.head_dim
        self.qkv = Dense(cfg.d_model, 3 * H * Hd, cfg, device=device)
        self.out = Dense(H * Hd, cfg.d_model, cfg, device=device)

    def forward(self, x, mask=None):
        cfg = self.cfg
        B, S, _ = x.shape
        qkv = self.qkv(x).view(B, S, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = qkv.unbind(dim=2)                        # (B, S, H, Hd)
        ctx = _attention_dispatch(cfg, q, k, v, mask)
        return self.out(ctx.reshape(B, S, cfg.n_heads * cfg.head_dim))


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.wi = Dense(cfg.d_model, cfg.d_ff, cfg, device=device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg, device=device)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class TransformerBlock(nn.Module):
    """Pre-LN block."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError("the Switch MoE FFN is not ported yet")
        self.ln1 = LayerNorm(cfg.d_model, cfg, device=device)
        self.attn = MultiHeadAttention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.d_model, cfg, device=device)
        self.mlp = MlpBlock(cfg, device=device)

    def forward(self, x, mask=None):
        h = x + self.attn(self.ln1(x), mask)
        return h + self.mlp(self.ln2(h))


class Embedder(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=device))
        self.pos_embedding = nn.Parameter(torch.empty(
            cfg.max_len, cfg.d_model, dtype=cfg.param_dtype, device=device))

    def forward(self, ids):
        x = F.embedding(ids, self.embedding).to(self.dtype)
        return x + self.pos_embedding[: ids.shape[1]].to(self.dtype)[None]


class TransformerStack(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(cfg, device=device) for _ in range(cfg.n_layers))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _Transformer(nn.Module):
    """Embedder, pre-LN stack, final LayerNorm and a bias-free vocabulary
    head named ``HEAD``. ``forward(ids, mask=None)`` returns (B, S, vocab)
    logits in ``cfg.logits_dtype``."""

    HEAD = ""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedder(cfg, device=device)
        self.stack = TransformerStack(cfg, device=device)
        self.ln_f = LayerNorm(cfg.d_model, cfg, device=device)
        self.add_module(self.HEAD, Dense(cfg.d_model, cfg.vocab_size, cfg,
                                         bias=False, device=device))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers: normal(0.02) for embeddings and dense
        kernels, zeros for biases, ones for LayerNorm scales. Draws from
        ``generator`` (which must live on the parameters' device)."""
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_f"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, INIT_STD, generator=generator)

    def forward(self, ids, mask=None):
        x = self.embed(ids)
        x = self.stack(x, mask)
        x = self.ln_f(x)
        return getattr(self, self.HEAD)(x).to(self.cfg.logits_dtype)


class TransformerLM(_Transformer):
    """Decoder-only causal LM, the GPT-2 shape."""

    HEAD = "lm_head"


class TransformerEncoder(_Transformer):
    """Bidirectional encoder with an MLM head, the BERT shape: attention is
    never causal, whatever ``cfg.causal`` says."""

    HEAD = "mlm_head"

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dataclasses.replace(cfg, causal=False), device=device,
                         generator=generator)
