"""PipelinedLM: the causal LM with its block stack run as a GPipe pipeline
over the pp mesh axis (counterpart of ``horovod_tpu/models/pipelined.py``).

The JAX model keeps the whole scan-stacked parameter tree and lets
``shard_map`` hand each pp device its stage's rows. Here a rank builds and
holds only its stage's ``L / S`` blocks (``PIPELINE_RULES`` put the layer
axis over pp), beside the embeddings, ``ln_f`` and ``lm_head``, which every
pp rank holds. The blocks keep their global layer index in the
``state_dict`` (``stack.layers.<i>.*``), so a stage loads from, and saves
to, the unpipelined ``TransformerLM``'s ``state_dict`` (its entries under
this model's keys, or ``models/convert.flax_to_torch(..., stages=,
stage=)`` from the JAX tree), and ``init_weights`` draws the same weights
from one generator as ``TransformerLM`` does.

The forward is the JAX one: embed, ``parallel/pipeline.gpipe`` over the
stage's blocks (with ``cfg.remat``, each block recomputed in backward),
``ln_f``, the head, logits in ``cfg.logits_dtype``. pp combines with dp;
sp, ep and tp under pp are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import Mesh
from ..parallel.pipeline import gpipe, stage_layers
from ..parallel.sharding import PIPELINE_RULES
from . import dropout
from .transformer import (Dense, Embedder, LayerNorm, TransformerBlock, TransformerConfig,
                          init_param_, run_blocks)


class _Stage(nn.Module):
    """This rank's blocks, named by their global layer index."""

    def __init__(self, cfg: TransformerConfig, layers: range, device=None):
        super().__init__()
        self.remat = cfg.remat
        self.layers = nn.ModuleDict(
            {str(i): TransformerBlock(cfg, device=device) for i in layers})


class PipelinedLM(nn.Module):
    """``forward(ids)`` returns the (B, S, vocab) logits, the same on every
    rank of a pp line; ``ids`` is the batch of this rank's dp coordinate.
    The model is built on ``device``, by default the mesh's (this rank's
    card, or the CPU of a gloo world)."""

    rules = PIPELINE_RULES

    def __init__(self, cfg: TransformerConfig, mesh: Mesh, axis: str = "pp",
                 num_microbatches: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.scan_layers or cfg.n_experts:
            raise ValueError("PipelinedLM needs scan_layers=True and a dense FFN "
                             "(stage params must stack homogeneously)")
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} is not in the mesh {mesh.axis_names}")
        S = mesh.shape[axis]
        if cfg.n_layers % S != 0:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={S}")
        for other in ("sp", "ep"):
            if mesh.shape.get(other, 1) > 1:
                raise NotImplementedError(f"PipelinedLM on a mesh with {other} > 1 is not "
                                          "ported; pp combines with dp")
        if mesh.shape.get("tp", 1) > 1:
            raise NotImplementedError(f"PipelinedLM on a mesh with tp={mesh.shape['tp']} is "
                                      "not ported (ROADMAP A3: tp under pp)")
        if cfg.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(f"attn_impl={cfg.attn_impl!r} under pp is not ported")
        if cfg.logits_via_embedding:
            raise NotImplementedError("logits_via_embedding under pp is not ported (ROADMAP "
                                      "A3: the tied head on a cut embedding)")
        device = mesh.device if device is None else device
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.num_microbatches = num_microbatches
        self.layer_range = stage_layers(cfg.n_layers, S, mesh.coords[axis])
        self.embed = Embedder(cfg, device=device)
        self.stack = _Stage(cfg, self.layer_range, device=device)
        self.ln_f = LayerNorm(cfg.d_model, cfg, device=device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg, bias=False, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """``TransformerLM``'s draws, in its parameter order, from
        ``generator``: the blocks of other stages are drawn into a scratch
        tensor and dropped, so every pp layout of one seed holds the
        weights of the one unpipelined model."""
        held = dict(self.named_parameters())
        template = TransformerBlock(self.cfg, device="meta")
        names = ["embed.embedding"] + (["embed.pos_embedding"] if self.cfg.learned_pos
                                       else [])
        names += [f"stack.layers.{i}.{n}" for i in range(self.cfg.n_layers)
                  for n, _ in template.named_parameters()]
        names += ["ln_f.weight", "ln_f.bias", "lm_head.weight"]
        shapes = dict(template.named_parameters())
        dev = self.lm_head.weight.device
        for name in names:
            p = held.get(name)
            if p is None:
                like = shapes[name.split(".", 3)[3]]
                p = torch.empty(like.shape, dtype=like.dtype, device=dev)
            init_param_(name, p, generator)

    def _stage_fn(self, stage: _Stage, act: torch.Tensor) -> torch.Tensor:
        return run_blocks(stage.layers.values(), act, None, stage.remat)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # The JAX stages run their blocks deterministic: no dropout.
        with dropout.deterministic():
            x = self.embed(ids)
            x = gpipe(self._stage_fn, self.stack, x, mesh=self.mesh, axis=self.axis,
                      num_microbatches=self.num_microbatches)
            x = self.ln_f(x)
            return self.lm_head(x).to(self.cfg.logits_dtype)
