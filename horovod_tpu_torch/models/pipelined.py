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

Inside a stage the JAX model leaves dp, sp and tp to GSPMD; here, with tp
> 1, the stage's blocks are the tp layers of ``models/transformer.py`` on
the rank's tp line (``parallel/tensor.py``: H/tp heads and d_ff/tp
features a rank, the row-parallel sums over tp), the token embedding is
the vocab-parallel lookup and the head is column-parallel, as in
``TransformerLM`` under tp. With sp > 1 the input is this rank's sequence
block: the positions count from its offset (``sp index · S_local``) and
each block attends over the rank's sp line through ``_attention_dispatch``
(the ring, Ulysses, Ulysses through flash, or dense and flash over the
gathered sequence), as ``TransformerLM`` under sp. A pp line fixes the
dp, sp and tp coordinates, so stage s of sp index j and tp rank t sends to
stage s + 1 of the same sp index and tp rank, and the ranks of an sp or
tp line run the same microbatches in the same order, each issuing its
ring rotations, Ulysses exchanges, sp gathers and tp sums for microbatch
t before its pp send of it (and, in backward, its remat recomputation's
exchanges and sums after its pp receive). Along ep a dense stage is
replicated: every ep rank runs the same tokens, as the JAX model does.

The forward is the JAX one: embed, ``parallel/pipeline.gpipe`` over the
stage's blocks (with ``cfg.remat``, each block recomputed in backward),
``ln_f``, the head, logits in ``cfg.logits_dtype``: the rank's (B, S/sp)
block of them, with tp > 1 its vocabulary shard (``shard_range(vocab, tp,
rank)``), the same on every rank of its pp line. pp combines with dp, ep,
sp (under every ``attn_impl``) and tp; sp and tp together under pp, and
the tied head, are not ported (ROADMAP A3).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import Mesh
from ..parallel.pipeline import gpipe, stage_layers
from ..parallel.sharding import PIPELINE_RULES
from ..parallel.tensor import check_tp_supported, mark_tensor_parallel
from . import dropout
from .transformer import (ColumnParallelDense, Embedder, LayerNorm, TransformerBlock,
                          TransformerConfig, init_param_, run_blocks, seq_offset)


class _Stage(nn.Module):
    """This rank's blocks, named by their global layer index, on the mesh's
    sp and tp lines."""

    def __init__(self, cfg: TransformerConfig, layers: range, device=None, mesh=None):
        super().__init__()
        self.remat = cfg.remat
        self.layers = nn.ModuleDict(
            {str(i): TransformerBlock(cfg, device=device, mesh=mesh) for i in layers})


class PipelinedLM(nn.Module):
    """``forward(ids)`` returns the (B, S, vocab) logits (with tp > 1 this
    rank's vocabulary shard of them), the same on every rank of a pp line;
    ``ids`` is the batch of this rank's dp coordinate, with sp > 1 its
    sequence block, and so are the logits. The model is built
    on ``device``, by default the mesh's (this rank's card, or the CPU of a
    gloo world)."""

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
        if mesh.shape.get(cfg.sp_axis, 1) > 1 and mesh.shape.get("tp", 1) > 1:
            raise NotImplementedError("PipelinedLM on a mesh with sp > 1 and tp > 1 is not "
                                      "ported (ROADMAP A3: pp x sp x tp); pp combines with "
                                      "dp, ep, sp and tp, but not with sp and tp at once")
        if cfg.logits_via_embedding:
            raise NotImplementedError("logits_via_embedding under pp is not ported (ROADMAP "
                                      "A3: the tied head on a cut embedding)")
        check_tp_supported(cfg, mesh)
        device = mesh.device if device is None else device
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.num_microbatches = num_microbatches
        self.layer_range = stage_layers(cfg.n_layers, S, mesh.coords[axis])
        self.embed = Embedder(cfg, device=device, mesh=mesh)
        self.stack = _Stage(cfg, self.layer_range, device=device, mesh=mesh)
        self.ln_f = LayerNorm(cfg.d_model, cfg, device=device)
        tp = self.embed.comm
        self.lm_head = ColumnParallelDense(cfg.d_model, len(self.embed.rows), cfg, bias=False,
                                           device=device, comm=tp)
        mark_tensor_parallel(self, cfg, tp)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """``TransformerLM``'s draws, in its parameter order, from
        ``generator``: the blocks of other stages are drawn at full shape
        into a scratch tensor and dropped, and a held tp-cut tensor is drawn
        whole and cut (``init_param_``), so every pp x tp layout of one seed
        holds the weights of the one unpipelined model."""
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
            x = self.embed(ids, seq_offset(self.cfg, self.mesh, ids.shape[1]))
            x = gpipe(self._stage_fn, self.stack, x, mesh=self.mesh, axis=self.axis,
                      num_microbatches=self.num_microbatches)
            x = self.ln_f(x)
            return self.lm_head(x).to(self.cfg.logits_dtype)
