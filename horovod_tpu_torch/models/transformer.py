"""GPT-2 causal LM and the BERT-shaped encoder in ``torch.nn`` (counterpart
of ``horovod_tpu/models/transformer.py:45-571``).

The numerics follow the flax model, so weights carried across with
``models/convert.py`` give the same logits:

* parameters in ``param_dtype`` (f32), compute in ``dtype`` (bf16 by
  default): each dense layer casts its input and its weights to ``dtype``;
* LayerNorm reduces in f32 with epsilon 1e-6, E[x^2] - E[x]^2 variance,
  and casts its output to ``dtype``;
* GELU is the tanh form (flax ``nn.gelu`` default);
* the token embedding is a lookup in f32 then a cast; positions, learned
  or (``learned_pos=False``) the fixed sinusoidal table, are added in
  ``dtype``;
* with ``logits_via_embedding`` the LM's head is the token embedding
  (``Embedder.attend``: no ``lm_head``);
* ``dropout_rate`` drops the FFN's output, where the JAX ``MlpBlock``
  does, in forwards run with ``deterministic=False`` under a dropout key
  (``models/dropout.py``; ``make_train_step(dropout=True)``);
* logits are cast to ``logits_dtype`` (f32 by default; the training path
  opts into bf16);
* ``remat`` recomputes each block's forward in backward
  (``run_blocks``); ``scan_layers`` changes only the JAX parameter layout
  that ``models/convert.py`` reads (``cfg.stacked``).

Attention is ``dense`` (the einsum path, scores materialised), ``flash``
(``ops/flash_attention.py``: the CUDA kernels on the card, their plain
version on the CPU), or the sequence-parallel ``ring``
(``parallel/ring.py``) and ``ulysses`` (``parallel/ulysses.py``, through
flash with ``sp_use_flash``), which run dense attention when the model's
mesh has no ``sp_axis`` or it has one member, as the JAX dispatch does
(``horovod_tpu/models/transformer.py:185-188``).

**The mesh.** A model built with ``mesh=`` (``parallel/mesh.py``) runs its
part of the JAX model's logical computation on this rank, as GSPMD runs it
there (``horovod_tpu/parallel/train.py`` cuts the batch over dp and, with
``shard_seq``, the sequence over sp; tokens are replicated over ep):

* with sp > 1 the inputs are this rank's sequence block; positions count
  from its offset (``sp index · S_local``); ``dense`` and ``flash``
  attention gather q, k, v and the mask along sp (backward: the
  reduce-scatter), attend over the whole sequence and keep the local rows;
* ``SwitchMoE`` (every ``moe_every``-th block when ``n_experts > 0``)
  holds this rank's ``n_experts / ep`` experts. Capacity, the slot order
  (a cumsum in global token order t = b·S + s) and the auxiliary loss are
  over the global batch: each rank's slot offsets are an exclusive prefix
  of the per-(row, expert) counts of every dp and sp rank (one all-gather
  of B_local x E ints a layer). Tokens are scattered to (expert, slot) by
  index (static shapes, no host sync: a token not dispatched here goes to
  a row that is dropped) into this rank's (E_local, C, D) expert input,
  which a SUM
  all-reduce over (dp, sp) completes (its slots are disjoint); outputs are
  gathered back by index, scaled by the gate, and a SUM all-reduce over ep
  (identity backward) completes them. The tokens and the gate enter the
  expert region through ``pvary`` over ep, whose backward sums there, so
  the replicated parameters' gradients are equal on every ep rank.
  ``dispatch_combine_einsum`` is the JAX one-hot formulation
  (``:339-368``), the plain version the index form is held against;
* with tp > 1 (``parallel/tensor.py``) a rank holds its tp shard of the
  qkv projection (H/tp heads of q, k and v) and of ``mlp.wi``, both
  column-parallel, of ``attn.out`` and ``mlp.wo``, both row-parallel, and
  of the vocabulary in the token embedding and the head. Attention (dense
  or flash) runs on the H/tp local heads. The LayerNorms, the positions
  and the row-parallel biases are replicated. The logits are this rank's
  vocabulary shard, which ``parallel/tensor.vocab_parallel_xent`` takes.
  tp combines with dp and with sp: under sp every attention takes the
  H/tp local heads over the sp line (the ring rotates their K/V blocks,
  Ulysses exchanges them, which needs ``(n_heads / tp) % sp == 0``, dense
  and flash gather them), as the JAX dispatch manualizes sp beside tp.
  A ``SwitchMoE`` under tp holds each of its experts' d_ff cut over tp
  (the JAX "expert_mlp" axis; with ep, a tp shard of each of its E/ep
  experts): the router is replicated and runs on every tp rank, the
  experts' partial outputs are summed over tp in the compute dtype (as
  ``RowParallel`` sums), and the tokens enter the expert region through
  ``pvary`` over ep and tp together, so that backward sums each rank's
  share of their cotangent. Routing is identical on every rank of a tp
  line: the router reads the same bits there, the row-parallel sums'
  output. Under pp the same tp layers make ``PipelinedLM``'s stages
  (``models/pipelined.py``). On a tp line of one member (or no mesh) the
  tp layers are the plain ones, bit for bit;
* under ``rules=FSDP_RULES`` with dp > 1 (``parallel/fsdp.py``) a rank
  holds its dp shard of every parameter with a d_model dimension, along
  that dimension, beside its tp cut; each layer gathers the full parameter
  over dp where it uses it (``gathered``), inside the remat block, and the
  gather's backward reduce-scatters the gradient. Under sp the shard is
  replicated over the sp line: the positions of a sequence block index the
  gathered position table, and every attention route takes q, k and v from
  the gathered ``attn.qkv`` weight and bias, so each sp member's
  reduce-scatter carries its block's whole gradient, which the optimizer
  then sums over sp. A ``SwitchMoE`` under FSDP holds its router's and its
  E/ep experts' dp shard along D and gathers them where it routes and runs
  the experts (the router through ``Dense``); the gather's reduce-scatter
  sums each expert's gradient, which covers the slots of the rank's own
  tokens, over dp, and the optimizer sums it over sp, never over ep.
  FSDP combines with dp, ep, tp, sp and experts; with pp, experts under
  tp > 1, or sp and tp together, it raises ``NotImplementedError``
  (``check_fsdp_supported``). ``rules`` is ``DEFAULT_RULES`` by default;
  ``PipelinedLM`` holds ``PIPELINE_RULES``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..common import basics
from . import dropout
from ..ops.flash_attention import flash_attention
from ..parallel.collectives import all_gather, psum, pvary
from ..parallel.fsdp import NOT_PORTED, check_fsdp_supported, gathered, mark_fsdp
from ..parallel.mesh import Comm
from ..parallel.sharding import DEFAULT_RULES, FSDP_RULES, mesh_axes
from ..parallel.tensor import (ColumnParallel, RowParallel, check_tp_supported,
                               mark_tensor_parallel, shard_range, tp_comm,
                               vocab_parallel_embedding)


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
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    causal: bool = True
    # MoE: every `moe_every`-th block uses a Switch FFN with n_experts.
    n_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    logits_dtype: torch.dtype = torch.float32
    # "dense", "flash", or the sequence-parallel "ring" / "ulysses".
    attn_impl: str = "dense"
    sp_axis: str = "sp"
    # With attn_impl="ulysses": the per-head-group attention through flash.
    sp_use_flash: bool = False
    # Recompute each block's forward in backward (``nn.remat`` in JAX).
    remat: bool = False
    # The JAX scan-stacked parameter layout (``stack/layers``, a leading L
    # axis on every leaf) for a dense-FFN stack: what ``models/convert.py``
    # reads and ``PipelinedLM`` needs. The modules stay one per layer.
    scan_layers: bool = False
    # The LM's head is the token embedding (no lm_head).
    logits_via_embedding: bool = False
    # Learned positions, or the fixed sinusoidal table.
    learned_pos: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def stacked(self) -> bool:
        """Whether the JAX model scan-stacks its layers: ``scan_layers`` with
        a dense FFN (``horovod_tpu/models/transformer.py:474``); with experts
        it keeps ``stack/layer_{i}``."""
        return self.scan_layers and self.n_experts == 0


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


ATTN_IMPLS = ("dense", "flash", "ring", "ulysses")


def _sp_comm(cfg: TransformerConfig, mesh):
    """The model's sp line, or None where the mesh has no such axis or it
    has one member."""
    if mesh is None or cfg.sp_axis not in mesh.axis_names \
            or mesh.shape[cfg.sp_axis] == 1:
        return None
    return mesh.comm(cfg.sp_axis)


def seq_offset(cfg: TransformerConfig, mesh, s_local: int) -> int:
    """The global position of this rank's first column: ``sp index ·
    S_local`` on the model's sp line, 0 without one."""
    comm = _sp_comm(cfg, mesh)
    return 0 if comm is None else comm.rank * s_local


def _local_attention(cfg: TransformerConfig, q, k, v, mask):
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, mask, causal=cfg.causal).to(cfg.dtype)
    return _dense_attention_masked(cfg, q, k, v, mask)


def _attention_dispatch(cfg: TransformerConfig, q, k, v, mask, mesh=None):
    """Dense, flash, or the sequence-parallel kernels over the mesh's sp
    line, on the heads this rank holds (H/tp under tp). Under sp, dense and
    flash attend over the gathered sequence and keep this rank's rows, the
    logical result GSPMD gives; ring and Ulysses without an sp line fall
    back to dense, as in JAX."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r}: one of {ATTN_IMPLS}")
    comm = _sp_comm(cfg, mesh)
    if comm is None:
        if cfg.attn_impl in ("ring", "ulysses"):
            return _dense_attention_masked(cfg, q, k, v, mask)
        return _local_attention(cfg, q, k, v, mask)
    if cfg.attn_impl == "ring":
        from ..parallel.ring import ring_attention

        return ring_attention(q, k, v, comm, causal=cfg.causal, mask=mask)
    if cfg.attn_impl == "ulysses":
        from ..parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, comm, causal=cfg.causal, mask=mask,
                                 use_flash=cfg.sp_use_flash)
    q, k, v = (all_gather(t, comm, dim=1, name="hvd.sp.all_gather") for t in (q, k, v))
    if mask is not None:
        mask = all_gather(mask.detach(), comm, dim=1, name="hvd.sp.all_gather")
    out = _local_attention(cfg, q, k, v, mask)
    return out.chunk(comm.size, dim=1)[comm.rank]


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

    def params_at_use(self):
        """The weight and the bias, gathered over dp where FSDP cuts them."""
        return gathered(self.weight), None if self.bias is None else gathered(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        weight, bias = self.params_at_use()
        return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


class ColumnParallelDense(ColumnParallel, Dense):
    """``Dense`` over this rank's output features (``comm=`` the tp line)."""


class RowParallelDense(RowParallel, Dense):
    """``Dense`` over this rank's input features (``comm=`` the tp line);
    the bias is added once, after the sum over tp."""


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
        mul = torch.rsqrt(var + self.eps) * gathered(self.weight).float()
        return ((xf - mean) * mul + gathered(self.bias).float()).to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Fused qkv projection laid out (3, H, Hd) as the flax DenseGeneral
    kernel is; q, k, v are strided views of its output, which the flash
    kernels read in place. Under tp it holds ``H / tp`` heads of each of q,
    k and v (column-parallel) and the matching rows of ``out``
    (row-parallel)."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        comm = tp_comm(mesh)
        self.n_local = cfg.n_heads // comm.size
        HHd = self.n_local * cfg.head_dim
        self.qkv = ColumnParallelDense(cfg.d_model, 3 * HHd, cfg, device=device, comm=comm)
        self.out = RowParallelDense(HHd, cfg.d_model, cfg, device=device, comm=comm)

    def forward(self, x, mask=None):
        cfg = self.cfg
        B, S, _ = x.shape
        qkv = self.qkv(x).view(B, S, 3, self.n_local, cfg.head_dim)
        q, k, v = qkv.unbind(dim=2)                        # (B, S, H / tp, Hd)
        ctx = _attention_dispatch(cfg, q, k, v, mask, self.mesh)
        return self.out(ctx.reshape(B, S, self.n_local * cfg.head_dim))


class MlpBlock(nn.Module):
    """d_model -> d_ff (column-parallel under tp) -> d_model (row-parallel),
    then dropout where ``dropout_rate`` > 0 (after the sum over tp: every
    rank of a tp line drops the same elements)."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        comm = tp_comm(mesh)
        d_ff = len(shard_range(cfg.d_ff, comm.size, comm.rank))
        self.wi = ColumnParallelDense(cfg.d_model, d_ff, cfg, device=device, comm=comm)
        self.wo = RowParallelDense(d_ff, cfg.d_model, cfg, device=device, comm=comm)
        self.dropout = dropout.Dropout(cfg.dropout_rate) if cfg.dropout_rate > 0 else None

    def forward(self, x):
        h = self.wo(F.gelu(self.wi(x), approximate="tanh"))
        return h if self.dropout is None else self.dropout(h)


def _lines(mesh):
    """The (dp, sp) line, the ep line and the (ep, tp) line of ``mesh``
    (one-member lines for absent axes), and the dp and sp sizes."""
    if mesh is None:
        if basics.is_initialized() and basics.size() > 1:
            raise ValueError("SwitchMoE on a world of more than one rank needs the "
                             "mesh (make_model(mesh=...)): capacity and the slot "
                             "order are over the global batch")
        one = Comm(None, 1, 0, (0,))
        return one, one, one, 1, 1
    present = lambda axes: tuple(a for a in axes if a in mesh.axis_names)  # noqa: E731
    return (mesh.comm(present(("dp", "sp"))), mesh.comm(present(("ep",))),
            mesh.comm(present(("ep", "tp"))), mesh.shape.get("dp", 1),
            mesh.shape.get("sp", 1))


def dispatch_combine_einsum(tokens, expert_idx, gate, pos, keep, n_experts: int,
                            capacity: int, experts, dtype):
    """The JAX one-hot formulation (``horovod_tpu/models/transformer.py:
    339-368``) on one rank's tokens: ``(expert_in, out)`` from the (T, E, C)
    dispatch tensor, ``expert_in = einsum("td,tec->ecd")``, ``experts`` (a
    function of the (E, C, D) expert input) and the combine einsum with the
    gate in ``dtype``. The plain version ``SwitchMoE``'s index form is held
    against."""
    dispatch = (F.one_hot(expert_idx, n_experts).to(dtype)[:, :, None]
                * F.one_hot(torch.where(keep, pos, capacity), capacity + 1)[:, :capacity]
                .to(dtype)[:, None, :])
    expert_in = torch.einsum("td,tec->ecd", tokens.to(dtype), dispatch)
    expert_out = experts(expert_in)
    combine = dispatch * gate.to(dtype)[:, None, None]
    return expert_in, torch.einsum("ecd,tec->td", expert_out, combine)


def dispatch_by_index(tokens, slots, n_local: int, capacity: int):
    """This rank's (n_local, C, D) expert input: token t written to its flat
    (expert, slot) index ``slots[t]``, zeros elsewhere. A token dispatched
    to no slot here has ``slots[t] == n_local · C``, a row that is dropped.
    No host sync: every shape is static."""
    buf = tokens.new_zeros(n_local * capacity + 1, tokens.shape[-1])
    return buf.index_copy(0, slots, tokens)[:-1].view(n_local, capacity, -1)


def combine_by_index(expert_out, slots, gate):
    """(T, D): token t's expert output at ``slots[t]`` times its gate in the
    output dtype (one bf16 rounding, as the combine einsum's one non-zero
    term); zeros for ``slots[t] == n_local · C``."""
    flat = expert_out.reshape(-1, expert_out.shape[-1])
    flat = torch.cat([flat, flat.new_zeros(1, flat.shape[-1])])
    return flat.index_select(0, slots) * gate.to(expert_out.dtype)[:, None]


class SwitchMoE(nn.Module):
    """Switch-transformer top-1 MoE FFN with static capacity (counterpart of
    ``horovod_tpu/models/transformer.py:307-375``), over this rank's
    ``n_experts / ep`` experts, each of their d_ff cut over tp; see the
    module docstring for the layout. After each forward ``aux`` holds the
    load-balancing loss ``E · Σ density · density_proxy`` over the global
    batch (what the JAX block sows as ``moe_aux``), ``dropped`` the global
    count of tokens past capacity (a 0-d int64 tensor) and ``expert_idx``
    each local token's expert (the routes)."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        E = cfg.n_experts
        self.cfg, self.mesh = cfg, mesh
        self.data, self.ep, self.ep_tp, self.dp, self.sp = _lines(mesh)
        self.tp = tp_comm(mesh)
        if E % self.ep.size:
            raise ValueError(f"n_experts={E} must be divisible by ep={self.ep.size}")
        self.n_local = E // self.ep.size
        self.first = self.ep.rank * self.n_local
        d_ff = len(shard_range(cfg.d_ff, self.tp.size, self.tp.rank))
        self.router = Dense(cfg.d_model, E, cfg, bias=False, device=device)
        self.wi = nn.Parameter(torch.empty(self.n_local, cfg.d_model, d_ff,
                                           dtype=cfg.param_dtype, device=device))
        self.wo = nn.Parameter(torch.empty(self.n_local, d_ff, cfg.d_model,
                                           dtype=cfg.param_dtype, device=device))
        for p in (self.wi, self.wo):
            p.expert_parallel = (self.first, E)   # this rank's slice of E experts
        self.aux = None
        self.dropped = None
        self.expert_idx = None

    def experts(self, expert_in):
        """The experts' output on this rank's tp shard of their d_ff,
        summed over tp (in the compute dtype, each partial product rounded
        before the sum). Under FSDP the experts' D is gathered over dp
        here, inside the remat block."""
        dt = self.cfg.dtype
        h = torch.einsum("ecd,edf->ecf", expert_in, gathered(self.wi).to(dt))
        h = F.gelu(h, approximate="tanh")
        return psum(torch.einsum("ecf,efd->ecd", h, gathered(self.wo).to(dt)), self.tp,
                    grad="identity", name="hvd.tp.expert_psum")

    def route(self, x):
        """Router, top-1 choice, global slot positions: (tokens, probs,
        expert_idx, gate, pos, keep, capacity, per-expert global counts,
        the global batch's token count)."""
        cfg = self.cfg
        dp, sp = self.dp, self.sp
        Bl, Sl, D = x.shape
        E = cfg.n_experts
        T = Bl * dp * Sl * sp
        C = max(1, int(cfg.capacity_factor * T / E))
        tokens = x.reshape(Bl * Sl, D)
        with ops.span("hvd.moe.router"):
            probs = torch.softmax(self.router(tokens).float(), dim=-1)
            expert_idx = probs.argmax(dim=-1)
            gate = probs.gather(-1, expert_idx[:, None])[:, 0]
            # A comparison, not F.one_hot, whose range check syncs the host.
            onehot = (expert_idx[:, None] == torch.arange(E, device=x.device)).long()
            onehot = onehot.view(Bl, Sl, E)
            counts = onehot.sum(dim=1)                              # (Bl, E)
            # Every (dp, sp) rank's counts, (dp, sp, Bl, E) in line order,
            # as (global row, sp block) rows: a slot's offset is the
            # exclusive prefix over the rows before this rank's.
            every = all_gather(counts[None], self.data, dim=0, name="hvd.moe.all_gather")
            every = every.view(dp, sp, Bl, E).transpose(1, 2).reshape(dp * Bl * sp, E)
            d, s = divmod(self.data.rank, sp)
            rows = (d * Bl + torch.arange(Bl, device=x.device)) * sp + s
            offset = (every.cumsum(dim=0) - every)[rows]
            total = every.sum(dim=0)
            within = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1     # (Bl, Sl)
            pos = (offset.gather(1, expert_idx.view(Bl, Sl)) + within).reshape(-1)
            keep = pos < C
        return tokens, probs, expert_idx, gate, pos, keep, C, total, T

    def forward(self, x):
        cfg = self.cfg
        tokens, probs, expert_idx, gate, pos, keep, C, total, T = self.route(x)
        # The load-balancing loss over the global batch (Switch eq. 4).
        density = total.float() / T
        proxy = psum(probs.sum(dim=0), self.data, name="hvd.moe.psum")
        aux = cfg.n_experts * torch.sum(density * (proxy / T))
        if not _RECOMPUTING.get():
            # Under remat backward runs this forward again: its aux would
            # keep the recomputed block's activations alive through its graph.
            self.aux = aux
            self.dropped = (total - C).clamp_min(0).sum()
            self.expert_idx = expert_idx.detach()
        # Each ep rank's experts, and each tp rank's d_ff shard of them,
        # give their share of the tokens' cotangent; the gate's, over ep
        # alone (every tp rank combines the whole expert output alike).
        tok = pvary(tokens.to(cfg.dtype), self.ep_tp, name="hvd.ep.pvary")
        g = pvary(gate, self.ep, name="hvd.ep.pvary")
        sel = keep & (expert_idx >= self.first) & (expert_idx < self.first + self.n_local)
        slots = torch.where(sel, (expert_idx - self.first) * C + pos, self.n_local * C)
        with ops.span("hvd.moe.dispatch"):
            expert_in = psum(dispatch_by_index(tok, slots, self.n_local, C), self.data,
                             name="hvd.moe.psum")
        with ops.span("hvd.moe.experts"):
            expert_out = self.experts(expert_in)
        with ops.span("hvd.moe.combine"):
            out = psum(combine_by_index(expert_out, slots, g), self.ep, grad="identity",
                       name="hvd.ep.psum")
        return out.view(x.shape)


def uses_moe(cfg: TransformerConfig, i: int) -> bool:
    """Whether block ``i`` takes the Switch FFN (the JAX stack's rule)."""
    return cfg.n_experts > 0 and cfg.moe_every > 0 and i % cfg.moe_every == cfg.moe_every - 1


class TransformerBlock(nn.Module):
    """Pre-LN block; ``use_moe`` swaps the FFN for ``SwitchMoE`` (named
    ``moe``, as in the flax tree)."""

    def __init__(self, cfg: TransformerConfig, device=None, use_moe: bool = False,
                 mesh=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg, device=device)
        self.attn = MultiHeadAttention(cfg, device=device, mesh=mesh)
        self.ln2 = LayerNorm(cfg.d_model, cfg, device=device)
        if use_moe:
            self.moe = SwitchMoE(cfg, device=device, mesh=mesh)
        else:
            self.mlp = MlpBlock(cfg, device=device, mesh=mesh)
        self.ffn_name = "moe" if use_moe else "mlp"

    def forward(self, x, mask=None):
        h = x + self.attn(self.ln1(x), mask)
        return h + getattr(self, self.ffn_name)(self.ln2(h))


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """The fixed position table (a copy of the JAX function,
    ``horovod_tpu/models/transformer.py:417``)."""
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class Embedder(nn.Module):
    """Token and position embeddings; under tp the token table holds this
    rank's vocabulary rows (``vocab_parallel_embedding``). Without
    ``learned_pos`` the positions are the sinusoidal table, a buffer that
    is not part of the ``state_dict``."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.comm = tp_comm(mesh)
        self.rows = shard_range(cfg.vocab_size, self.comm.size, self.comm.rank)
        self.embedding = nn.Parameter(torch.empty(
            len(self.rows), cfg.d_model, dtype=cfg.param_dtype, device=device))
        if cfg.learned_pos:
            self.pos_embedding = nn.Parameter(torch.empty(
                cfg.max_len, cfg.d_model, dtype=cfg.param_dtype, device=device))
        else:
            self.register_buffer("pos_table", torch.from_numpy(
                sinusoidal_positions(cfg.max_len, cfg.d_model)).to(device), persistent=False)

    def forward(self, ids, offset: int = 0):
        """``offset``: the global position of ``ids``' first column (a
        sequence-parallel rank's block starts at ``sp index · S_local``)."""
        x = vocab_parallel_embedding(ids, gathered(self.embedding), self.rows.start,
                                     self.comm).to(self.dtype)
        table = (gathered(self.pos_embedding) if hasattr(self, "pos_embedding")
                 else self.pos_table)
        pos = table[offset: offset + ids.shape[1]]
        return x + pos.to(self.dtype)[None]

    def attend(self, x):
        """Logits against the token table (the tied head), in ``x``'s dtype."""
        return F.linear(x, self.embedding.to(x.dtype))


# True while remat recomputes a block's forward in backward.
_RECOMPUTING = contextvars.ContextVar("recomputing", default=False)


@contextlib.contextmanager
def _recomputing():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


@contextlib.contextmanager
def _recompute_under(key):
    with _recomputing():
        if key is None:
            with dropout.deterministic():
                yield
        else:
            with dropout.dropout_key(*key):
                yield


def run_blocks(blocks, x, mask=None, remat: bool = False):
    """``x`` through ``blocks`` in order. With ``remat`` each block's forward
    runs again in backward (``torch.utils.checkpoint``, non-reentrant),
    which keeps only the blocks' inputs between forward and backward, as
    ``nn.remat(TransformerBlock)`` does. The recomputation runs under the
    forward's dropout key, so it redraws the forward's masks and the
    gradients are unchanged; it leaves the state a block keeps of its
    forward (``SwitchMoE``'s ``aux``, ``dropped`` and routes) as the
    forward set it."""
    from torch.utils.checkpoint import checkpoint

    key = dropout.current_key()

    def contexts():
        return contextlib.nullcontext(), _recompute_under(key)

    for block in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, mask, use_reentrant=False, context_fn=contexts)
        else:
            x = block(x, mask)
    return x


class TransformerStack(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        self.remat = cfg.remat
        self.layers = nn.ModuleList(
            TransformerBlock(cfg, device=device, use_moe=uses_moe(cfg, i), mesh=mesh)
            for i in range(cfg.n_layers))

    def forward(self, x, mask=None):
        return run_blocks(self.layers, x, mask, self.remat)


@torch.no_grad()
def init_param_(name: str, p: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """One parameter's flax initialiser, by its name in the model (see
    ``_Transformer.init_weights``). The draws of a model's parameters, taken
    in ``named_parameters`` order from one generator, make its weights."""
    if name.endswith(".bias"):
        p.zero_()
    elif ".ln" in name or name.startswith("ln_f"):
        p.fill_(1.0)
    elif any(hasattr(p, a) for a in ("expert_parallel", "tensor_parallel")) \
            or getattr(p, "fsdp", None) is not None:
        # Draw the whole tensor (all E experts) and keep this rank's ep
        # slice, then its tp and dp shards (along other dimensions), so
        # that every ep, tp and dp layout of one seed holds the same weights.
        cuts = [c for c in (getattr(p, "tensor_parallel", None), getattr(p, "fsdp", None))
                if c is not None]
        shape = p.shape
        for cut in cuts:
            shape = cut.full_shape(shape)
        expert = getattr(p, "expert_parallel", None)
        if expert is not None:
            shape = (expert[1], *shape[1:])
        full = torch.empty(shape, dtype=p.dtype, device=p.device)
        full.normal_(0.0, INIT_STD, generator=generator)
        if expert is not None:
            full = full[expert[0]: expert[0] + p.shape[0]]
        for cut in cuts:
            full = cut.take(full)
        p.copy_(full)
    else:
        p.normal_(0.0, INIT_STD, generator=generator)


class _Transformer(nn.Module):
    """Embedder, pre-LN stack, final LayerNorm and a bias-free vocabulary
    head named ``HEAD`` (for the LM with ``logits_via_embedding``, the token
    embedding, ``Embedder.attend``; under tp > 1 or FSDP that raises
    ``NotImplementedError``, ROADMAP A3). ``forward(ids, mask=None,
    deterministic=True)`` returns (B, S, vocab) logits in
    ``cfg.logits_dtype``; ``deterministic=False`` runs dropout under the
    caller's ``dropout_key``. With a mesh of sp > 1, ``ids`` and
    ``mask`` are this rank's sequence block and so are the logits; with
    tp > 1 the logits are this rank's vocabulary shard
    (``shard_range(vocab, tp, rank)``).
    ``moe_aux_loss()`` sums the MoE blocks' auxiliary losses of the last
    forward, ``moe_dropped()`` their dropped-token counts. ``rules`` is
    ``DEFAULT_RULES`` or ``FSDP_RULES`` (``parallel/sharding.py``)."""

    HEAD = ""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 rules=DEFAULT_RULES):
        super().__init__()
        if rules not in (DEFAULT_RULES, FSDP_RULES):
            raise ValueError("the transformer takes rules=DEFAULT_RULES or FSDP_RULES "
                             "(PipelinedLM holds PIPELINE_RULES)")
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        embed = mesh_axes("embed", rules, mesh) if mesh is not None else ()
        if embed:
            check_fsdp_supported(cfg, mesh)
        check_tp_supported(cfg, mesh)
        dp = mesh.comm(embed) if embed else Comm(None, 1, 0, (0,))
        self.embed = Embedder(cfg, device=device, mesh=mesh)
        self.stack = TransformerStack(cfg, device=device, mesh=mesh)
        self.ln_f = LayerNorm(cfg.d_model, cfg, device=device)
        tp = self.embed.comm
        # The JAX encoder keeps its mlm_head whatever logits_via_embedding says.
        self.tied = cfg.logits_via_embedding and self.HEAD == "lm_head"
        if self.tied and (tp.size > 1 or dp.size > 1):
            raise NotImplementedError(
                "logits_via_embedding under tp > 1 or FSDP_RULES is not ported (ROADMAP A3: "
                "the tied head on a cut embedding)")
        if not self.tied:
            self.add_module(self.HEAD, ColumnParallelDense(
                cfg.d_model, len(self.embed.rows), cfg, bias=False, device=device, comm=tp))
        mark_tensor_parallel(self, cfg, tp)
        mark_fsdp(self, cfg, dp)
        dropout.number_sites(self)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The flax initialisers: normal(0.02) for embeddings and dense
        kernels, zeros for biases, ones for LayerNorm scales. Draws from
        ``generator`` (which must live on the parameters' device)."""
        for name, p in self.named_parameters():
            init_param_(name, p, generator)

    def seq_offset(self, s_local: int) -> int:
        return seq_offset(self.cfg, self.mesh, s_local)

    def moe_blocks(self):
        return [layer.moe for layer in self.stack.layers if hasattr(layer, "moe")]

    def moe_aux_loss(self):
        blocks = self.moe_blocks()
        return sum(b.aux for b in blocks) if blocks else None

    def moe_dropped(self):
        return [b.dropped for b in self.moe_blocks()]

    def forward(self, ids, mask=None, deterministic: bool = True):
        with dropout.scope(self, deterministic):
            x = self.embed(ids, self.seq_offset(ids.shape[1]))
            x = self.stack(x, mask)
            x = self.ln_f(x)
            logits = self.embed.attend(x) if self.tied else getattr(self, self.HEAD)(x)
        return logits.to(self.cfg.logits_dtype)


class TransformerLM(_Transformer):
    """Decoder-only causal LM, the GPT-2 shape."""

    HEAD = "lm_head"


class TransformerEncoder(_Transformer):
    """Bidirectional encoder with an MLM head, the BERT shape: attention is
    never causal, whatever ``cfg.causal`` says. It takes no ``FSDP_RULES``
    (ROADMAP A3)."""

    HEAD = "mlm_head"

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 rules=DEFAULT_RULES):
        if rules is FSDP_RULES:
            raise NotImplementedError(f"FSDP_RULES on TransformerEncoder is not ported "
                                      f"({NOT_PORTED})")
        super().__init__(dataclasses.replace(cfg, causal=False), device=device,
                         generator=generator, mesh=mesh, rules=rules)
