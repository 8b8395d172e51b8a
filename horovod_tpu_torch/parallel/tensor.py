"""Tensor parallelism over the tp mesh axis: what GSPMD derives from the tp
rows of the JAX package's rule table (``horovod_tpu/parallel/sharding.py:
24-36``), written out as modules and collectives. The JAX file has no
counterpart of this one: there a rule places a parameter and XLA inserts
the all-reduces.

Rule by rule (the logical axes of ``horovod_tpu/models/transformer.py``):

* ``("heads", "tp")``: the attention's qkv kernel ``(embed, None, heads,
  kv)`` is column-parallel by head inside its (3, H, Hd) layout (rank r
  holds heads ``[r·H/tp, (r+1)·H/tp)`` of q, k and v, and their biases);
  the out kernel ``(heads, kv, embed)`` is row-parallel. Attention runs on
  the local heads, as the JAX model's ``shard_map`` over tp runs flash
  (``:140-181``).
* ``("mlp", "tp")``: ``MlpBlock.wi`` ``(embed, mlp)`` is column-parallel,
  ``wo`` ``(mlp, embed)`` row-parallel.
* ``("vocab", "tp")``: the token embedding ``(vocab, embed)`` is a
  vocab-parallel lookup; the head ``(embed, vocab)`` is column-parallel and
  returns this rank's vocabulary shard of the logits; the loss over those
  shards is ``vocab_parallel_xent``.
* ``("expert_mlp", "tp")``: every Switch expert's ``wi`` ``(expert, embed,
  expert_mlp)`` is column-parallel along its d_ff, ``wo`` ``(expert,
  expert_mlp, embed)`` row-parallel, beside the "expert" cut over ep
  (``models/transformer.py`` ``SwitchMoE``): a rank computes its partial
  expert output, which a sum over tp completes, where GSPMD puts the
  all-reduce of ``einsum("ecf,efd->ecd")`` over a tp-cut ``f``.

A **column-parallel** ``Dense`` holds this rank's output features; its
input passes through ``pvary`` over tp (identity forward, all-reduce
backward), since every rank consumes the replicated input for its own
features. A **row-parallel** ``Dense`` holds this rank's input features;
its partial product is summed by ``psum(..., grad="identity")`` (each rank
then consumes the complete sum alike, so the cotangent is not summed
again) and its bias, replicated, is added once after the sum. Both sums
run on the partial products in the compute dtype, rounded before the sum,
as GSPMD's partitioned dot and all-reduce round them. On a line of one
member both are the plain ``Dense``, bit for bit.

Shards follow the JAX split of an uneven dimension: units ``[r·⌈n/tp⌉,
min(n, (r+1)·⌈n/tp⌉))``, the last shard short (GPT-2's vocabulary of 50257
at tp=2 or 4). Nothing is padded, so no padded column enters the softmax
and no padded row gets a gradient. ``TP_PARAMS`` names every tp-cut
parameter by its place in the model; ``tp_cut`` gives its ``TPCut``, which
the model marks on the parameter (``tensor_parallel``), ``init_param_``
draws through (the full tensor drawn, this rank's slice kept, so every tp
layout of one seed holds world-1's weights) and ``models/convert.py`` cuts
and joins the JAX parameters with.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import ops
from .collectives import psum, pvary
from .mesh import Comm

SPAN = "hvd.tp"

# A parameter's name in the model (its last components) -> (logical axis,
# the torch tensor's cut dimension, a leading factor of that dimension kept
# whole: q, k and v of the fused qkv projection).
TP_PARAMS: Dict[str, Tuple[str, int, int]] = {
    "attn.qkv.weight": ("heads", 0, 3),
    "attn.qkv.bias": ("heads", 0, 3),
    "attn.out.weight": ("heads", 1, 1),
    "mlp.wi.weight": ("mlp", 0, 1),
    "mlp.wi.bias": ("mlp", 0, 1),
    "mlp.wo.weight": ("mlp", 1, 1),
    "moe.wi": ("expert_mlp", 2, 1),     # (E / ep, D, F)
    "moe.wo": ("expert_mlp", 1, 1),     # (E / ep, F, D)
    "embed.embedding": ("vocab", 0, 1),
    "lm_head.weight": ("vocab", 0, 1),
    "mlm_head.weight": ("vocab", 0, 1),
}


def shard_range(n: int, tp: int, rank: int) -> range:
    """Rank ``rank``'s units of ``n`` over ``tp``: ``[r·⌈n/tp⌉, min(n,
    (r+1)·⌈n/tp⌉))``, the JAX split with the last shard short. Raises where
    the rank would hold none."""
    per = -(-n // tp)
    start, stop = min(n, rank * per), min(n, (rank + 1) * per)
    if start >= stop:
        raise ValueError(f"{n} units over tp={tp} leave rank {rank} none")
    return range(start, stop)


@dataclasses.dataclass(frozen=True)
class TPCut:
    """Where a tp rank's shard lies in the full tensor: dimension ``dim``
    is ``groups · n · unit`` long, and the rank holds units ``[start,
    stop)`` of the n in each group (heads of head dim ``unit`` in each of
    q, k, v; features; vocabulary rows)."""

    logical: str
    dim: int
    groups: int
    n: int
    unit: int
    tp: int
    rank: int

    @property
    def units(self) -> range:
        return shard_range(self.n, self.tp, self.rank)

    def full_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        out[self.dim] = self.groups * self.n * self.unit
        return tuple(out)

    def local_size(self) -> int:
        return self.groups * len(self.units) * self.unit

    def _split(self, t: torch.Tensor, n: int) -> torch.Tensor:
        d = self.dim
        return t.reshape(*t.shape[:d], self.groups, n, self.unit, *t.shape[d + 1:])

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``."""
        d, units = self.dim, self.units
        part = self._split(full, self.n).narrow(d + 1, units.start, len(units))
        return part.reshape(*full.shape[:d], -1, *full.shape[d + 1:])

    def join(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The full tensor from every tp rank's shard, in rank order."""
        d = self.dim
        parts = [self._split(s, s.shape[d] // (self.groups * self.unit)) for s in shards]
        full = torch.cat(parts, dim=d + 1)
        return full.reshape(*shards[0].shape[:d], -1, *shards[0].shape[d + 1:])


def tp_cut(name: str, cfg, tp: int, rank: int) -> Optional[TPCut]:
    """The cut of the model parameter ``name`` (a ``state_dict`` key of
    ``TransformerLM``/``TransformerEncoder``) on tp rank ``rank`` of ``tp``,
    or None for a replicated one."""
    for suffix, (logical, dim, groups) in TP_PARAMS.items():
        if name == suffix or name.endswith("." + suffix):
            n, unit = {"heads": (cfg.n_heads, cfg.head_dim), "mlp": (cfg.d_ff, 1),
                       "expert_mlp": (cfg.d_ff, 1), "vocab": (cfg.vocab_size, 1)}[logical]
            return TPCut(logical, dim, groups, n, unit, tp, rank)
    return None


def tp_comm(mesh) -> Comm:
    """The mesh's tp line; one member where there is no mesh or no tp axis."""
    if mesh is None or "tp" not in mesh.axis_names:
        return Comm(None, 1, 0, (0,))
    return mesh.comm("tp")


def check_tp_supported(cfg, mesh) -> None:
    """The checks of a model under tp > 1: the heads split over tp. tp
    combines with dp, sp, ep and pp (``PipelinedLM``'s stages), under every
    ``attn_impl`` and with Switch experts (each expert's d_ff cut over tp);
    Ulysses then exchanges the H/tp local heads over the sp line, so they
    must split over it."""
    tp = tp_comm(mesh).size
    if tp == 1:
        return
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} must be divisible by tp={tp}")
    sp = mesh.shape.get(cfg.sp_axis, 1)
    if cfg.attn_impl == "ulysses" and (cfg.n_heads // tp) % sp:
        raise ValueError(f"Ulysses under tp: the {cfg.n_heads // tp} local heads "
                         f"(n_heads={cfg.n_heads} / tp={tp}) must be divisible by sp={sp}")


def mark_tensor_parallel(model: torch.nn.Module, cfg, comm: Comm) -> None:
    """Mark each tp-cut parameter of ``model`` with its ``TPCut``
    (``tensor_parallel``), checking that the module holds that shard along
    the cut dimension (an expert weight's first dimension is its ep
    slice)."""
    if comm.size == 1:
        return
    for name, p in model.named_parameters():
        cut = tp_cut(name, cfg, comm.size, comm.rank)
        if cut is None:
            continue
        if p.shape[cut.dim] != cut.local_size():
            raise AssertionError(f"{name}: shape {tuple(p.shape)}, tp cut {cut}")
        p.tensor_parallel = cut


class _OnTP:
    def __init__(self, *args, comm: Comm, **kwargs):
        super().__init__(*args, **kwargs)
        self.comm = comm


class ColumnParallel(_OnTP):
    """Mixed into a ``Dense`` (``models/transformer.py``): it holds this
    rank's output features; ``comm`` is the tp line. Its input enters
    through ``pvary``."""

    def forward(self, x):
        return super().forward(pvary(x, self.comm, name=f"{SPAN}.pvary"))


class RowParallel(_OnTP):
    """Mixed into a ``Dense``: it holds this rank's input features; ``comm``
    is the tp line. The partial products are summed over tp, then the bias
    is added."""

    def forward(self, x):
        if self.comm.size == 1:
            return super().forward(x)
        dt = self.compute_dtype
        weight, bias = self.params_at_use()     # gathered over dp under FSDP
        y = psum(F.linear(x.to(dt), weight.to(dt)), self.comm, grad="identity",
                 name=f"{SPAN}.psum")
        return y if bias is None else y + bias.to(dt)


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor, start: int,
                             comm: Comm) -> torch.Tensor:
    """The rows of ``ids`` from a table whose rows ``[start, start +
    len(weight))`` this rank holds: each rank looks up the ids in its range
    and zeros the rest, and the SUM over tp completes every row (exactly:
    one rank contributes each). Backward: each rank's rows get their ids'
    cotangents, no other row a gradient."""
    if comm.size == 1:
        return F.embedding(ids, weight)
    local = ids.long() - start
    inside = (local >= 0) & (local < weight.shape[0])
    rows = F.embedding(local.masked_fill(~inside, 0), weight)
    rows = rows.masked_fill(~inside[..., None], 0.0)
    return psum(rows, comm, grad="identity", name=f"{SPAN}.embed_sum")


class _VocabXent(torch.autograd.Function):
    """Per-token cross-entropy over vocabulary shards, in f32: the max over
    tp (no gradient flows through it), Σexp over tp, the label's logit from
    the rank that holds it; backward softmax minus one-hot on each shard,
    recomputed from the saved logits."""

    @staticmethod
    def forward(ctx, logits, labels, comm, start):
        with ops.span(f"{SPAN}.xent"):
            z = logits.float()
            m = z.amax(dim=-1)
            if comm.size > 1:
                dist.all_reduce(m, op=dist.ReduceOp.MAX, group=comm.group)
            sumexp = torch.exp(z - m[..., None]).sum(dim=-1)
            local = labels.long() - start
            inside = (local >= 0) & (local < z.shape[-1])
            local = local.masked_fill(~inside, 0)
            picked = z.gather(-1, local[..., None])[..., 0].masked_fill(~inside, 0.0)
            if comm.size > 1:
                both = torch.stack([sumexp, picked])
                dist.all_reduce(both, op=dist.ReduceOp.SUM, group=comm.group)
                sumexp, picked = both.unbind(0)
        ctx.save_for_backward(logits, m, sumexp, local, inside)
        return torch.log(sumexp) + m - picked

    @staticmethod
    def backward(ctx, g):
        logits, m, sumexp, local, inside = ctx.saved_tensors
        p = torch.exp(logits.float() - m[..., None]) / sumexp[..., None]
        p.scatter_add_(-1, local[..., None], -inside[..., None].float())
        return (p * g[..., None]).to(logits.dtype), None, None, None


def vocab_parallel_token_xent(logits: torch.Tensor, labels: torch.Tensor, axis,
                              vocab_size: int) -> torch.Tensor:
    """Each token's cross-entropy (f32) of ``logits``, this rank's
    vocabulary shard (``shard_range(vocab_size, tp, rank)`` of the last
    dim), against the global ``labels``; the same values on every rank of
    the tp line ``axis`` (a ``Comm``)."""
    units = shard_range(vocab_size, axis.size, axis.rank)
    if logits.shape[-1] != len(units):
        raise ValueError(f"logits hold {logits.shape[-1]} vocabulary columns, tp rank "
                         f"{axis.rank} of {axis.size} holds {len(units)} of {vocab_size}")
    return _VocabXent.apply(logits, labels, axis, units.start)


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor, axis,
                        vocab_size: int) -> torch.Tensor:
    """Mean of ``vocab_parallel_token_xent``."""
    return vocab_parallel_token_xent(logits, labels, axis, vocab_size).mean()


def vocab_parallel_lm_loss(logits: torch.Tensor, ids: torch.Tensor, axis,
                           vocab_size: int) -> torch.Tensor:
    """``lm_loss`` over vocabulary shards: next-token prediction."""
    return vocab_parallel_xent(logits[:, :-1], ids[:, 1:], axis, vocab_size)
