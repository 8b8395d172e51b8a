"""Parameters cut over dp along d_model: what GSPMD derives from the
("embed", "dp") row of ``FSDP_RULES`` (``horovod_tpu/parallel/sharding.py:
46-58``), written out as ``parallel/tensor.py`` writes out the tp rows. The
JAX file has no counterpart of this one: there the rule places each
parameter and XLA inserts the all-gathers and reduce-scatters.

A dp rank holds its dp shard of every parameter with a d_model dimension
(the embeddings, the LayerNorms, the attention and FFN kernels, the head,
the biases of the row-parallel layers; ``FSDP_PARAMS``), units
``shard_range(d_model, dp, rank)`` of that dimension, beside whatever tp
cut the same parameter has along another. At its use a layer takes the
full parameter through ``gathered``: an all-gather over the dp line
(``collectives.all_gather``) whose backward reduce-scatters the gradient
over the same line, so each rank's gradient is already the SUM over dp of
its shard, and ``DistributedOptimizer`` does not reduce it again over dp
(it applies only AVERAGE's 1/n and the scale factors). Under remat the
gather sits inside the checkpointed block, so backward gathers again and
only one block's full parameters are alive at a time. The optimizer's
state follows the shards: AdamW's moments of an FSDP-cut parameter are
its shard's.

Under sp the layout is the JAX one: a parameter is cut over the dp line
and replicated over sp, so the sp members of dp index d hold the same
shard (``flax_to_torch(..., dp=, dp_rank=)`` gives each of them that
shard). Each sp member's backward reduce-scatters, over its dp line, the
gradient of its own sequence block; the sum over the sp members that hold
the same shard is left, and ``DistributedOptimizer``, whose line is
("dp", "sp"), all-reduces the cut gradients over the rest of its line
(the sp line) in its buckets before it applies AVERAGE's 1/(dp·sp).

With Switch experts (``models/transformer.py`` ``SwitchMoE``) the router's
(E, D) weight is cut along D, and each expert tensor, ``moe.wi`` (E/ep, D,
d_ff) and ``moe.wo`` (E/ep, d_ff, D), along its D, over the dp line alone:
the JAX placements ``P('dp', None)`` for the router kernel, ``P('ep', 'dp',
None)`` and ``P('ep', None, 'dp')`` for the experts. The dense parameters
and the router are replicated over ep, the experts are the rank's ep slice.
The sums of an expert's gradient: a rank's gradient of its full (gathered)
experts covers the slots of its own tokens only (the expert input is
completed by a SUM over (dp, sp), and its cotangent is the rank's own
slots'); the gather's reduce-scatter sums it over dp, and
``DistributedOptimizer`` sums it over the rest of its ("dp", "sp") line
(sp) as for every cut parameter. Nothing sums it over ep, whose members
hold other experts: an optimizer whose line holds ep refuses an expert
cut over dp. The router's and the dense parameters' gradients come out
equal on every ep rank (the tokens and the gate enter the expert region
through ``pvary`` over ep) and are summed the same way.

Uneven splits follow ``shard_range`` (the last shard short): each shard is
padded to ⌈n/dp⌉ for the gather and the padding cut away after it. At a
dp line of one member nothing is cut and ``gathered`` returns the
parameter itself, bit for bit. FSDP combines with dp, ep, tp, sp and
Switch experts; with pp, experts under tp > 1, gradient accumulation, sp
and tp both above one (dp x sp x tp, a mesh of eight ranks), and on the
BERT encoder, it raises ``NotImplementedError`` naming its ROADMAP item,
and it does not take ZeRO (the moments are already sharded).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from .collectives import all_gather
from .mesh import Comm
from .tensor import shard_range

SPAN = "hvd.fsdp"

# A parameter's name in the model (its last components) -> the torch
# tensor's d_model dimension (nn.Linear keeps (out, in), the transpose of
# the flax kernel).
FSDP_PARAMS: Dict[str, int] = {
    "embed.embedding": 1,
    "embed.pos_embedding": 1,
    "ln1.weight": 0, "ln1.bias": 0,
    "ln2.weight": 0, "ln2.bias": 0,
    "ln_f.weight": 0, "ln_f.bias": 0,
    "attn.qkv.weight": 1,
    "attn.out.weight": 0, "attn.out.bias": 0,
    "mlp.wi.weight": 1,
    "mlp.wo.weight": 0, "mlp.wo.bias": 0,
    "lm_head.weight": 1,
    # Switch experts: the router's (E, D) weight, the experts' (E/ep, D,
    # d_ff) and (E/ep, d_ff, D) kernels.
    "moe.router.weight": 1,
    "moe.wi": 1,
    "moe.wo": 2,
}


@dataclasses.dataclass(frozen=True)
class FSDPCut:
    """Where a dp rank's shard lies in the full tensor: dimension ``dim``
    is ``n`` long, and the rank of index ``rank`` in the dp line ``comm``
    holds units ``shard_range(n, comm.size, rank)`` of it."""

    logical: str
    dim: int
    n: int
    comm: Comm

    @property
    def units(self) -> range:
        return shard_range(self.n, self.comm.size, self.comm.rank)

    def full_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        out[self.dim] = self.n
        return tuple(out)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        out[self.dim] = len(self.units)
        return tuple(out)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full``."""
        return full.narrow(self.dim, self.units.start, len(self.units))

    def gather(self, p: torch.Tensor) -> torch.Tensor:
        """The full tensor from this rank's shard ``p``, differentiably: an
        all-gather over the dp line, a reduce-scatter in backward."""
        x, per = p, -(-self.n // self.comm.size)
        if x.shape[self.dim] < per:
            pad = list(x.shape)
            pad[self.dim] = per - x.shape[self.dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=self.dim)
        full = all_gather(x, self.comm, dim=self.dim, name=f"{SPAN}.all_gather")
        return full if full.shape[self.dim] == self.n else full.narrow(self.dim, 0, self.n)


def fsdp_dim(name: str) -> Optional[int]:
    """The d_model dimension of the model parameter ``name`` (a
    ``state_dict`` key of ``TransformerLM``), or None for one without."""
    for suffix, dim in FSDP_PARAMS.items():
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def fsdp_cut(name: str, cfg, comm: Comm) -> Optional[FSDPCut]:
    """The dp cut of the model parameter ``name`` on the dp line ``comm``,
    or None for a parameter that is not cut (none on a line of one)."""
    dim = fsdp_dim(name)
    if dim is None or comm.size == 1:
        return None
    return FSDPCut("embed", dim, cfg.d_model, comm)


# What the refusals name.
NOT_PORTED = ("ROADMAP A3: FSDP with pp, experts under tp, gradient accumulation, "
              "dp x sp x tp or the BERT encoder")


def check_fsdp_supported(cfg, mesh) -> None:
    """The combinations this port does not run under an FSDP cut raise
    ``NotImplementedError`` naming their ROADMAP item."""
    if mesh.shape.get("pp", 1) > 1:
        raise NotImplementedError(
            f"FSDP_RULES with pp={mesh.shape['pp']} is not ported ({NOT_PORTED})")
    if mesh.shape.get("sp", 1) > 1 and mesh.shape.get("tp", 1) > 1:
        raise NotImplementedError(
            f"FSDP_RULES with sp={mesh.shape['sp']} and tp={mesh.shape['tp']} together is "
            f"not ported ({NOT_PORTED})")
    if cfg.n_experts and mesh.shape.get("tp", 1) > 1:
        raise NotImplementedError(
            f"FSDP_RULES with n_experts={cfg.n_experts} and tp={mesh.shape['tp']} is not "
            f"ported ({NOT_PORTED})")


def mark_fsdp(model: torch.nn.Module, cfg, comm: Comm) -> None:
    """Cut each FSDP parameter of ``model`` to this rank's dp shard (its
    values are drawn afterwards, by ``init_param_``) and mark it with its
    ``FSDPCut`` (``fsdp``)."""
    if comm.size == 1:
        return
    for name, p in model.named_parameters():
        cut = fsdp_cut(name, cfg, comm)
        if cut is None:
            continue
        if p.shape[cut.dim] != cut.n:
            raise AssertionError(f"{name}: shape {tuple(p.shape)}, fsdp cut {cut}")
        p.data = p.data.new_empty(cut.local_shape(p.shape))
        p.fsdp = cut


def gathered(p: torch.Tensor) -> torch.Tensor:
    """The full parameter: ``p`` itself unless it is FSDP-cut."""
    cut = getattr(p, "fsdp", None)
    return p if cut is None else cut.gather(p)
