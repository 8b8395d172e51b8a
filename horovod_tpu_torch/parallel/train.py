"""The training step (counterpart of ``horovod_tpu/parallel/train.py:55-296``).

The JAX package builds one jitted SPMD step whose batch is sharded over the
mesh (``batch_spec``: dim 0 over ``dp``, dim 1 over ``sp`` with
``shard_seq``, replicated over ``ep``) and lets GSPMD derive the
collectives. Here each rank runs the same eager step on its cut of the
global batch, through a model built on the same mesh (``make_model(mesh=
...)``: the sequence-parallel attention, the positions of its sequence
block, the Switch-MoE experts of its ep index), and the optimizer reduces
the gradients over the ``("dp", "sp")`` line: a ``DistributedOptimizer``
with that ``axis_name`` (the world when the mesh has no ep axis).

Every rank's objective counts once: a rank's loss is its share of the
global mean, ``G · (its sum) / (global count)`` with G the size of the
("dp", "sp") line, so the line's average of the ranks' gradients, which
the optimizer takes, is the gradient of the global loss, and so is the
average of their losses, which the step returns. Ranks along ep hold the
same tokens and compute the same objective; their replicated gradients
come out equal (``models/transformer.py``). ``lm_loss`` under sequence
sharding is over the global shifted sequence: a rank's last position is
labelled with the first id of the next sp block, and the last sp block has
one label fewer, as ``lm_loss`` on the whole sequence has.

Under tp > 1 the batch is not cut over tp: every rank of a tp line takes
its dp cut whole, and the model's logits are its vocabulary shard, so
``lm_loss`` and ``softmax_xent`` become their vocab-parallel forms
(``parallel/tensor.py``), whose value every tp rank computes alike. The
optimizer still reduces over the ("dp", "sp") line only: the gradients of
replicated parameters come out equal on every tp rank, those of tp-cut
ones are the rank's shard. With Switch experts under tp (and ep) a
rank's expert weights are its ep slice of the experts and its tp shard of
their d_ff; their gradients, like every other, are reduced over the
("dp", "sp") line only, and ``moe_aux_weight`` adds the auxiliary loss,
the same on every tp and ep rank, once. Under tp and pp together the
model is a ``PipelinedLM`` whose stages hold their tp shards: every rank of
a pp line takes the pipeline's replicated output, its vocabulary shard on
this rank, and computes the vocab-parallel loss over its own tp line.
Under pp and sp together the pipeline's replicated output is this rank's
sequence block of the logits, and every rank of a pp line computes its
share of ``lm_loss`` over the global shifted sequence from it (the
pipeline's backward takes the last stage's cotangent once); the optimizer
reduces a stage's gradients over its (dp, sp) line, the ranks that hold
that stage. Under tp and sp together
``lm_loss`` is both: the labels of this rank's sequence block are taken
from the global ids across the sp boundary, and the cross-entropies over
the tp line's vocabulary shards (``vocab_parallel_token_xent``).

As in JAX, ``optimizer`` may be a plain ``torch.optim`` optimizer: the step
wraps it in ``DistributedOptimizer(..., axis_name=<the ("dp", "sp")
line>)``, since GSPMD averages the JAX step's gradients over the batch's
axes whatever ``tx`` is. ``zero=True`` is the JAX spelling of ZeRO
(``horovod_tpu/parallel/train.py:99-113``, ``:175-201``): the moments are
sharded over the data line. JAX stacks the dp shard in front of each
moment's own tp spec; here each rank's flat buffer already holds only its
tp shards, so ``DistributedOptimizer(opt, zero=1, axis_name=<the data
line>)`` is the same layout. ``rules`` is the model's (``FSDP_RULES``: the
parameters themselves cut over dp, ``parallel/fsdp.py``). Under
``FSDP_RULES`` on a dp x sp mesh the cut parameters are replicated over
sp, and the optimizer, still over the ("dp", "sp") line, sums their
gradients (already summed over dp by the gathers' reduce-scatters) over
the sp line before AVERAGE's 1/(dp·sp) (``optim/distributed.py``). With
Switch experts under ``FSDP_RULES`` (dp x ep, dp x sp) the router and the
rank's E/ep experts are cut over dp too and replicated over sp; the
optimizer's line stays ("dp", "sp"), so an expert's gradient, summed over
dp by its gather's reduce-scatter, is summed over sp by the optimizer and
never over ep, and ``moe_aux_weight`` and the dropped-token counts are as
under ``DEFAULT_RULES``.

``dropout=True`` runs a model whose ``forward`` takes ``deterministic``
with ``deterministic=False`` under the dropout key (``dropout_seed``, the
step count, this rank's dp and sp coordinates) (``models/dropout.py``), the
JAX step's ``fold_in(PRNGKey(dropout_seed), step)`` rng; with it False
(the default) such a model runs deterministic, as in JAX, whatever its
``dropout_rate``.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..common import basics
from ..common.types import ReduceOp
from ..models.dropout import dropout_key
from .mesh import Comm, Mesh
from .sharding import DEFAULT_RULES, FSDP_RULES, replica_comm
from .tensor import vocab_parallel_lm_loss, vocab_parallel_token_xent, vocab_parallel_xent


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; the log-softmax runs in f32 whatever the logits'
    dtype."""
    logp = F.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -picked.mean()


def lm_loss(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Next-token prediction loss for causal LMs."""
    return softmax_xent(logits[:, :-1], ids[:, 1:])


@dataclasses.dataclass
class TrainState:
    """The step count; the model and optimizer hold the tensors."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def _data_comm(mesh: Mesh) -> Comm:
    """The ("dp", "sp") line the gradients are reduced over."""
    return mesh.comm(tuple(a for a in ("dp", "sp") if a in mesh.axis_names))


def _cut(x: torch.Tensor, mesh: Mesh, shard_seq: bool) -> torch.Tensor:
    """This rank's part of a global batch: dim 0 over dp, dim 1 over sp with
    ``shard_seq`` (tensors of two dims or more), the whole over ep."""
    for dim, axis in ((0, "dp"), (1, "sp")):
        n = mesh.shape.get(axis, 1)
        if n == 1 or x.dim() <= dim or (dim == 1 and not shard_seq):
            continue
        if x.shape[dim] % n:
            raise ValueError(f"global batch dim {dim} ({x.shape[dim]}) does not split "
                             f"over {axis}={n}")
        per = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[axis] * per, per)
    return x


def _lm_loss_sharded(logits: torch.Tensor, ids: torch.Tensor, mesh: Mesh,
                     group: int, vocab: Optional[Tuple[Comm, int]] = None) -> torch.Tensor:
    """This rank's share of ``lm_loss`` over the global shifted sequence:
    ``group · Σ(its cross-entropies) / (B · (S - 1))``. ``ids`` is the
    global (B, S) batch. ``vocab`` = (the tp line, the vocabulary size):
    the logits are this rank's vocabulary shard, and the cross-entropies
    are taken over the line's shards (``vocab_parallel_token_xent``), the
    same on every tp rank."""
    rows = _cut(ids, mesh, False)
    Bl, Sl = logits.shape[:2]
    start = mesh.coords["sp"] * Sl
    labels = rows[:, start + 1: start + Sl + 1]
    z = logits[:, :labels.shape[1]]
    count = ids.shape[0] * (ids.shape[1] - 1)
    if vocab is not None:
        xent = vocab_parallel_token_xent(z, labels, vocab[0], vocab[1])
        return xent.sum() * (group / count)
    logp = F.log_softmax(z.float(), dim=-1)
    picked = logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -picked.sum() * (group / count)


def _broadcast_(t: torch.Tensor, comm: Comm) -> None:
    """``t`` from the first member of ``comm``, in place."""
    if comm.size == 1:
        return
    dev = basics.device()
    with torch.no_grad():
        if t.device.type == dev.type:
            ops.broadcast_(t, 0, axis_name=comm)
        else:   # AdamW keeps `step` on the CPU
            t.copy_(ops.broadcast_(t.to(dev), 0, axis_name=comm))


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable, *, mesh: Mesh, shard_seq: bool = False,
                    moe_aux_weight: float = 0.0, zero: bool = False, rules=None,
                    dropout: bool = False, dropout_seed: int = 0
                    ) -> Tuple[Callable[[], TrainState], Callable]:
    """Returns ``(init_fn, step_fn)``.

    ``init_fn()`` broadcasts each parameter and buffer, and its optimizer
    state, from the first member of its line of copies
    (``sharding.replica_comm`` under the model's ``rules``, default
    ``DEFAULT_RULES``): the replicated ones from rank 0, an expert within
    its ("dp", "sp") line, so that every ep rank keeps its own experts, and
    a ``PipelinedLM`` stage's blocks within the line of ranks that hold
    that stage (its (dp, ep, sp) line at its pp coordinate; under tp a cut
    block tensor within its dp line, a replicated one within its stage's
    (dp, tp) line, the embedding's and the head's vocabulary shards within
    their (pp, dp) line); it returns the initial ``TrainState``. The
    world's broadcasts come first, every rank issuing them in one order;
    then each line's, which under pp are the stage's own and so run on
    groups no other stage's ranks belong to.
    ``step_fn(state, inputs, labels)`` takes the global batch, puts the
    model in train mode, runs this rank's cut of it forward and backward,
    adds ``moe_aux_weight`` times the model's MoE auxiliary loss, steps
    the optimizer, and returns ``(state, loss)``, the global loss (aux
    included) as a detached scalar on the device.

    ``optimizer`` is a plain ``torch.optim`` optimizer, which the step
    wraps in a ``DistributedOptimizer`` over the ("dp", "sp") line (with
    ``zero=True``: ``zero=1`` on that line), or a ``DistributedOptimizer``
    already reducing over that line (ZeRO there when ``zero=True``); the
    ``TrainState`` holds the one that steps. ``zero=True`` needs a dp axis
    and does not combine with ``FSDP_RULES``. ``rules``, where given, must
    be the model's ``rules`` (the model is built with them); under
    ``FSDP_RULES`` with sp > 1 (and ``shard_seq``) each rank's dp shards are
    its sp line's copies, broadcast within that line at init, and their
    gradients are summed over sp by the optimizer.

    ``shard_seq`` cuts dim 1 over sp; a mesh with sp > 1 needs it, since
    the model then takes this rank's sequence block. With pp > 1 the model
    is a ``PipelinedLM`` on ``mesh``: every rank of a pp line computes the
    loss of the pipeline's replicated output (with sp, its share of the
    sequence-sharded ``lm_loss`` on its sequence block; with ep, a dense
    model replicated over ep). With tp > 1 the model
    (``TransformerLM`` or ``PipelinedLM``) is built on ``mesh`` too and
    ``loss_fn`` is ``lm_loss`` or ``softmax_xent``, taken over the
    vocabulary shards on this rank's tp line. Under every mesh the
    optimizer reduces over the ("dp", "sp") line only: the gradients of
    tp-cut tensors are this rank's shard, those of pp-cut blocks its
    stage's, and the rest come out equal on every tp and pp rank.
    ``dropout`` and ``dropout_seed``: see the module docstring."""
    from ..optim.distributed import DistributedOptimizer

    sp = mesh.shape.get("sp", 1)
    data = _data_comm(mesh)
    if sp > 1 and not shard_seq:
        raise ValueError("a mesh with sp > 1 needs shard_seq=True: the model takes "
                         "this rank's sequence block")
    sharded = any(mesh.shape.get(a, 1) > 1 for a in ("pp", "ep", "sp", "tp"))
    if sharded and getattr(model, "mesh", None) is not mesh:
        raise ValueError("the model must be built on the step's mesh "
                         "(make_model(mesh=...), PipelinedLM(cfg, mesh)) when it has "
                         "pp, sp, ep or tp")
    # Decided before tp swaps the loss: under sp, lm_loss is over the
    # global shifted sequence (its labels cross the sp blocks).
    sharded_lm = loss_fn is lm_loss and sp > 1
    vocab = None
    if mesh.shape.get("tp", 1) > 1:
        tp_loss = {lm_loss: vocab_parallel_lm_loss, softmax_xent: vocab_parallel_xent}
        if loss_fn not in tp_loss:
            raise ValueError("with tp > 1 the logits are this rank's vocabulary shard: "
                             "loss_fn must be lm_loss or softmax_xent")
        vocab = (mesh.comm("tp"), model.cfg.vocab_size)
        loss_fn = functools.partial(tp_loss[loss_fn], axis=vocab[0], vocab_size=vocab[1])
    model_rules = getattr(model, "rules", DEFAULT_RULES)
    if rules is not None and tuple(rules) != tuple(model_rules):
        raise ValueError("rules= must be the model's rules: build the model with them "
                         "(make_model(rules=...))")
    rules = model_rules
    if zero:
        if "dp" not in mesh.axis_names:
            raise ValueError("make_train_step(zero=True) needs a 'dp' axis in the mesh "
                             "to shard optimizer state over")
        if rules == FSDP_RULES:
            raise ValueError("zero=True does not combine with FSDP_RULES: the moments of "
                             "the parameters cut over dp are already sharded")
    if isinstance(optimizer, DistributedOptimizer):
        if optimizer._comm().ranks != data.ranks:
            raise ValueError(
                f"the optimizer reduces over ranks {optimizer._comm().ranks}, the step's "
                f"gradients must be reduced over the ('dp', 'sp') line {data.ranks}: "
                "pass axis_name=('dp', 'sp') to DistributedOptimizer")
        if zero and optimizer._zero is None:
            raise ValueError("zero=True with a DistributedOptimizer that is not ZeRO: pass "
                             "the plain optimizer, or DistributedOptimizer(zero=1, "
                             "axis_name=('dp', 'sp'))")
    else:
        optimizer = DistributedOptimizer(optimizer, zero=1 if zero else 0, axis_name=data)

    def init_fn() -> TrainState:
        # The world's broadcasts first, then each line's; every rank issues
        # them in the order of the names it holds.
        tensors = sorted(model.state_dict(keep_vars=True).items(), key=lambda kv: kv[0])
        line = {id(t): replica_comm(name, t, rules, mesh) for name, t in tensors}
        params = [p for g in optimizer.param_groups for p in g["params"]]
        state = (optimizer.state_dict()["state"]
                 if getattr(optimizer, "_zero", None) is None else {})
        for world in (True, False):
            for _, t in tensors:
                if line[id(t)].world == world:
                    _broadcast_(t.data, line[id(t)])
            for pid in sorted(state):
                comm = line[id(params[pid])]
                if comm.world == world:
                    for key in sorted(state[pid]):
                        if isinstance(state[pid][key], torch.Tensor):
                            _broadcast_(state[pid][key], comm)
        return TrainState(step=0, model=model, optimizer=optimizer)

    takes_deterministic = "deterministic" in inspect.signature(model.forward).parameters
    coords = (mesh.coords.get("dp", 0), mesh.coords.get("sp", 0))

    def forward(x, step: int):
        if not takes_deterministic:
            return model(x)
        if not dropout:
            return model(x, deterministic=True)
        with dropout_key(dropout_seed, step, *coords):
            return model(x, deterministic=False)

    def step_fn(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor):
        x = _cut(inputs, mesh, shard_seq).to(mesh.device)
        model.train()   # batch statistics, as the JAX step's train=True
        optimizer.zero_grad(set_to_none=True)
        logits = forward(x, state.step)
        if sharded_lm:
            loss = _lm_loss_sharded(logits, labels.to(mesh.device), mesh, data.size, vocab)
        else:
            loss = loss_fn(logits, _cut(labels, mesh, shard_seq).to(mesh.device))
        if moe_aux_weight > 0.0:
            aux = model.moe_aux_loss()
            if aux is not None:
                loss = loss + moe_aux_weight * aux
        loss.backward()
        optimizer.step()
        # Every rank averages one scalar here: no header exchange.
        loss = ops._allreduce(loss.detach(), ReduceOp.AVERAGE, comm=data)
        return dataclasses.replace(state, step=state.step + 1), loss

    return init_fn, step_fn
