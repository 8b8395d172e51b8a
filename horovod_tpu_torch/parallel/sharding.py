"""Logical axes -> mesh axes (counterpart of
``horovod_tpu/parallel/sharding.py``), the part the port's axes use.

The JAX package names the dimensions of its parameters and activations
("batch", "seq", "expert", "layers", ...) and a rule table maps each name
to mesh axes; GSPMD then places every tensor. Here a rank holds its part of
a parameter outright (the model is built on the mesh), and the rules say
which parameters a rank holds a part of and which are replicated:

* ``DEFAULT_RULES``: "mlp", "heads" and "vocab" lie over tp (a rank holds
  its tp shard of the FFN, of the attention heads and of the vocabulary,
  ``parallel/tensor.py``), the scan axis "layers" is replicated, "expert"
  lies over ep (``SwitchMoE`` holds ``E / ep`` experts) and "expert_mlp"
  over tp (each of them holds its tp shard of the experts' d_ff);
* ``PIPELINE_RULES``: "layers" over pp, as in JAX: a pp rank holds its
  stage's blocks (``models/pipelined.py``), and the embeddings, ``ln_f`` and
  the head are replicated over pp; the tp rows stay, so with tp a block's
  tensor may be cut over both pp and tp;
* ``FSDP_RULES``: ``DEFAULT_RULES`` with "embed" (d_model) over dp as well,
  the JAX ZeRO-3 analogue: a dp rank holds its dp shard of every parameter
  with a d_model dimension (``parallel/fsdp.py``), beside the tp cuts of
  the same table. As in flax, a mesh axis serves one dimension of a tensor
  only; the port's parameters carry no batch dimension, so every "embed"
  dimension goes over dp (no parameter has two).

A parameter's cut is marked on it (``tensor_parallel``, ``fsdp``,
``expert_parallel``) by the model that holds it; ``logical_axes`` reads the
marks back. ``replica_comm`` is a parameter's line of copies: the mesh axes
its cuts do not follow (a tp-cut parameter's (dp, ...) line, an FSDP-cut
one's line without dp, the world for a replicated one). ``make_train_step``
broadcasts each parameter within that line at init.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from .mesh import Comm, Mesh

# (logical axis, mesh axes) pairs: the JAX table's rows for the port's
# parameters (``parallel/train.py`` cuts the batch over dp and sp itself).
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("embed", None),             # d_model replicated (megatron layout)
    ("mlp", ("tp",)),            # d_ff column-split
    ("heads", ("tp",)),          # attention heads split
    ("vocab", ("tp",)),          # embedding/lm-head vocab split
    ("expert", ("ep",)),         # MoE experts -> expert parallel
    ("expert_mlp", ("tp",)),
    ("layers", None),            # the layer axis; "pp" when pipelining
)

# Pipeline variant: the layer axis lies over pp (PipelinedLM's stages).
PIPELINE_RULES: Tuple[Tuple[str, Any], ...] = tuple(
    ("layers", ("pp",)) if k == "layers" else (k, v) for k, v in DEFAULT_RULES
)

# FSDP variant: d_model over dp as well (``parallel/fsdp.py``).
FSDP_RULES: Tuple[Tuple[str, Any], ...] = tuple(
    ("embed", ("dp",)) if k == "embed" else (k, v) for k, v in DEFAULT_RULES
)


def filter_rules(rules: Sequence[Tuple[str, Any]], mesh: Mesh):
    """Drop mesh axes that are not in ``mesh`` (the JAX function), so that
    one rule table serves every mesh."""
    out = []
    for logical, axes in rules:
        if axes is None:
            out.append((logical, None))
            continue
        if isinstance(axes, str):
            axes = (axes,)
        present = tuple(a for a in axes if a in mesh.axis_names)
        if len(present) == 1:
            out.append((logical, present[0]))
        elif present:
            out.append((logical, present))
        else:
            out.append((logical, None))
    return tuple(out)


def logical_axes(name: str, param: torch.Tensor) -> Tuple[str, ...]:
    """The logical axes a parameter of the port's models is cut along:
    "expert" for a Switch FFN's experts, "mlp", "heads", "vocab" or
    "expert_mlp" for a tp-cut one (its ``tensor_parallel`` mark; an expert
    weight under tp has both "expert" and "expert_mlp"), "embed" for an
    FSDP-cut one (its ``fsdp`` mark), "layers" for a block's parameter
    (``stack.layers.<i>.*``); none for the rest."""
    out = []
    if hasattr(param, "expert_parallel"):
        out.append("expert")
    if hasattr(param, "tensor_parallel"):
        out.append(param.tensor_parallel.logical)
    if getattr(param, "fsdp", None) is not None:
        out.append(param.fsdp.logical)
    if name.startswith("stack.layers."):
        out.append("layers")
    return tuple(out)


def mesh_axes(logical: Optional[str], rules, mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes of size above one that ``logical`` lies over."""
    if logical is None:
        return ()
    axes = dict(filter_rules(rules, mesh)).get(logical)
    axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
    return tuple(a for a in axes if mesh.shape[a] > 1)


def replica_comm(name: str, param: torch.Tensor, rules, mesh: Mesh) -> Comm:
    """The line of ranks that hold the same part of ``param``: the mesh axes
    its cuts do not follow (the whole world for a replicated parameter)."""
    cut = {a for logical in logical_axes(name, param)
           for a in mesh_axes(logical, rules, mesh)}
    if not cut:
        return mesh.comm(mesh.axis_names)
    return mesh.comm(tuple(a for a in mesh.axis_names if a not in cut))
