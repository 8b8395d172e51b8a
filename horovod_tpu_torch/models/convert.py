"""flax parameters -> the port's ``state_dict``.

``resnet_flax_to_torch(params, batch_stats, model)`` does the same for the
ResNet family (see its docstring).

``flax_to_torch(params, cfg)`` takes the ``params`` tree of the JAX
``TransformerLM`` as nested dicts of numpy arrays (unboxed) and returns the
``state_dict`` of ``models.transformer.TransformerLM(cfg)``;
``bert_flax_to_torch`` does the same for ``TransformerEncoder``, whose head
is ``mlm_head`` where the LM's is ``lm_head``. flax kernels
are (in, out), the transpose of ``nn.Linear.weight``; the qkv kernel
(D, 3, H, Hd) keeps its (3, H, Hd) order when flattened, and the out
kernel (H, Hd, D) flattens to (H*Hd, D). A Switch-MoE block's router
kernel (D, E) becomes the Linear weight (E, D), and its ``wi`` (E, D, F)
and ``wo`` (E, F, D) are cut to this rank's ``E / ep`` experts by its ep
index (``flax_to_torch(..., ep=, ep_rank=)``), then, with ``tp``, to its tp
shard of F; ``ep_join`` concatenates the ep ranks' experts (each joined
over tp first) back into the full model's. A missing or extra key
raises. With ``cfg.stacked`` (``scan_layers`` and a dense FFN) the layers
are read from JAX's scan-stacked ``stack/layers`` (``unstack_layers``), else
from ``stack/layer_{i}``; ``flax_to_torch(..., stages=, stage=)`` returns
one pipeline stage's part (``models/pipelined.py``). ``flax_to_torch(...,
tp=, tp_rank=)`` and ``bert_flax_to_torch(..., tp=, tp_rank=)`` return tp
rank ``tp_rank``'s shard of each tp-cut parameter, by the rule the model is
built and initialised with (``parallel/tensor.tp_cut``), and ``tp_join``
joins the tp ranks' shards (of parameters or of gradients) back into the
full model's tensors. Under ``FSDP_RULES``, ``flax_to_torch(..., dp=,
dp_rank=)`` also cuts each parameter with a d_model dimension
(``parallel/fsdp.FSDP_PARAMS``: with Switch experts the router and, after
their ep slice, ``wi`` and ``wo`` too) to dp rank ``dp_rank``'s units
``shard_range(d_model, dp, dp_rank)`` of it, after the tp cut, and
``fsdp_join`` joins the dp ranks' shards back (then ``ep_join`` the ep
ranks' experts).

``vit_flax_to_torch(params, cfg)`` and ``mnist_flax_to_torch(params, model)``
do the same for the ViT and the MNIST nets.

``zero_state_from_jax(state, rank, world)`` takes the JAX traced plane's
global ``ZeroState`` and returns one rank's shard of it in the form
``DistributedOptimizer.load_shard_state`` takes (``optim/zero.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..parallel.fsdp import fsdp_dim
from ..parallel.tensor import shard_range, tp_cut
from .resnet import BottleneckResNetBlock, ResNet, ResNetBlock
from .transformer import TransformerConfig, uses_moe


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


def _apply_plan(flat: Dict[str, np.ndarray], plan: Dict, what: str,
                dtype) -> Dict[str, torch.Tensor]:
    missing = sorted(set(plan) - set(flat))
    extra = sorted(set(flat) - set(plan))
    if missing or extra:
        raise KeyError(f"flax {what} do not match the model: missing {missing}, "
                       f"extra {extra}")
    out = {}
    for path, (key, fn) in plan.items():
        arr = flat[path] if fn is None else fn(flat[path])
        out[key] = torch.from_numpy(np.array(arr, copy=True)).to(dtype)
    return out


def _experts(ep: int, ep_rank: int, n_experts: int):
    if n_experts % ep:
        raise ValueError(f"n_experts={n_experts} must be divisible by ep={ep}")
    per = n_experts // ep
    return lambda a: a[ep_rank * per:(ep_rank + 1) * per]


def unstack_layers(params: Mapping, n_layers: int) -> Dict:
    """The JAX scan-stacked layout (``params["stack"]["layers"]``, every leaf
    with a leading L axis; ``scan_layers=True`` with a dense FFN) as the
    unrolled one (``stack/layer_{i}``), layer i the leaves' row i."""
    def row(tree, i):
        if isinstance(tree, Mapping):
            return {k: row(v, i) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.shape[:1] != (n_layers,):
            raise ValueError(f"a scanned leaf of shape {a.shape} has no leading axis "
                             f"of {n_layers} layers")
        return a[i]

    stacked = params["stack"]["layers"]
    out = {k: v for k, v in params.items() if k != "stack"}
    out["stack"] = {f"layer_{i}": row(stacked, i) for i in range(n_layers)}
    return out


def _transformer_to_torch(params: Mapping, cfg: TransformerConfig, head: str,
                          ep: int = 1, ep_rank: int = 0, layers: Optional[range] = None,
                          tp: int = 1, tp_rank: int = 0, dp: int = 1,
                          dp_rank: int = 0) -> Dict[str, torch.Tensor]:
    if cfg.stacked:
        params = unstack_layers(params, cfg.n_layers)
    layers = range(cfg.n_layers) if layers is None else layers
    flat = _flatten(params)
    other = tuple(f"stack/layer_{i}/" for i in range(cfg.n_layers) if i not in layers)
    flat = {k: v for k, v in flat.items() if not k.startswith(other)}
    D = cfg.d_model
    plan = {   # flax path -> (torch key, transform)
        "embed/embedding": ("embed.embedding", None),
        "ln_f/scale": ("ln_f.weight", None),
        "ln_f/bias": ("ln_f.bias", None),
        **_stack_plan(cfg, layers, ep, ep_rank),
    }
    if cfg.learned_pos:
        plan["embed/pos_embedding"] = ("embed.pos_embedding", None)
    if not (cfg.logits_via_embedding and head == "lm_head"):
        plan[f"{head}/kernel"] = (f"{head}.weight", lambda a: _dense(a, D))
    out = _apply_plan(flat, plan, "params", cfg.param_dtype)
    units = shard_range(cfg.d_model, dp, dp_rank)
    for key, t in out.items():
        cut, dim = tp_cut(key, cfg, tp, tp_rank), fsdp_dim(key)
        if cut is not None:
            t = cut.take(t).contiguous()
        if dim is not None and dp > 1:
            t = t.narrow(dim, units.start, len(units)).contiguous()
        out[key] = t
    return out


def _stack_plan(cfg: TransformerConfig, layers, ep: int = 1, ep_rank: int = 0) -> Dict:
    """The plan of the blocks ``layers`` of ``stack/layer_{i}``."""
    D = cfg.d_model
    HHd = cfg.n_heads * cfg.head_dim
    plan = {}
    for i in layers:
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
        if uses_moe(cfg, i):
            cut = _experts(ep, ep_rank, cfg.n_experts)
            plan[f"{src}/moe/router/kernel"] = (f"{dst}.moe.router.weight",
                                                lambda a: _dense(a, D))
            plan[f"{src}/moe/wi"] = (f"{dst}.moe.wi", cut)
            plan[f"{src}/moe/wo"] = (f"{dst}.moe.wo", cut)
            continue
        for name, fan_in in (("wi", D), ("wo", cfg.d_ff)):
            plan[f"{src}/mlp/{name}/kernel"] = (
                f"{dst}.mlp.{name}.weight", lambda a, n=fan_in: _dense(a, n))
            plan[f"{src}/mlp/{name}/bias"] = (f"{dst}.mlp.{name}.bias", None)
    return plan


def flax_to_torch(params: Mapping, cfg: TransformerConfig, ep: int = 1,
                  ep_rank: int = 0, stages: int = 1, stage: int = 0, tp: int = 1,
                  tp_rank: int = 0, dp: int = 1, dp_rank: int = 0) -> Dict[str, torch.Tensor]:
    """With ``stages`` > 1: the ``state_dict`` of ``PipelinedLM`` stage
    ``stage``, the layers ``[stage·L/stages, (stage+1)·L/stages)`` under
    their global indices, with the embeddings, ``ln_f`` and the head; sp
    cuts no parameter, so it loads that stage on every sp rank. With
    ``tp`` > 1: that of ``TransformerLM`` on tp rank ``tp_rank`` (with
    ``stages`` too, that stage's on that tp rank); with
    ``dp`` > 1, that of ``TransformerLM(rules=FSDP_RULES)`` on dp rank
    ``dp_rank`` (and tp rank ``tp_rank``, or ep rank ``ep_rank``: its
    experts' dp shards)."""
    from ..parallel.pipeline import stage_layers

    return _transformer_to_torch(params, cfg, "lm_head", ep, ep_rank,
                                 stage_layers(cfg.n_layers, stages, stage), tp, tp_rank,
                                 dp, dp_rank)


def bert_flax_to_torch(params: Mapping, cfg: TransformerConfig, tp: int = 1,
                       tp_rank: int = 0) -> Dict[str, torch.Tensor]:
    return _transformer_to_torch(params, cfg, "mlm_head", tp=tp, tp_rank=tp_rank)


def vit_flax_to_torch(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The ``params`` tree of the JAX ``ViT(cfg)`` as the ``state_dict`` of
    ``models.vit.ViT(cfg)``: the patch kernel from HWIO to OIHW, ``cls``,
    ``pos_embedding``, ``ln_f`` and the head (its kernel transposed) across,
    the stack through the transformer's block plan (unstacked first under
    ``scan_layers``)."""
    tcfg = cfg.transformer()
    if tcfg.stacked:
        params = unstack_layers(params, tcfg.n_layers)
    plan = {"patch_embed/kernel": ("patch_embed.weight", _hwio_to_oihw),
            "patch_embed/bias": ("patch_embed.bias", None),
            "cls": ("cls", None),
            "pos_embedding": ("pos_embedding", None),
            "ln_f/scale": ("ln_f.weight", None),
            "ln_f/bias": ("ln_f.bias", None),
            "head/kernel": ("head.weight", lambda a: a.T),
            "head/bias": ("head.bias", None),
            **_stack_plan(tcfg, range(tcfg.n_layers))}
    return _apply_plan(_flatten(params), plan, "params", cfg.param_dtype)


def mnist_flax_to_torch(params: Mapping, model) -> Dict[str, torch.Tensor]:
    """The ``params`` tree of the JAX ``MnistMLP`` or ``MnistCNN`` as the
    ``state_dict`` of ``model``, the port's net of the same kind: flax's
    ``Dense_i`` and ``Conv_i`` in order, kernels (in, out) transposed and
    HWIO to OIHW. ``fc1`` keeps the JAX row order (the port flattens NHWC)."""
    from .mnist import MnistMLP

    if isinstance(model, MnistMLP):
        names = {f"Dense_{i}": f"dense.{i}" for i in range(len(model.dense))}
    else:
        names = {"Conv_0": "conv1", "Conv_1": "conv2", "Dense_0": "fc1", "Dense_1": "fc2"}
    plan = {}
    for src, dst in names.items():
        plan[f"{src}/kernel"] = (f"{dst}.weight",
                                 _hwio_to_oihw if src.startswith("Conv") else (lambda a: a.T))
        plan[f"{src}/bias"] = (f"{dst}.bias", None)
    return _apply_plan(_flatten(params), plan, "params", torch.float32)


def tp_join(shards: Sequence[Mapping[str, torch.Tensor]],
            cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The full model's tensors from the tp ranks' ``state_dict``s (or
    gradients by name), in tp rank order: each tp-cut tensor joined from
    its shards, each replicated one taken from rank 0."""
    out = {}
    for key, t in shards[0].items():
        cut = tp_cut(key, cfg, len(shards), 0)
        out[key] = t if cut is None else cut.join([s[key] for s in shards])
    return out


EXPERT_PARAMS = ("moe.wi", "moe.wo")


def ep_join(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The full model's tensors from the ep ranks' ``state_dict``s (or
    gradients by name), in ep rank order, each already joined over tp
    (``tp_join``): each Switch expert tensor concatenated along its expert
    dimension, each other one taken from ep rank 0."""
    out = {}
    for key, t in shards[0].items():
        expert = key.endswith(tuple("." + n for n in EXPERT_PARAMS))
        out[key] = torch.cat([s[key] for s in shards]) if expert and len(shards) > 1 else t
    return out


def fsdp_join(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The tensors of one tp rank's model from the dp ranks'
    ``state_dict``s (or gradients by name) under ``FSDP_RULES``, in dp rank
    order: each tensor with a d_model dimension joined along it, each other
    one taken from dp rank 0. ``tp_join`` then joins the tp ranks', and
    ``ep_join`` the ep ranks' experts."""
    out = {}
    for key, t in shards[0].items():
        dim = fsdp_dim(key)
        out[key] = t if dim is None or len(shards) == 1 else torch.cat(
            [s[key] for s in shards], dim=dim)
    return out


def _hwio_to_oihw(kernel: np.ndarray) -> np.ndarray:
    return kernel.transpose(3, 2, 0, 1)


def _resnet_block_names(block) -> Dict[str, str]:
    """flax auto-names of one block's convs and norms -> the port's names.
    In a fused bottleneck the block's last norm is the second BatchNorm
    flax creates, so it is ``BatchNorm_1``; unfused, that is the middle
    norm and the last is ``BatchNorm_2``."""
    if isinstance(block, ResNetBlock):
        return {"Conv_0": "conv1", "Conv_1": "conv2",
                "BatchNorm_0": "bn1", "BatchNorm_1": "bn2"}
    if block.fused:
        return {"Conv_0": "conv1", "Conv_1": "conv2",
                "BatchNorm_0": "bn1", "BatchNorm_1": "bn3"}
    return {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
            "BatchNorm_0": "bn1", "BatchNorm_1": "bn2", "BatchNorm_2": "bn3"}


def resnet_flax_to_torch(params: Mapping, batch_stats: Mapping,
                         model: ResNet) -> Dict[str, torch.Tensor]:
    """The ``params`` and ``batch_stats`` trees of the JAX ResNet (nested
    dicts of numpy arrays) as the ``state_dict`` of ``model``, a port
    ResNet of the same configuration. Conv kernels go from HWIO to OIHW,
    the head's (in, out) kernel is transposed, the fused module's kernel
    stays (Cin, Cout). A missing or extra key raises."""
    conv = _hwio_to_oihw
    plan = {"params/conv_init/kernel": ("conv_init.weight", conv),
            "params/head/kernel": ("head.weight", lambda a: a.T),
            "params/head/bias": ("head.bias", None)}

    def norm(src: str, dst: str):
        plan[f"params/{src}/scale"] = (f"{dst}.weight", None)
        plan[f"params/{src}/bias"] = (f"{dst}.bias", None)
        plan[f"batch_stats/{src}/mean"] = (f"{dst}.running_mean", None)
        plan[f"batch_stats/{src}/var"] = (f"{dst}.running_var", None)

    norm("bn_init", "bn_init")
    for i, block in enumerate(model.blocks):
        src, dst = f"{type(block).__name__}_{i}", f"blocks.{i}"
        names = _resnet_block_names(block)
        if block.proj:
            names.update(conv_proj="conv_proj", norm_proj="norm_proj")
        for flax_name, name in names.items():
            if flax_name.startswith(("Conv", "conv")):
                plan[f"params/{src}/{flax_name}/kernel"] = (f"{dst}.{name}.weight", conv)
            else:
                norm(f"{src}/{flax_name}", f"{dst}.{name}")
        if isinstance(block, BottleneckResNetBlock) and block.fused:
            f_src, f_dst = f"{src}/fused_bn_conv3", f"{dst}.fused_bn_conv3"
            for leaf in ("scale", "bias", "kernel"):
                plan[f"params/{f_src}/{leaf}"] = (f"{f_dst}.{leaf}", None)
            plan[f"batch_stats/{f_src}/mean"] = (f"{f_dst}.running_mean", None)
            plan[f"batch_stats/{f_src}/var"] = (f"{f_dst}.running_var", None)

    flat = _flatten({"params": params, "batch_stats": batch_stats})
    return _apply_plan(flat, plan, "params/batch_stats", torch.float32)


def resnet_unfused_state_dict(state_dict: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a fused ResNet as that of the same ResNet built
    without ``fuse_bn_conv_stages``: each ``fused_bn_conv3`` becomes the
    ``bn2`` (its scale, bias and running stats) and the 1x1 ``conv3`` (its
    (Cin, Cout) kernel as (Cout, Cin, 1, 1)) it stands for."""
    out = {}
    for key, t in state_dict.items():
        prefix, sep, leaf = key.partition(".fused_bn_conv3.")
        if not sep:
            out[key] = t
        elif leaf == "kernel":
            out[f"{prefix}.conv3.weight"] = t.t().contiguous()[:, :, None, None]
        else:
            out[f"{prefix}.bn2.{'weight' if leaf == 'scale' else leaf}"] = t
    return out


# optax state fields -> torch optimizer state keys (Adam/AdamW moments, the
# momentum trace, RMSprop's square average; ``nu`` beside ``mu`` is Adam's).
_OPTAX_FIELDS = {"count": "step", "mu": "exp_avg", "trace": "momentum_buffer"}


def _optax_leaves(tree: Any, out: Dict[str, np.ndarray]) -> None:
    """Collect the named array fields of a tree of optax NamedTuple states."""
    if hasattr(tree, "_fields"):
        for field in tree._fields:
            val = getattr(tree, field)
            if hasattr(val, "_fields") or isinstance(val, (tuple, list, Mapping)):
                _optax_leaves(val, out)
            elif val is not None:
                if field in out:
                    raise ValueError(f"optax state holds {field!r} twice")
                out[field] = np.asarray(val)
    elif isinstance(tree, Mapping):
        for val in tree.values():
            _optax_leaves(val, out)
    elif isinstance(tree, (tuple, list)):
        for val in tree:
            _optax_leaves(val, out)


def zero_state_from_jax(state: Any, rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s shard of a JAX ``ZeroState(inner, residual)`` whose
    leaves are stacked over the world (``(world, k)`` moments, ``(world,)``
    counts, as ``zero_init`` and the traced update give them), with the
    optax names mapped to torch's: count -> step, mu -> exp_avg, nu ->
    exp_avg_sq (beside mu; square_avg alone), trace -> momentum_buffer, and
    the residual. A single param group."""
    fields: Dict[str, np.ndarray] = {}
    _optax_leaves(state.inner, fields)
    if getattr(state, "residual", None) is not None:
        fields["residual"] = np.asarray(state.residual)
    group = {}
    for field, arr in fields.items():
        if arr.shape[:1] != (world,):
            raise ValueError(f"leaf {field!r} of shape {arr.shape} is not stacked "
                             f"over a world of {world}")
        key = _OPTAX_FIELDS.get(field, field)
        if field == "nu":
            key = "exp_avg_sq" if "mu" in fields else "square_avg"
        val = torch.from_numpy(np.array(arr[rank], copy=True))
        group[key] = val.to(torch.float32) if key == "step" else val
    return {"world": world, "rank": rank, "groups": [group]}
