"""JAX-side references for tests/test_torch_port_{zero_mesh,fsdp,fsdp_sp,fsdp_moe}.py: the
JAX model of ``_torch_port_workers.zm_config``, its weights drawn with
numpy, and the JAX ``make_train_step`` on a CPU mesh of the same shape;
``shared``, the session-wide cache of an expensive fixture under xdist
(tests/test_torch_port_{pp_tp,pp_sp}.py)."""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from filelock import FileLock
from flax import linen as nn
from jax.sharding import Mesh

from horovod_tpu.models.transformer import GPT2_CONFIGS
from horovod_tpu.models.transformer import TransformerLM
from horovod_tpu.parallel.sharding import DEFAULT_RULES
from horovod_tpu.parallel.train import TrainState
from horovod_tpu.parallel.train import lm_loss
from horovod_tpu.parallel.train import make_train_step

import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import flax_to_torch

# The tolerances of tests/test_torch_port_tp.py: the f32 parity tests'
# parameters (where the step-1 gradient exceeds 100 x AdamW's eps), and
# bf16's logits tolerance for losses and parameters.
F32_LOSS_RTOL = 1e-5
F32_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=5e-2, atol=2e-2)


def shared(tmp_path_factory, name: str, make):
    """``make()``, computed once per session: under xdist the first worker
    to ask computes it and the others read its pickle."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return make()
    path = tmp_path_factory.getbasetemp().parent / f"torch_port_{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = make()
        with open(path, "wb") as f:
            pickle.dump(out, f)
    return out


def model(dtype: str = "float32", **overrides) -> TransformerLM:
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], vocab_size=workers.ZM_VOCAB,
                              d_model=32, n_heads=4, d_ff=64, max_len=workers.ZM_S,
                              dtype=getattr(jnp, dtype), **overrides)
    return TransformerLM(cfg)


def numpy_params(seed: int = 0, **overrides):
    """The JAX model's parameter tree (the config's ``overrides`` applied:
    Switch experts) drawn with numpy: kernels, embeddings, experts and
    biases normal(0, 0.02), LayerNorm scales 1 + normal(0, 0.1), so a
    misplaced bias or a wrong cut shows."""
    ids = workers.zm_ids()
    shapes = jax.eval_shape(
        lambda: nn.unbox(model(**overrides).init(jax.random.PRNGKey(0), ids))["params"])
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


def mesh(shape: dict) -> Mesh:
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


MOE_FIELDS = ("n_experts", "moe_every", "capacity_factor")


def routes(jmodel, params, ids) -> tuple:
    """Each Switch FFN's expert per token of ``ids`` (b·S + s order) and its
    dropped tokens, from the flax router's logits."""
    cfg = jmodel.cfg
    _, inter = jmodel.apply({"params": params}, jnp.asarray(ids),
                            capture_intermediates=True, mutable=["intermediates"])
    C = max(1, int(cfg.capacity_factor * ids.size / cfg.n_experts))
    stack = inter["intermediates"]["stack"]
    got, dropped = [], []
    for layer in sorted((k for k in stack if k.startswith("layer_")),
                        key=lambda k: int(k[len("layer_"):])):
        if "moe" in stack[layer]:
            idx = np.asarray(stack[layer]["moe"]["router"]["__call__"][0]).argmax(-1)
            got.append(idx.reshape(-1))
            dropped.append(int(np.maximum(np.bincount(idx.reshape(-1),
                                                      minlength=cfg.n_experts) - C, 0).sum()))
    return got, dropped


def train(shape: dict, params, dtype: str = "float32", zero: bool = False,
          rules=DEFAULT_RULES, shard_seq: bool = False, moe_aux_weight: float = 0.0,
          **overrides) -> dict:
    """ZM_STEPS AdamW steps of the JAX ``make_train_step`` (plain
    ``optax.adamw``, ``zero=``, ``rules=``, ``shard_seq=``,
    ``moe_aux_weight=``) on a CPU mesh of ``shape`` from ``params``, the
    model's config ``overrides`` applied (an attention route, Switch
    experts): the losses, the final parameters and the f32 step-1 gradients
    (of ``lm_loss`` plus the weighted auxiliary loss) in the port's full
    layout, and the parameters' shardings; with experts, each step's routes
    and dropped tokens before it (the f32 model with dense attention)."""
    jmodel = model(dtype, **overrides)
    moe = {k: v for k, v in overrides.items() if k in MOE_FIELDS}
    cfg = workers.zm_config(torch, dtype, **overrides)
    ids = workers.zm_ids()
    tx = optax.adamw(workers.ZM_LR, weight_decay=workers.ZM_WD, eps=workers.ZM_EPS)
    build = make_train_step(jmodel, tx, lm_loss, mesh=mesh(shape), rules=rules, zero=zero,
                            shard_seq=shard_seq, moe_aux_weight=moe_aux_weight)
    _, step_fn, shardings = build(jax.random.PRNGKey(0), ids, ids)
    state = jax.device_put(TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      opt_state=tx.init(params)), shardings)
    f32 = model("float32", **moe)

    def objective(p):
        logits, upd = f32.apply({"params": p}, jnp.asarray(ids), mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(upd.get("losses", {})))
        return lm_loss(logits, jnp.asarray(ids)) + moe_aux_weight * aux

    grads = jax.grad(objective)(params)
    losses, by_step = [], []
    for _ in range(workers.ZM_STEPS):
        if moe.get("n_experts"):
            by_step.append(routes(f32, jax.tree.map(np.asarray, state.params), ids))
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    return {"losses": np.array(losses), "shardings": shardings.params,
            "params": flax_to_torch(jax.tree.map(np.asarray, state.params), cfg),
            "grads": flax_to_torch(jax.tree.map(np.asarray, grads), cfg),
            "routes": [r for r, _ in by_step], "dropped": np.array([d for _, d in by_step])}


def assert_params_match(got: dict, want: dict, dtype: str) -> None:
    """The port's joined parameters against JAX's: f32 at F32_PARAM_TOL
    where the step-1 gradient exceeds 100 x eps (AdamW moves the rest by
    noise, up to lr a step), bf16 at BF16_TOL."""
    assert sorted(got) == sorted(want["params"])
    for key, w in want["params"].items():
        a, w = got[key].numpy(), w.numpy()
        assert a.shape == w.shape, key
        if dtype != "float32":
            np.testing.assert_allclose(a, w, err_msg=key, **BF16_TOL)
            continue
        well = np.abs(want["grads"][key].numpy()) > 100 * workers.ZM_EPS
        np.testing.assert_allclose(a[well], w[well], err_msg=key, **F32_PARAM_TOL)
        assert np.all(np.abs(a[~well] - w[~well])
                      <= 2.0001 * workers.ZM_LR * workers.ZM_STEPS), key


def torch_shard_shapes(shardings, params) -> dict:
    """Each parameter's shard shape under the JAX shardings, in the port's
    layout (kernels (in..., out...) as (out, in), the qkv bias flat)."""
    # The number of leading "in" dimensions of each kernel.
    fan_in = {"qkv": 1, "out": 2, "wi": 1, "wo": 1, "lm_head": 1, "router": 1}
    out = {}
    for (path, sh), (_, leaf) in zip(jax.tree_util.tree_leaves_with_path(shardings),
                                     jax.tree_util.tree_leaves_with_path(params)):
        keys = [k.key for k in path]
        s = tuple(sh.shard_shape(leaf.shape))
        if keys[-1] == "kernel":
            k = fan_in[keys[-2]]
            s = (int(np.prod(s[k:])), int(np.prod(s[:k])))
        elif keys[-1] == "bias":
            s = (int(np.prod(s)),)
        name = ".".join(keys).replace("kernel", "weight").replace("scale", "weight")
        out[name.replace("layer_", "layers.")] = s
    return out
