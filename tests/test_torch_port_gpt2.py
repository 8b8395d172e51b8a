"""GPT-2 in the port (horovod_tpu_torch.models) against the flax model, with
the flax weights carried across by ``flax_to_torch``; and one training step
of the port's ``make_train_step`` + AdamW against the JAX ``make_train_step``
+ ``optax.adamw`` (gpt2-tiny, 2 layers, d_model 128).

Tolerances: logits at f32 1e-4, at bf16 3e-2; the loss after one AdamW step
(lr 1e-4, as bench.py trains) at f32 1e-5 relative, and every parameter at
1e-5 relative (absolute floor 1e-7, a thousandth of one step's update)
wherever its gradient exceeds 100 x AdamW's eps. The gradients of the two
agree to ~1e-8 (f32 summation order), but AdamW's first update is
g/(|g|+eps), so where the gradient is within 100 eps of zero (the k-bias
gradient is zero in exact arithmetic: softmax ignores a constant added to
a row's scores) that noise decides the update; there both must still have
moved by at most one step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from horovod_tpu.models.transformer import GPT2_CONFIGS as JAX_CONFIGS
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.mesh import create_mesh as jax_create_mesh
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import flax_to_torch
from horovod_tpu_torch.models.registry import get_model
from horovod_tpu_torch.models.transformer import GPT2_CONFIGS, TransformerLM
from horovod_tpu_torch.parallel.mesh import create_mesh
from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

B, S = 2, 64
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def cpu_world():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _ids(seed=0):
    return get_model("gpt2-tiny").make_batch(B, seed=seed, seq_len=S)[0]


def _models(dtype, attn_impl, **kw):
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=dtype,
                              attn_impl=attn_impl, **kw)
    jcfg = dataclasses.replace(JAX_CONFIGS["gpt2-tiny"], dtype=JAX_DTYPES[dtype],
                               attn_impl=attn_impl,
                               **{k: JAX_DTYPES[v] for k, v in kw.items()})
    return cfg, TransformerLM(cfg), JaxLM(jcfg)


def _flax_params(jmodel, ids):
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,attn_impl,tol", [
    (torch.float32, "dense", 1e-4),
    (torch.float32, "flash", 1e-4),
    (torch.bfloat16, "dense", 3e-2),
    (torch.bfloat16, "flash", 3e-2),
])
def test_logits_match_flax(dtype, attn_impl, tol):
    ids = _ids()
    cfg, model, jmodel = _models(dtype, attn_impl)
    params = _flax_params(jmodel, ids)
    model.load_state_dict(flax_to_torch(params, cfg))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_padding_mask_logits_match_flax():
    ids = _ids(seed=3)
    mask = np.ones((B, S), np.int32)
    mask[1, 40:] = 0
    cfg, model, jmodel = _models(torch.float32, "flash")
    params = _flax_params(jmodel, ids)
    model.load_state_dict(flax_to_torch(params, cfg))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bf16_logits_dtype_is_honoured():
    ids = _ids()
    cfg, model, jmodel = _models(torch.bfloat16, "flash", logits_dtype=torch.bfloat16)
    params = _flax_params(jmodel, ids)
    model.load_state_dict(flax_to_torch(params, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=3e-2, atol=3e-2)


def test_convert_rejects_missing_and_extra_keys():
    ids = _ids()
    cfg, _, jmodel = _models(torch.float32, "dense")
    params = _flax_params(jmodel, ids)
    extra = dict(params, bogus={"kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="bogus"):
        flax_to_torch(extra, cfg)
    missing = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        flax_to_torch(missing, cfg)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_one_adamw_step_matches_jax(cpu_world, attn_impl):
    ids = _ids(seed=1)
    cfg, model, jmodel = _models(torch.float32, attn_impl)
    lr, wd, eps = 1e-4, 1e-4, 1e-8

    build = jax_make_train_step(
        jmodel, optax.adamw(lr, weight_decay=wd, eps=eps), jax_lm_loss,
        mesh=jax_create_mesh({"dp": 1}, devices=jax.devices()[:1]))
    init_fn, step_fn, _ = build(jax.random.PRNGKey(0), ids, ids)
    jstate = init_fn(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, jstate.params)
    grads = flax_to_torch(jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_lm_loss(jmodel.apply({"params": p}, jnp.asarray(ids)),
                              jnp.asarray(ids)))(params0)), cfg)
    model.load_state_dict(flax_to_torch(params0, cfg))
    jstate, jloss = step_fn(jstate, ids, ids)
    want = flax_to_torch(jax.tree.map(np.asarray, jstate.params), cfg)

    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=lr, weight_decay=wd, eps=eps))
    t_init, t_step = make_train_step(model, opt, lm_loss, mesh=create_mesh({"dp": 1}))
    state = t_init()
    state, loss = t_step(state, torch.from_numpy(ids), torch.from_numpy(ids))
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        g, a, w = grads[key].numpy(), got[key].numpy(), want[key].numpy()
        well = np.abs(g) > 100 * eps
        assert well.any(), key
        np.testing.assert_allclose(a[well], w[well], rtol=1e-5, atol=1e-7,
                                   err_msg=key)
        assert np.all(np.abs(a[~well] - w[~well]) <= 2.0001 * lr), key
