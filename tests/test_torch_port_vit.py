"""ViT in the port (``horovod_tpu_torch.models.vit``) against the flax ViT,
the weights carried across by ``vit_flax_to_torch``; the transformer's
``learned_pos=False`` and ``logits_via_embedding`` against the JAX LM; and
dropout, which cannot match JAX's PRNG bits, by its own rules.

* vit-tiny logits, f32 and bf16, and their gradients in f32;
* 3 SGD(0.01, momentum 0.9) steps through ``make_train_step`` against the
  JAX ``make_train_step`` + ``optax.sgd`` on a dp=1 mesh, and the same on
  2 gloo ranks over dp=2 against it;
* dropout: the keep rate and the scale of the kept elements, no dropout in
  a deterministic forward (the default) nor in ``make_train_step`` without
  ``dropout=True``, a forward with ``deterministic=False`` and no key
  raises, remat bitwise no remat at one key, the masks a function of the
  key alone; over tp=2 on 2 gloo ranks, every tp rank draws the same
  masks: the replicated parameters stay bitwise and the run matches the
  world-1 run of the same key.

Tolerances: f32 logits and losses 1e-5 relative (1e-6 absolute), f32
gradients and parameters 1e-5 relative (absolute 1e-6, a tenth of a
thousandth of one SGD update of 0.01 on O(0.1) gradients); bf16 logits
3e-2 (tests/test_torch_port_gpt2.py's); the tp=2 dropout run against
world 1: 1e-5 relative (an f32 sum over 2 shards in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from horovod_tpu.models.transformer import GPT2_CONFIGS as JAX_GPT2
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.models.vit import VIT_CONFIGS as JAX_VIT_CONFIGS
from horovod_tpu.models.vit import ViT as JaxViT
from horovod_tpu.parallel.mesh import create_mesh as jax_create_mesh
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.parallel.train import softmax_xent as jax_softmax_xent

import _torch_port_workers as workers
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import dropout
from horovod_tpu_torch.models.convert import flax_to_torch, vit_flax_to_torch
from horovod_tpu_torch.models.registry import get_model
from horovod_tpu_torch.models.transformer import GPT2_CONFIGS, TransformerLM
from horovod_tpu_torch.models.vit import VIT_CONFIGS, ViT
from horovod_tpu_torch.parallel.train import lm_loss, make_train_step, softmax_xent

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=3e-2, atol=3e-2)
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def cpu_world():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _vit(dtype=torch.float32, **kw):
    cfg = dataclasses.replace(VIT_CONFIGS["vit-tiny"], dtype=dtype, **kw)
    jcfg = dataclasses.replace(JAX_VIT_CONFIGS["vit-tiny"], dtype=JAX_DTYPES[dtype], **kw)
    return cfg, ViT(cfg, device="cpu"), JaxViT(jcfg)


def _params(jmodel, x):
    return jax.tree.map(np.asarray, nn.unbox(jmodel.init(jax.random.PRNGKey(0), x))["params"])


@pytest.fixture(scope="module")
def jax_train():
    """The JAX step on a dp=1 mesh: the initial params, the 3 losses and
    the params after them."""
    images, labels = workers.vit_batch()
    jmodel = JaxViT(dataclasses.replace(JAX_VIT_CONFIGS["vit-tiny"], dtype=jnp.float32))
    build = jax_make_train_step(jmodel, optax.sgd(workers.VIT_LR, momentum=0.9),
                                jax_softmax_xent,
                                mesh=jax_create_mesh({"dp": 1}, devices=jax.devices()[:1]))
    init_fn, step_fn, _ = build(jax.random.PRNGKey(0), images, labels)
    state = init_fn(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state.params)
    losses = []
    for _ in range(workers.VIT_STEPS):
        state, loss = step_fn(state, images, labels)
        losses.append(float(loss))
    return params0, np.array(losses), jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def world(jax_train, tmp_path_factory):
    cfg = dataclasses.replace(VIT_CONFIGS["vit-tiny"], dtype=torch.float32)
    sd = vit_flax_to_torch(jax_train[0], cfg)
    return workers.spawn_world(2, tmp_path_factory.mktemp("vit"), "_run_vit_world", sd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_match_flax(dtype):
    images, _ = workers.vit_batch()
    cfg, model, jmodel = _vit(dtype)
    params = _params(jmodel, images)
    model.load_state_dict(vit_flax_to_torch(params, cfg))
    want = np.asarray(jmodel.apply({"params": params}, images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (workers.VIT_B, cfg.num_classes)
    np.testing.assert_allclose(got.numpy(), want, **(F32 if dtype == torch.float32 else BF16))


def test_gradients_match_flax():
    images, labels = workers.vit_batch()
    cfg, model, jmodel = _vit()
    params = _params(jmodel, images)
    model.load_state_dict(vit_flax_to_torch(params, cfg))
    jgrads = jax.grad(lambda p: jax_softmax_xent(jmodel.apply({"params": p}, images),
                                                 labels))(params)
    want = vit_flax_to_torch(jax.tree.map(np.asarray, jgrads), cfg)
    softmax_xent(model(torch.from_numpy(images)), torch.from_numpy(labels)).backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **F32)


def test_scan_layers_and_registry_match_jax():
    """The scan-stacked JAX layout converts too; the registry holds every
    JAX ViT and its images."""
    images, _ = workers.vit_batch()
    cfg, model, jmodel = _vit(scan_layers=True)
    params = _params(jmodel, images)
    model.load_state_dict(vit_flax_to_torch(params, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply({"params": params}, images)),
                               **F32)
    from horovod_tpu.models.registry import get_model as jax_get_model

    for name in JAX_VIT_CONFIGS:
        np.testing.assert_array_equal(get_model(name).make_batch(2, seed=5)[0],
                                      jax_get_model(name).make_batch(2, seed=5)[0])
        assert dataclasses.asdict(VIT_CONFIGS[name]).keys() == dataclasses.asdict(
            JAX_VIT_CONFIGS[name]).keys()


def test_vit_l16_parameter_count_is_the_jax_closed_form():
    """vit-l16's parameters (on the meta device) against the JAX tree's
    shapes: 304,326,632."""
    jmodel = JaxViT(JAX_VIT_CONFIGS["vit-l16"])
    shapes = jax.eval_shape(lambda: nn.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"])
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = ViT(VIT_CONFIGS["vit-l16"], device="meta")
    assert sum(p.numel() for p in model.parameters()) == want == 304_326_632


def test_three_sgd_steps_match_jax(cpu_world, jax_train):
    params0, jlosses, jparams = jax_train
    cfg = dataclasses.replace(VIT_CONFIGS["vit-tiny"], dtype=torch.float32)
    got = workers.vit_train(hvd, torch, vit_flax_to_torch(params0, cfg),
                            hvd.create_mesh({"dp": 1}))
    np.testing.assert_allclose(got["losses"], jlosses, **F32)
    want = vit_flax_to_torch(jparams, cfg)
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, want[k].numpy(), err_msg=k, **F32)


def test_dp2_on_gloo_matches_jax(world, jax_train):
    _, jlosses, jparams = jax_train
    cfg = dataclasses.replace(VIT_CONFIGS["vit-tiny"], dtype=torch.float32)
    want = vit_flax_to_torch(jparams, cfg)
    for rank in world:
        np.testing.assert_allclose(rank["vit"]["losses"], jlosses, **F32)
        for k, v in rank["vit"]["params"].items():
            np.testing.assert_allclose(v, want[k].numpy(), err_msg=k, **F32)
            np.testing.assert_array_equal(v, world[0]["vit"]["params"][k])


@pytest.mark.parametrize("overrides", [{"learned_pos": False},
                                       {"logits_via_embedding": True},
                                       {"learned_pos": False, "logits_via_embedding": True}])
def test_positions_and_tied_head_match_jax(overrides):
    ids = get_model("gpt2-tiny").make_batch(2, seed=4, seq_len=32)[0]
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32, **overrides)
    jcfg = dataclasses.replace(JAX_GPT2["gpt2-tiny"], dtype=jnp.float32, **overrides)
    jmodel = JaxLM(jcfg)
    # The JAX tied head cannot init (its attend casts the boxed table,
    # ROADMAP C); its apply takes the untied model's params less lm_head.
    params = _params(JaxLM(dataclasses.replace(jcfg, logits_via_embedding=False)),
                     jnp.asarray(ids))
    if cfg.logits_via_embedding:
        del params["lm_head"]
    assert ("pos_embedding" in params["embed"]) == cfg.learned_pos
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(flax_to_torch(params, cfg))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tied_head_on_a_cut_embedding_raises(cpu_world):
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], logits_via_embedding=True)
    mesh = hvd.create_mesh({"dp": 1})
    TransformerLM(cfg, device="cpu", mesh=mesh, rules=FSDP_RULES)   # dp=1: nothing cut
    from horovod_tpu_torch.models.pipelined import PipelinedLM

    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        PipelinedLM(dataclasses.replace(cfg, scan_layers=True),
                    hvd.create_mesh({"pp": 1, "dp": 1}))


def test_dropout_keep_rate_and_scale():
    x = torch.ones(400, 500)
    layer = dropout.Dropout(0.3)
    with dropout.dropout_key(1, 2, 3):
        y = layer(x)
        again = layer(x)
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.3) < 0.005, dropped
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))
    assert torch.equal(y, again)                       # the key decides the mask
    layer.site = 1
    with dropout.dropout_key(1, 2, 3):
        assert not torch.equal(layer(x), y)           # another site, another mask
    with dropout.dropout_key(1, 2, 4):
        layer.site = 0
        assert not torch.equal(layer(x), y)           # another key, another mask
    assert torch.equal(layer(x), x)                    # no key: no dropout


def test_dropout_is_off_when_deterministic():
    images, _ = workers.vit_batch()
    _, model, _ = _vit(dropout_rate=0.5)
    _, plain, _ = _vit()
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(images)
    with torch.no_grad():
        want = plain(x)
        assert torch.equal(model(x), want)
        with dropout.dropout_key(0):
            assert torch.equal(model(x), want)                          # the default
            assert not torch.equal(model(x, deterministic=False), want)
    with pytest.raises(ValueError, match="dropout_key"):
        model(x, deterministic=False)


@pytest.mark.parametrize("name", ["vit", "gpt2"])
def test_remat_redraws_the_forward_masks(name):
    """Under remat the recomputed forward draws the forward's masks: loss
    and every gradient bitwise the run without remat, at one key."""
    def build(remat):
        if name == "vit":
            return _vit(dropout_rate=0.3, remat=remat)[1]
        cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32,
                                  dropout_rate=0.3, remat=remat)
        return TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    images, labels = (torch.from_numpy(a) for a in workers.vit_batch())
    ids = torch.from_numpy(get_model("gpt2-tiny").make_batch(2, seed=2, seq_len=16)[0])
    runs = []
    for remat in (False, True):
        model = build(remat)
        if runs:
            model.load_state_dict(runs[0][2])
        with dropout.dropout_key(5, 0, 0, 0):
            if name == "vit":
                loss = softmax_xent(model(images, deterministic=False), labels)
            else:
                loss = lm_loss(model(ids, deterministic=False), ids)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                     model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for n, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][n]), n


def test_train_step_runs_dropout_only_when_asked(cpu_world):
    mesh = hvd.create_mesh({"dp": 1})

    def run(rate, **kw):
        model = workers.dropout_gpt(torch, mesh, rate)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh, **kw)
        state = init_fn()
        ids = torch.from_numpy(np.random.RandomState(9).randint(0, 128, (4, 16))
                               .astype(np.int32))
        losses = []
        for _ in range(2):
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
        return losses

    plain = run(0.0)
    assert run(workers.DROP_RATE) == plain                               # dropout=False
    first = run(workers.DROP_RATE, dropout=True, dropout_seed=workers.DROP_SEED)
    assert first != plain
    assert run(workers.DROP_RATE, dropout=True, dropout_seed=workers.DROP_SEED) == first
    assert run(workers.DROP_RATE, dropout=True, dropout_seed=1) != first


def test_tp2_draws_the_masks_of_world_1(world, cpu_world):
    want = workers.dropout_train(hvd, torch, hvd.create_mesh({"dp": 1}))
    for rank in world:
        got = rank["dropout_tp"]
        assert got["replicas_bitwise"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, want["params"][k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
