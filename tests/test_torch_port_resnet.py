"""ResNet-50 in the port (horovod_tpu_torch.models.resnet) against the flax
model, with the flax variables carried across by ``resnet_flax_to_torch``:
a small ResNet-50 (num_filters 8, 10 classes, 32x32 images, B=4), with the
fused BN + ReLU + 1x1-conv tail in stage 1 (``fuse_bn_conv_stages=(1,)``,
the Pallas kernel in interpret mode on the JAX side) and without. Every
norm's scale, bias and running stats are drawn at random first, so the
zero-initialised last norm of each block does not hide the block's output.

Held against the JAX package: logits and updated batch_stats in train
mode, logits in eval mode, the loss, and one SGD-momentum step of
``make_train_step`` (the optax.sgd(0.01, momentum=0.9) of bench.py) against
the JAX ``make_train_step`` at dp=1; and two spawned gloo ranks, one
half-batch each, against the JAX step on a 2-device mesh, whose batch
statistics are over the global batch.

Tolerances (f32): logits, loss, running stats and parameters after the
step at 1e-3 relative, 2e-4 absolute. At this size train-mode BN sees 4
values per channel in stage 3 and amplifies f32 rounding about 300x:
1e-7 relative noise on the images moves the flax model's own logits by
~6e-5 (max |logit| ~1.6), and the two frameworks sum in other orders.
bf16 logits in eval mode (running stats, well conditioned) at 5e-2; in
train mode bf16 rounding alone moves the logits by O(1) at this size.
"""
import dataclasses
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from horovod_tpu.models.resnet import ResNet50 as JaxResNet50
from horovod_tpu.parallel.mesh import create_mesh as jax_create_mesh
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.parallel.train import softmax_xent as jax_softmax_xent

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import resnet_flax_to_torch, resnet_unfused_state_dict
from horovod_tpu_torch.models.registry import get_model
from horovod_tpu_torch.models.resnet import Conv, _same_pads
from horovod_tpu_torch.parallel.mesh import create_mesh
from horovod_tpu_torch.parallel.train import make_train_step, softmax_xent

import _torch_port_workers as workers

B, HW, NF, NC = 4, 32, 8, 10
FUSES = {"fused": (1,), "unfused": ()}
TOL = dict(rtol=1e-3, atol=2e-4)
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def cpu_world():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _batch():
    """bench.py's draw (images uniform in [0, 1), integer labels), small."""
    rng = np.random.RandomState(42)
    images = rng.rand(B, HW, HW, 3).astype(np.float32)
    labels = rng.randint(0, NC, size=(B,), dtype=np.int32)
    return images, labels


def _jax_model(fuse, dtype=torch.float32):
    return JaxResNet50(num_filters=NF, num_classes=NC, fuse_bn_conv_stages=FUSES[fuse],
                       dtype=JAX_DTYPES[dtype])


def _torch_model(fuse, dtype=torch.float32):
    return get_model("resnet50").make_model(device="cpu", num_filters=NF, num_classes=NC,
                                            fuse_bn_conv_stages=FUSES[fuse], dtype=dtype)


def _perturb(tree, rng, leaves):
    """Redraw the named leaves: the zero-initialised norm scales in [0.2,
    0.3), norm biases and running means small around 0, running variances
    in [0.5, 1.5). (Unit-scale norms with biases of 0.1 make train mode
    ill-conditioned at this size: 1e-7 relative noise on the images moves
    the flax model's own logits by 1e-2.)"""
    def redraw(path, a):
        name, a = path[-1].key, np.asarray(a)
        if name not in leaves:
            return a
        if name == "scale":
            return np.where(a == 0, 0.2 + 0.1 * rng.rand(*a.shape), a).astype(a.dtype)
        if name == "var":
            return (0.5 + rng.rand(*a.shape)).astype(a.dtype)
        return (0.01 * rng.randn(*a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(redraw, tree)


_VARS = {}


def _flax_vars(fuse):
    """(params, batch_stats) of the flax model, norms redrawn; numpy."""
    if fuse not in _VARS:
        images, _ = _batch()
        v = nn.unbox(_jax_model(fuse).init(jax.random.PRNGKey(0), jnp.asarray(images)))
        rng = np.random.RandomState(3)
        params = _perturb(v["params"], rng, ("scale", "bias"))
        stats = _perturb(v["batch_stats"], rng, ("mean", "var"))
        _VARS[fuse] = (params, stats)
    return _VARS[fuse]


def _loaded(fuse, dtype=torch.float32):
    model = _torch_model(fuse, dtype)
    model.load_state_dict(resnet_flax_to_torch(*_flax_vars(fuse), model))
    return model


def _assert_state_close(got, want, keys=None):
    assert set(got) == set(want)
    for key in keys or want:
        np.testing.assert_allclose(got[key].detach().numpy(), want[key].numpy(),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("fuse", list(FUSES))
def test_train_mode_logits_and_batch_stats_match_flax(fuse):
    images, _ = _batch()
    params, stats = _flax_vars(fuse)
    want, upd = _jax_model(fuse).apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(images), train=True,
                                       mutable=["batch_stats"])
    model = _loaded(fuse)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (B, NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_sd = resnet_flax_to_torch(params, jax.tree.map(np.asarray, upd["batch_stats"]),
                                   model)
    _assert_state_close(model.state_dict(), want_sd,
                        [k for k in want_sd if "running" in k])


@pytest.mark.parametrize("fuse", list(FUSES))
def test_eval_mode_logits_match_flax(fuse):
    images, _ = _batch()
    params, stats = _flax_vars(fuse)
    want = _jax_model(fuse).apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(images), train=False)
    model = _loaded(fuse)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert all(torch.equal(model.state_dict()[k], v)
               for k, v in resnet_flax_to_torch(params, stats, model).items())


@pytest.mark.parametrize("fuse", list(FUSES))
def test_bf16_eval_logits_match_flax(fuse):
    images, _ = _batch()
    params, stats = _flax_vars(fuse)
    want = _jax_model(fuse, torch.bfloat16).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(images), train=False)
    model = _loaded(fuse, torch.bfloat16)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2, atol=5e-2)


def _jax_step(fuse, n_dev):
    """One step of the JAX make_train_step on an n_dev mesh from the
    redrawn variables: (loss, params, batch_stats) as numpy."""
    images, labels = _batch()
    params, stats = _flax_vars(fuse)
    mesh = jax_create_mesh({"dp": n_dev}, devices=jax.devices()[:n_dev])
    build = jax_make_train_step(_jax_model(fuse),
                                optax.sgd(workers.RESNET_LR, momentum=workers.RESNET_MOMENTUM),
                                jax_softmax_xent, mesh=mesh, has_batch_stats=True)
    init_fn, step_fn, _ = build(jax.random.PRNGKey(0), images, labels)
    state = init_fn(jax.random.PRNGKey(0))
    state = dataclasses.replace(
        state, params=jax.tree.map(jnp.asarray, params),
        extra={"batch_stats": jax.tree.map(jnp.asarray, stats)})
    state, loss = step_fn(state, images, labels)
    return (float(loss), jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.extra["batch_stats"]))


@pytest.mark.parametrize("fuse", list(FUSES))
def test_one_sgd_momentum_step_matches_jax(cpu_world, fuse):
    images, labels = _batch()
    jloss, jparams, jstats = _jax_step(fuse, 1)
    model = _loaded(fuse)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=workers.RESNET_LR, momentum=workers.RESNET_MOMENTUM))
    init_fn, step_fn = make_train_step(model, opt, softmax_xent, mesh=create_mesh({"dp": 1}))
    state = init_fn()
    model.eval()   # the step itself must switch to train mode
    state, loss = step_fn(state, torch.from_numpy(images), torch.from_numpy(labels))
    assert state.step == 1 and model.training
    np.testing.assert_allclose(float(loss), jloss, **TOL)
    _assert_state_close(model.state_dict(), resnet_flax_to_torch(jparams, jstats, model))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    images, labels = _batch()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_file = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=workers.resnet_worker,
                         args=(r, 2, init_file, queue, _flax_vars("fused"), images,
                               labels, FUSES["fused"]))
             for r in range(2)]
    for p in procs:
        p.start()
    results = dict(queue.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    for r, res in results.items():
        assert isinstance(res, dict), f"rank {r} failed:\n{res}"
    return [results[r] for r in range(2)]


def test_two_ranks_use_global_batch_statistics(two_ranks):
    """Each rank holds half the batch; the step's BN statistics (in the
    plain norms and the fused module) are over the whole batch, as on the
    JAX 2-device mesh, so the loss, parameters and running stats agree with
    it and the two ranks agree bitwise."""
    jloss, jparams, jstats = _jax_step("fused", 2)
    want = resnet_flax_to_torch(jparams, jstats, _torch_model("fused"))
    for res in two_ranks:
        np.testing.assert_allclose(float(res["loss"]), jloss, **TOL)
        got = {k: torch.from_numpy(v) for k, v in res.items() if k != "loss"}
        _assert_state_close(got, want)
    for key in want:
        np.testing.assert_array_equal(two_ranks[0][key], two_ranks[1][key], err_msg=key)


def test_one_rank_statistics_differ_from_half_batch():
    """Control for the test above: a rank's half batch alone gives other
    running stats, so agreement there is not an accident of the data."""
    images, _ = _batch()
    model = _loaded("fused")
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(images[:2]))
    half = model.state_dict()["bn_init.running_mean"].clone()
    model = _loaded("fused")
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(images))
    assert not torch.allclose(half, model.state_dict()["bn_init.running_mean"], rtol=1e-3)


@pytest.mark.parametrize("size,stride", [(8, 2), (7, 2), (8, 1)])
def test_same_padding_matches_flax_conv(size, stride):
    """flax "SAME": a stride-2 3x3 conv on an even input pads (0, 1)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    conv = nn.Conv(6, (3, 3), (stride, stride), use_bias=False, dtype=jnp.float32)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = conv.apply(params, jnp.asarray(x))
    mod = Conv(4, 6, 3, stride, dtype=torch.float32)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(
            np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
    got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if (size, stride) == (8, 2):
        assert _same_pads(size, 3, stride) == (0, 1)


def test_unfused_state_dict_carries_the_fused_weights():
    """The fused model's weights, carried to the unfused model, give the
    same train-mode logits and running stats: the comparison chip_smoke.py
    makes on the card."""
    images, _ = _batch()
    fused = _loaded("fused")
    unfused = _torch_model("unfused")
    unfused.load_state_dict(resnet_unfused_state_dict(fused.state_dict()))
    fused.train()
    unfused.train()
    with torch.no_grad():
        a, b = fused(torch.from_numpy(images)), unfused(torch.from_numpy(images))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    want = resnet_unfused_state_dict(fused.state_dict())
    _assert_state_close(unfused.state_dict(), want)


def test_convert_rejects_missing_and_extra_keys():
    params, stats = _flax_vars("fused")
    model = _torch_model("fused")
    with pytest.raises(KeyError, match="bogus"):
        resnet_flax_to_torch(dict(params, bogus={"kernel": np.zeros(1)}), stats, model)
    with pytest.raises(KeyError, match="head"):
        resnet_flax_to_torch({k: v for k, v in params.items() if k != "head"}, stats, model)
    # The unfused model has other names in the fused stage.
    with pytest.raises(KeyError, match="fused_bn_conv3"):
        resnet_flax_to_torch(params, stats, _torch_model("unfused"))


def test_registry_resnet_entries():
    for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152"):
        spec = get_model(name)
        assert spec.kind == "image"
    (images,) = get_model("resnet50").make_batch(2, seed=0)
    want = np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32)
    np.testing.assert_array_equal(images, want)
    model = get_model("resnet18").make_model(device="cpu", num_filters=8, num_classes=3)
    with torch.no_grad():
        out = model(torch.rand(2, 32, 32, 3))
    assert out.shape == (2, 3) and out.dtype == torch.float32
