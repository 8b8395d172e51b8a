"""The MNIST nets of the port (``horovod_tpu_torch.models.mnist``) against
the flax ones, the weights carried across by ``mnist_flax_to_torch``, and
``train_mnist`` on 2 gloo ranks against a JAX control.

* ``MnistMLP`` and ``MnistCNN`` (deterministic) logits and gradients at f32
  on the registry's seeded (B, 28, 28, 1) images, and on (B, 28, 28);
* 3 SGD(0.01, momentum 0.9) steps of each net through ``make_train_step``
  against the JAX ``make_train_step`` + ``optax.sgd`` on a dp=1 mesh;
* ``MnistCNN``'s dropout: none in a deterministic forward, half the fc1
  activations dropped under a key;
* ``train_mnist`` (3 steps of 16 images a rank) on 2 ranks: every rank
  bitwise the same parameters; each rank's losses and the parameters
  after 3 steps against the JAX ``MnistCNN`` from the same initial weights
  trained by ``optax.adam(lr · 2)`` on the mean of the two shards'
  gradients, each shard walked in ``RandomState(0)``'s order; the
  synthetic set is the JAX example's.

Tolerances: logits and gradients 1e-5 relative (absolute 1e-6: f32 sums in
another order); the losses of the training run 1e-5 relative, the
parameters 1e-5 relative, absolute 1e-6 (a two-thousandth of one Adam
step of 0.002) wherever the mean gradient was zero at every step or
exceeded 100 x Adam's eps at every step. Adam's update is about m / sqrt(v), so where the two shards'
gradients cancel to within 100 eps the summation order decides it (as in
tests/test_torch_port_gpt2.py); there the two may differ by at most the
3 steps' 0.006.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.mnist import MnistCNN as JaxCNN
from horovod_tpu.models.mnist import MnistMLP as JaxMLP
from horovod_tpu.models.registry import get_model as jax_get_model
from horovod_tpu.parallel.mesh import create_mesh as jax_create_mesh
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.parallel.train import softmax_xent as jax_softmax_xent

import _torch_port_workers as workers
import horovod_tpu_torch as hvd
from horovod_tpu_torch import train_mnist
from horovod_tpu_torch.models import dropout
from horovod_tpu_torch.models.convert import mnist_flax_to_torch
from horovod_tpu_torch.models.mnist import MnistCNN, MnistMLP
from horovod_tpu_torch.models.registry import get_model
from horovod_tpu_torch.parallel.train import make_train_step, softmax_xent

TOL = dict(rtol=1e-5, atol=1e-6)
NETS = {"mnist-mlp": (MnistMLP, JaxMLP), "mnist-cnn": (MnistCNN, JaxCNN)}


def _jax_xent(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.sum(jax.nn.one_hot(labels, 10) * logp, axis=-1))


def _to_flax(sd: dict, cnn: bool) -> dict:
    """The port's ``state_dict`` (numpy) as the flax params tree."""
    names = ({"conv1": "Conv_0", "conv2": "Conv_1", "fc1": "Dense_0", "fc2": "Dense_1"}
             if cnn else {f"dense.{i}": f"Dense_{i}" for i in range(3)})
    out = {}
    for src, dst in names.items():
        w = np.asarray(sd[f"{src}.weight"])
        out[dst] = {"kernel": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T,
                    "bias": np.asarray(sd[f"{src}.bias"])}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return workers.spawn_world(2, tmp_path_factory.mktemp("mnist"), "_run_mnist_world")


@pytest.mark.parametrize("squeeze", [False, True])
@pytest.mark.parametrize("name", list(NETS))
def test_logits_and_gradients_match_flax(name, squeeze):
    images = get_model(name).make_batch(4, seed=6)[0]
    np.testing.assert_array_equal(images, jax_get_model(name).make_batch(4, seed=6)[0])
    if squeeze:
        images = images[..., 0]
    labels = np.arange(4, dtype=np.int32) * 3
    cls, jcls = NETS[name]
    jmodel = jcls()
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), images)["params"])
    model = cls(device="cpu")
    model.load_state_dict(mnist_flax_to_torch(params, model))
    want = np.asarray(jmodel.apply({"params": params}, images))
    got = model(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    jgrads = jax.grad(lambda p: _jax_xent(jmodel.apply({"params": p}, images), labels))(params)
    want_g = mnist_flax_to_torch(jax.tree.map(np.asarray, jgrads), model)
    softmax_xent(got, torch.from_numpy(labels)).backward()
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(NETS))
def test_three_sgd_steps_match_jax(name):
    images = get_model(name).make_batch(8, seed=2)[0]
    labels = (np.arange(8, dtype=np.int32) * 7) % 10
    cls, jcls = NETS[name]
    build = jax_make_train_step(jcls(), optax.sgd(0.01, momentum=0.9), jax_softmax_xent,
                                mesh=jax_create_mesh({"dp": 1}, devices=jax.devices()[:1]))
    init_fn, step_fn, _ = build(jax.random.PRNGKey(0), images, labels)
    jstate = init_fn(jax.random.PRNGKey(0))
    model = cls(device="cpu")
    model.load_state_dict(mnist_flax_to_torch(jax.tree.map(np.asarray, jstate.params), model))
    jlosses = []
    for _ in range(3):
        jstate, loss = step_fn(jstate, images, labels)
        jlosses.append(float(loss))
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        init, step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.01,
                                                            momentum=0.9),
                                     softmax_xent, mesh=hvd.create_mesh({"dp": 1}))
        state, losses = init(), []
        for _ in range(3):
            state, loss = step(state, torch.from_numpy(images), torch.from_numpy(labels))
            losses.append(float(loss))
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = mnist_flax_to_torch(jax.tree.map(np.asarray, jstate.params), model)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **TOL)


def test_cnn_dropout_only_under_a_key():
    model = MnistCNN(device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(get_model("mnist-cnn").make_batch(64, seed=1)[0])
    seen = {}
    model.fc2.register_forward_hook(lambda m, inp, out: seen.update(x=inp[0]))
    with torch.no_grad():
        plain = model(x)
        kept = seen["x"]                   # relu(fc1), nothing dropped
        with dropout.dropout_key(3):
            assert torch.equal(model(x), plain)
            dropped = model(x, deterministic=False)
            masked = seen["x"]
    assert not torch.equal(dropped, plain)
    alive = kept != 0
    zeroed = float((masked[alive] == 0).float().mean())
    assert abs(zeroed - 0.5) < 0.05, zeroed
    torch.testing.assert_close(masked[alive & (masked != 0)], 2 * kept[alive & (masked != 0)],
                               rtol=0, atol=0)


def test_synthetic_set_is_the_jax_examples():
    spec = importlib.util.spec_from_file_location(
        "jax_mnist", Path(__file__).resolve().parent.parent / "examples" / "jax_mnist.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for a, b in zip(train_mnist.synthetic_mnist(256, seed=2), example.synthetic_mnist(256, seed=2)):
        np.testing.assert_array_equal(a, b)


def _jax_control(initial: dict, size: int, steps: int, batch: int, lr: float):
    """Each shard's losses and the params after ``steps`` Adam(lr · size)
    steps on the mean of the shards' gradients."""
    x, y = train_mnist.synthetic_mnist()
    shards = [(x[r::size], y[r::size]) for r in range(size)]
    jmodel = JaxCNN()
    params = jax.tree.map(jnp.asarray, _to_flax(initial, cnn=True))
    tx = optax.adam(lr * size)
    state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bx, by: _jax_xent(jmodel.apply({"params": p}, bx), by)))
    losses = [[] for _ in range(size)]
    smallest = jax.tree.map(lambda p: np.full(p.shape, np.inf, np.float32), params)
    largest = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    for i in range(steps):
        grads = []
        for r, (xs, ys) in enumerate(shards):
            idx = np.random.RandomState(0).permutation(len(xs))[i * batch:(i + 1) * batch]
            loss, g = grad_fn(params, xs[idx], ys[idx])
            losses[r].append(float(loss))
            grads.append(g)
        mean = jax.tree.map(lambda *gs: sum(gs) / size, *grads)
        smallest = jax.tree.map(lambda s, g: np.minimum(s, np.abs(np.asarray(g))),
                                smallest, mean)
        largest = jax.tree.map(lambda s, g: np.maximum(s, np.abs(np.asarray(g))),
                               largest, mean)
        updates, state = tx.update(mean, state, params)
        params = optax.apply_updates(params, updates)
    # Noisy: at some step within 100 eps of zero, at some step not zero.
    noisy = jax.tree.map(lambda lo, hi: (lo <= 100 * 1e-8) & (hi > 0), smallest, largest)
    return losses, jax.tree.map(np.asarray, params), noisy


def test_two_rank_train_mnist_matches_the_jax_control(world):
    for rank in world[1:]:
        for k, v in rank["final"].items():
            np.testing.assert_array_equal(v, world[0]["final"][k], err_msg=k)
        for k, v in rank["initial"].items():
            np.testing.assert_array_equal(v, world[0]["initial"][k], err_msg=k)
    losses, params, noisy = _jax_control(world[0]["initial"], 2, 3, 16, 0.001)
    for r, rank in enumerate(world):
        np.testing.assert_allclose(rank["losses"], losses[r], rtol=1e-5)
    model = MnistCNN(device="cpu")
    want = mnist_flax_to_torch(params, model)
    noisy = mnist_flax_to_torch(noisy, model)
    for k, v in world[0]["final"].items():
        w, small = want[k].numpy(), noisy[k].numpy() > 0
        np.testing.assert_allclose(v[~small], w[~small], err_msg=k, **TOL)
        assert np.all(np.abs(v[small] - w[small]) <= 3 * 0.002 + 1e-6), k
    assert world[0]["accuracy"] is not None and world[1]["accuracy"] is None
