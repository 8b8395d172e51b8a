"""BERT in the port (``TransformerEncoder``) and its gradient transforms
against the JAX package, on bert-tiny (2 layers, d_model 128, vocab 30522)
with the flax weights carried across by ``bert_flax_to_torch``.

* Logits against the flax ``TransformerEncoder``, dense and flash (the JAX
  flash kernel in interpret mode, the port's plain version on the CPU), at
  S = 64 and 96, unmasked and with a key padding mask: f32 at 1e-4, bf16 at
  3e-2.
* ``distributed_value_and_grad`` and ``DistributedGradientTape`` of the LM
  loss against the JAX functions: on one rank, and on 2 gloo ranks with
  rank-dependent batches against the JAX ``distributed_value_and_grad`` in
  ``shard_map`` on a 2-device mesh. Values and gradients at 1e-5 relative
  with a 1e-7 absolute floor (f32; the two frameworks sum in other orders).
* ``Compression.fp16``'s wire cast bitwise equal to ``astype(jnp.bfloat16)``
  (``true_fp16``'s to ``astype(jnp.float16)``), and
  ``DistributedOptimizer(compression=Compression.fp16)`` on 2 ranks against
  the JAX ``DistributedOptimizer`` with the same compression at one bf16 ulp
  (2**-8 relative), its reduced gradient exactly a bf16 value (the sum ran
  in bf16).
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
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_jax
from horovod_tpu.models.transformer import BERT_CONFIGS as JAX_CONFIGS
from horovod_tpu.common.types import ReduceOp
from horovod_tpu.models.transformer import TransformerEncoder as JaxEncoder
from horovod_tpu.ops import traced
from horovod_tpu.ops.compression import Compression as JaxCompression
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.utils.compat import shard_map

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import bert_flax_to_torch
from horovod_tpu_torch.models.registry import get_model
from horovod_tpu_torch.models.transformer import BERT_CONFIGS, TransformerEncoder

import _torch_port_workers as workers

B = 4
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
BF16_ULP = 2.0 ** -8


@pytest.fixture
def cpu_world():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(scope="module")
def flax_params():
    """bert-tiny's flax parameters (the same for every dtype and attention
    implementation: both keep f32 parameters)."""
    ids, _ = workers.bert_batch(B, 64)
    params = JaxEncoder(JAX_CONFIGS["bert-tiny"]).init(jax.random.PRNGKey(0),
                                                       jnp.asarray(ids))
    return jax.tree.map(np.asarray, nn.unbox(params)["params"])


def _jax_model(dtype=torch.float32, attn_impl="dense"):
    return JaxEncoder(dataclasses.replace(JAX_CONFIGS["bert-tiny"],
                                          dtype=JAX_DTYPES[dtype], attn_impl=attn_impl))


def _jax_loss(jmodel):
    def loss(p, ids, mask):
        return jax_lm_loss(jmodel.apply({"params": p}, ids, mask), ids)

    return loss


def _batch(S, padded):
    ids, mask = workers.bert_batch(B, S)
    return ids, (mask if padded else np.ones_like(mask))


def _assert_grads(got, want_flax, cfg, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    want = bert_flax_to_torch(jax.tree.map(np.asarray, want_flax), cfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key].numpy(), rtol=rtol, atol=atol,
                                   err_msg=key)


def test_registry_and_configs():
    spec = get_model("bert-base")
    assert spec.kind == "encoder"
    assert spec.make_batch(2)[0].shape == (2, 128)
    for name, cfg in BERT_CONFIGS.items():
        jcfg = JAX_CONFIGS[name]
        for f in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_len",
                  "causal"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
    model = get_model("bert-tiny").make_model(device="cpu", causal=True)
    assert model.cfg.causal is False
    assert "mlm_head.weight" in model.state_dict() and not hasattr(model, "lm_head")


@pytest.mark.parametrize("padded", [False, True], ids=["unmasked", "padded"])
@pytest.mark.parametrize("S", [64, 96])
@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_logits_match_flax(flax_params, dtype, tol, attn_impl, S, padded):
    ids, mask = _batch(S, padded)
    cfg = dataclasses.replace(BERT_CONFIGS["bert-tiny"], dtype=dtype, attn_impl=attn_impl)
    model = TransformerEncoder(cfg, device="cpu")
    model.load_state_dict(bert_flax_to_torch(flax_params, cfg))
    want = np.asarray(_jax_model(dtype, attn_impl).apply(
        {"params": flax_params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _jax_value_and_grads(n, attn_impl, params, ids, mask):
    """The JAX ``distributed_value_and_grad`` and ``DistributedGradientTape``
    in ``shard_map`` on a mesh of ``n`` CPU devices, the batch split over
    it: {name: (each rank's value, the gradients)}."""
    hvd_jax.shutdown()
    hvd_jax.init(devices=jax.devices()[:n])
    try:
        loss = _jax_loss(_jax_model(attn_impl=attn_impl))
        fns = {"vag": hvd_jax.distributed_value_and_grad(loss, axis_name="hvd"),
               "tape": hvd_jax.DistributedGradientTape(loss, axis_name="hvd").gradient}
        out = {}
        for name, fn in fns.items():
            def body(p, x, m, fn=fn):
                val, grads = fn(p, x, m)
                return val[None], grads

            run = shard_map(body, mesh=hvd_jax.mesh(), in_specs=(P(), P("hvd"), P("hvd")),
                            out_specs=(P("hvd"), P()))
            vals, grads = jax.jit(run)(params, jnp.asarray(ids), jnp.asarray(mask))
            out[name] = (np.asarray(vals), grads)
        return out
    finally:
        hvd_jax.shutdown()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_value_and_grad_on_one_rank_match_jax(cpu_world, flax_params, attn_impl):
    ids, mask = _batch(64, True)
    model = workers.make_bert_tiny(flax_params, attn_impl)
    got = workers._bert_value_and_grads(hvd, model, ids, mask)
    for name, (vals, grads) in _jax_value_and_grads(1, attn_impl, flax_params,
                                                    ids, mask).items():
        np.testing.assert_allclose(got[f"{name}_value"], vals[0], rtol=GRAD_RTOL)
        _assert_grads(got[f"{name}_grads"], grads, model.cfg)


@pytest.fixture(scope="module", params=["dense", "flash"])
def two_ranks(request, tmp_path_factory, flax_params):
    """2 gloo ranks, each on its half of a padded batch."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_file = str(tmp_path_factory.mktemp("bert_gloo") / "store")
    ids, mask = _batch(64, True)
    procs = [ctx.Process(target=workers.bert_worker,
                         args=(r, 2, init_file, queue, flax_params, ids, mask,
                               request.param)) for r in range(2)]
    for p in procs:
        p.start()
    results = dict(queue.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    for r, res in results.items():
        assert isinstance(res, dict), f"rank {r} failed:\n{res}"
    return request.param, ids, mask, [results[0], results[1]]


def test_value_and_grad_on_two_ranks_match_jax_mesh(two_ranks, flax_params):
    attn_impl, ids, mask, ranks = two_ranks
    want = _jax_value_and_grads(2, attn_impl, flax_params, ids, mask)
    cfg = dataclasses.replace(BERT_CONFIGS["bert-tiny"], dtype=torch.float32)
    for r, res in enumerate(ranks):
        for name, (vals, grads) in want.items():
            np.testing.assert_allclose(res[f"{name}_value"], vals[r], rtol=GRAD_RTOL)
            _assert_grads(res[f"{name}_grads"], grads, cfg)
    # The ranks' batches differ, their losses too; the gradients are one.
    assert float(ranks[0]["vag_value"]) != float(ranks[1]["vag_value"])
    for key, g in ranks[0]["vag_grads"].items():
        np.testing.assert_array_equal(g, ranks[1]["vag_grads"][key])


@pytest.mark.parametrize("name,wire,jax_wire", [
    ("fp16", torch.bfloat16, jnp.bfloat16), ("bf16", torch.bfloat16, jnp.bfloat16),
    ("true_fp16", torch.float16, jnp.float16)])
def test_compression_wire_cast_is_bitwise_the_jax_cast(name, wire, jax_wire):
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.randn(4096), rng.randn(512) * 1e-30, rng.randn(512) * 1e4,
                        # halfway between two bf16 values: round to even
                        1 + (np.arange(64) * 2 + 1) * 2.0 ** -9]).astype(np.float32)
    comp = getattr(hvd.Compression, name)
    got, ctx = comp.compress(torch.from_numpy(x))
    want, jctx = getattr(JaxCompression, name).compress(jnp.asarray(x))
    assert got.dtype == wire and want.dtype == jax_wire
    bits = np.int16 if wire != torch.float32 else np.int32
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(bits))
    back = comp.decompress(got, ctx)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(JaxCompression.fp16.decompress(want, jctx)
                                             if name != "true_fp16" else
                                             want.astype(jnp.float32)))


def test_compression_leaves_integers_and_none_alone():
    ints = torch.arange(5, dtype=torch.int32)
    for comp in (hvd.Compression.fp16, hvd.Compression.true_fp16, hvd.Compression.none):
        c, ctx = comp.compress(ints)
        assert c.dtype == torch.int32 and torch.equal(comp.decompress(c, ctx), ints)
    x = torch.randn(3)
    c, ctx = hvd.Compression.none.compress(x)
    assert c is x and ctx is None


def test_compressed_distributed_optimizer_matches_jax(two_ranks):
    _, _, _, ranks = two_ranks
    w0, x, y = workers.linreg_data(2)
    hvd_jax.shutdown()
    hvd_jax.init(devices=jax.devices()[:2])
    try:
        tx = hvd_jax.DistributedOptimizer(optax.sgd(1.0),
                                          compression=JaxCompression.fp16)

        def step(w, xs, ys):
            grads = jax.grad(lambda w_: ((xs @ w_ - ys) ** 2).mean())(w)
            updates, _ = tx.update(grads, tx.init(w), w)
            return -updates

        run = shard_map(step, mesh=hvd_jax.mesh(), in_specs=(P(), P("hvd"), P("hvd")),
                        out_specs=P())
        want = np.asarray(run(jnp.asarray(w0), x, y))
    finally:
        hvd_jax.shutdown()
    for res in ranks:
        got = res["reduced_grad"]
        # A bf16 sum of bf16 values, averaged in bf16: exactly a bf16 value,
        # which an f32 sum of the two ranks' gradients would not be.
        f32_mean = (ranks[0]["local_grad"] + ranks[1]["local_grad"]) / 2
        assert not np.array_equal(torch.from_numpy(f32_mean).bfloat16().float().numpy(),
                                  f32_mean)
        np.testing.assert_array_equal(torch.from_numpy(got).bfloat16().float().numpy(), got)
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)
        np.testing.assert_allclose(res["fp16_sgd"], w0 - got, rtol=1e-7, atol=1e-7)


def test_axis_name_other_than_dp_raises(cpu_world):
    """A tp or sp axis raises; PRODUCT, ported now, runs: its gradients
    against the JAX traced product of the same gradients at one rank."""
    with pytest.raises(ValueError, match="axis_name"):
        hvd.distributed_value_and_grad(lambda p: p["w"].sum(), axis_name="tp")
    with pytest.raises(ValueError, match="axis_name"):
        hvd.DistributedGradientTape(lambda p: p["w"].sum(), axis_name="sp")
    w = np.array([1.0, -2.0, 0.5], np.float32)
    vag = hvd.distributed_value_and_grad(lambda p: (p["w"] ** 3).sum(), op=hvd.Product)
    _, grads = vag({"w": torch.from_numpy(w)})
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    want = shard_map(lambda g: traced.allreduce(g, "hvd", ReduceOp.PRODUCT), mesh=mesh,
                     in_specs=P(), out_specs=P())(3 * w ** 2)
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(want), rtol=1e-6)


def test_has_aux_and_unused_parameters(cpu_world):
    w = torch.tensor([1.0, 2.0])
    vag = hvd.distributed_value_and_grad(lambda p: ((p["w"] ** 2).sum(), "aux"),
                                         has_aux=True, fuse=False)
    (val, aux), grads = vag({"w": w, "unused": torch.ones(3)})
    assert float(val) == 5.0 and aux == "aux" and not val.requires_grad
    np.testing.assert_array_equal(grads["w"].numpy(), [2.0, 4.0])
    np.testing.assert_array_equal(grads["unused"].numpy(), np.zeros(3))
