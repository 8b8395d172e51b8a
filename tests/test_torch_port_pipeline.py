"""Pipeline parallelism in the port (``parallel/pipeline.py``,
``models/pipelined.py``, ``parallel/sharding.py``, the pp axis of
``parallel/mesh.py``, ``remat`` and the scan-stacked layout of
``models/convert.py``) against the JAX package, on spawned gloo ranks.

* ``gpipe`` on pp=4 with 4 microbatches at the shapes of
  ``tests/test_parallel.py:81-104`` (S=4, d=8, dh=16, B=8): every rank's
  output against the stages run in sequence and against the JAX ``gpipe``
  on the 8-device CPU mesh, at rtol 1e-5, atol 1e-6.
* On pp=2 with 4 microbatches (``:106-133``): the gradients of each stage's
  parameters equal those of the stack run unpipelined, at f32 rtol 1e-5
  (no factor of S), and 10 SGD steps through ``gpipe`` cut the loss by 10%.
* ``PipelinedLM`` at the configuration of ``:135-172`` (vocab 128, d 32, 4
  heads, 4 layers, d_ff 64, ``scan_layers=True``) on pp=2 x dp=2 with 4
  microbatches, each stage loaded from the JAX scanned ``TransformerLM``'s
  weights (``flax_to_torch(..., stages=2, stage=s)``): the logits against
  the JAX ``PipelinedLM`` at rtol 5e-2, atol 2e-2 in bf16 and 1e-5 in f32;
  in f32 the gradients on a rank's dp rows equal the port's unpipelined
  ``TransformerLM``'s at rtol 1e-5; 4 Adam steps through
  ``make_train_step`` lower the loss, and the pp-replicated parameters
  (embeddings, ``ln_f``, ``lm_head``) are bitwise equal on every rank, a
  stage's blocks bitwise equal on its two dp ranks.
* ``remat`` gives the loss and gradients of no remat bitwise (dense and
  flash attention, f32 and bf16), and ``flax_to_torch`` reads the JAX
  scan-stacked layout: the logits match the JAX forward, and one stage's
  slice is the full conversion's layers under their global indices.
* ``train_gpt2 --pp 2 --remat`` trains on two ranks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from horovod_tpu.models.pipelined import PipelinedLM as JaxPipelinedLM
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.mesh import create_mesh as jax_create_mesh
from horovod_tpu.parallel.pipeline import gpipe as jax_gpipe
from horovod_tpu.parallel.pipeline import stack_stage_params as jax_stack
from horovod_tpu.utils.compat import set_mesh

import _torch_port_workers as workers
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.convert import flax_to_torch
from horovod_tpu_torch.models.transformer import GPT2_CONFIGS, TransformerLM
from horovod_tpu_torch.parallel.pipeline import stack_stage_params, stage_layers

PLM_CFG = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_len=64,
               scan_layers=True)


def _jax_mlp_stage(params, x):
    return x + jnp.tanh(x @ params["w1"]) @ params["w2"]


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    return workers.spawn_world(4, tmp_path_factory.mktemp("pp4"), "_run_gpipe_pp4")


def test_gpipe_matches_sequential_and_jax(pp4):
    params, x = workers.gpipe_inputs()
    want = jnp.asarray(x)
    for s in range(workers.GPIPE_S):
        want = _jax_mlp_stage({k: v[s] for k, v in params.items()}, want)
    mesh = jax_create_mesh({"pp": 4, "dp": 2})

    def stage_fn(p, act):
        return _jax_mlp_stage(jax.tree.map(lambda a: a[0], p), act)

    got_jax = jax.jit(lambda p, x: jax_gpipe(stage_fn, p, x, mesh=mesh,
                                             num_microbatches=workers.GPIPE_M)
                      )(jax_stack(params, workers.GPIPE_S), x)
    assert sorted(r["stage"] for r in pp4) == [0, 1, 2, 3]
    for res in pp4:
        np.testing.assert_allclose(res["out"], np.asarray(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["out"], np.asarray(got_jax), rtol=1e-5, atol=1e-6)


def test_stack_stage_params_matches_jax():
    params, _ = workers.gpipe_inputs()
    got = stack_stage_params({k: torch.from_numpy(v) for k, v in params.items()}, 2)
    want = jax_stack(params, 2)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert list(stage_layers(24, 4, 2)) == list(range(12, 18))
    with pytest.raises(ValueError, match="not divisible"):
        stage_layers(24, 5, 0)


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    return workers.spawn_world(2, tmp_path_factory.mktemp("pp2"), "_run_gpipe_grads", True)


def test_gpipe_gradients_equal_unpipelined(pp2):
    for res in pp2:
        np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-5)
        for k in ("w1", "w2"):
            np.testing.assert_allclose(res["grads"][k], res["ref_grads"][k], rtol=1e-5,
                                       atol=1e-8)


def test_gpipe_trains(pp2):
    for res in pp2:
        losses = res["losses"]
        assert losses[-1] < losses[0] * 0.9, losses
    np.testing.assert_array_equal(pp2[0]["losses"], pp2[1]["losses"])


def test_train_gpt2_pipelined_on_two_ranks(pp2):
    for res in pp2:
        assert len(res["train_gpt2"]) == 2 and np.all(np.isfinite(res["train_gpt2"]))
    np.testing.assert_array_equal(pp2[0]["train_gpt2"], pp2[1]["train_gpt2"])


def _jax_params(dtype):
    cfg = JaxConfig(**PLM_CFG, dtype=dtype)
    ids = workers.plm_ids()
    variables = nn.unbox(JaxLM(cfg).init(jax.random.PRNGKey(0), ids))
    return cfg, variables


@pytest.fixture(scope="module")
def plm(tmp_path_factory):
    jax_out, params = {}, {}
    ids = workers.plm_ids()
    mesh = jax_create_mesh({"pp": 2, "dp": 2, "tp": 2})
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        cfg, variables = _jax_params(dtype)
        model = JaxPipelinedLM(cfg, mesh, num_microbatches=workers.PLM_M)
        with set_mesh(mesh):
            jax_out[name] = np.asarray(jax.jit(lambda v, i: model.apply(v, i))(variables, ids),
                                       dtype=np.float32)
        params[name] = jax.tree.map(np.asarray, variables["params"])
    ranks = workers.spawn_world(4, tmp_path_factory.mktemp("plm"), "_run_pipelined_lm", params)
    return ranks, jax_out


def test_pipelined_lm_matches_jax(plm):
    ranks, jax_out = plm
    for res in ranks:
        np.testing.assert_allclose(res["logits_bf16"], jax_out["bf16"], rtol=5e-2, atol=2e-2)
        np.testing.assert_allclose(res["logits_f32"], jax_out["f32"], rtol=1e-5, atol=1e-5)


def test_pipelined_lm_gradients_equal_unpipelined(plm):
    ranks, _ = plm
    for res in ranks:
        stage = int(res["coords"][0])
        blocks = [k for k in res["grads"] if k.startswith("stack.layers.")]
        assert {int(k.split(".")[2]) for k in blocks} == set(stage_layers(4, 2, stage))
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g, res["ref_grads"][k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_pipelined_lm_trains_and_keeps_replicas_equal(plm):
    ranks, _ = plm
    for res in ranks:
        assert res["losses"][-1] < res["losses"][0], res["losses"]
        np.testing.assert_array_equal(res["losses"], ranks[0]["losses"])
    replicated = [k for k in ranks[0]["params"] if not k.startswith("stack.")]
    assert replicated == ["embed.embedding", "embed.pos_embedding", "ln_f.weight",
                          "ln_f.bias", "lm_head.weight"]
    for res in ranks[1:]:
        for k in replicated:
            np.testing.assert_array_equal(res["params"][k], ranks[0]["params"][k], err_msg=k)
    by_stage = {}
    for res in ranks:
        by_stage.setdefault(int(res["coords"][0]), []).append(res["params"])
    for a, b in by_stage.values():     # a stage's two dp replicas
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture
def cpu_world():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_is_bitwise_no_remat(attn_impl, dtype):
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=dtype, attn_impl=attn_impl,
                              max_len=64)
    if attn_impl == "flash":
        cfg = dataclasses.replace(cfg, n_heads=2)     # head dim 64, as the kernels take
    ids = torch.from_numpy(workers.plm_ids() % cfg.vocab_size)
    base = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    remat = TransformerLM(dataclasses.replace(cfg, remat=True), device="cpu")
    remat.load_state_dict(base.state_dict())
    losses = []
    for model in (base, remat):
        loss = torch.nn.functional.cross_entropy(
            model(ids)[:, :-1].float().flatten(0, 1), ids[:, 1:].flatten().long())
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(*losses)
    for (name, a), b in zip(base.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), name


def test_convert_reads_the_scanned_layout():
    cfg_jax, variables = _jax_params(jnp.float32)
    assert "layers" in variables["params"]["stack"]
    ids = workers.plm_ids()
    want = np.asarray(JaxLM(cfg_jax).apply(variables, ids))
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], **PLM_CFG, dtype=torch.float32)
    assert cfg.stacked and not dataclasses.replace(cfg, n_experts=2).stacked
    params = jax.tree.map(np.asarray, variables["params"])
    full = flax_to_torch(params, cfg)
    model = TransformerLM(cfg, device="cpu")
    model.load_state_dict(full)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    part = flax_to_torch(params, cfg, stages=2, stage=1)
    layers = {int(k.split(".")[2]) for k in part if k.startswith("stack.layers.")}
    assert layers == {2, 3}
    assert {k for k in full if not k.startswith("stack.")} <= set(part)
    for k, v in part.items():
        assert torch.equal(v, full[k]), k
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch(params, dataclasses.replace(cfg, scan_layers=False))


def test_pipelined_lm_on_one_stage_is_the_lm(cpu_world):
    from horovod_tpu_torch.models.pipelined import PipelinedLM

    mesh = hvd.create_mesh({"pp": 1, "dp": 1})
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], scan_layers=True, remat=True,
                              dtype=torch.float32)
    base = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    pipe = PipelinedLM(cfg, mesh, device="cpu", generator=torch.Generator().manual_seed(3))
    sd = base.state_dict()
    assert list(pipe.state_dict()) == list(sd)
    for k, v in pipe.state_dict().items():
        assert torch.equal(v, sd[k]), k
    ids = torch.from_numpy(workers.plm_ids() % cfg.vocab_size)
    assert torch.equal(base(ids), pipe(ids))
    with pytest.raises(ValueError, match="scan_layers=True"):
        PipelinedLM(dataclasses.replace(cfg, scan_layers=False), mesh)
    with pytest.raises(ValueError, match="dense FFN"):
        PipelinedLM(dataclasses.replace(cfg, n_experts=2), mesh)
