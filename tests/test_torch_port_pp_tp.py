"""tp under pp in the port: ``PipelinedLM``'s stages on the tp layers, with
the vocab-parallel embedding, head and loss on each pp rank's tp line
(``models/pipelined.py``, ``parallel/pipeline.py``, ``parallel/tensor.py``,
``make_train_step`` and ``models/convert.py``'s stage and tp cuts
together), against the JAX ``PipelinedLM`` on the reference's pp=2 x dp=2
x tp=2 mesh (``tests/test_parallel.py:135-172``), on spawned gloo ranks.

The model is the reference test's (vocab 128, d_model 32, 4 heads, 4
layers, d_ff 64, scan-stacked), its batch ``plm_ids()`` (8 x 16), 4
microbatches.

* On pp=2 x tp=2 (four ranks), each stage and tp shard loaded from the JAX
  ``TransformerLM``'s weights (``flax_to_torch(..., stages=, stage=, tp=,
  tp_rank=)``): (a) every rank's logits are its vocabulary shard of the
  JAX ``PipelinedLM``'s, at rtol 5e-2, atol 2e-2 in bf16 and 1e-5 in f32
  (the tolerances of tests/test_torch_port_pipeline.py); (b) the ranks'
  weights from torch seed 0, joined over tp and stages, are bitwise
  ``TransformerLM``'s from the same seed; (c) in f32 the stages' gradients
  of the vocab-parallel loss, joined over tp (``tp_join``), equal the
  world-1 ``TransformerLM``'s at rtol 1e-5, atol 1e-7; (d) 4 Adam steps
  through ``make_train_step`` in f32 from the JAX step's initial weights
  give the JAX ``make_train_step(plm, optax.adam(1e-3), lm_loss,
  rules=PIPELINE_RULES, shard_seq=True)``'s losses on the reference mesh
  within 1e-5, the same on every rank, with every line of copies bitwise
  (the tp-replicated tensors on their tp line, the pp-replicated ones on
  their pp line); (e) remat is bitwise no remat (f32 and bf16); the
  refusals that stay (sp and tp together under pp, the tied head) raise
  ``NotImplementedError`` naming ROADMAP A3; the combinations that raised
  until pp ran under sp and ep (pp=2 x sp=2, pp=2 x ep=2, and ring or
  Ulysses on pp=2 x tp=2, which fall back to dense attention there) give
  their part of the JAX ``PipelinedLM``'s f32 logits; (f) ``train_gpt2 --pp
  2 --tp 2`` trains.
* On the reference's pp=2 x dp=2 x tp=2 (eight ranks, one test: a
  module-scoped world is rebuilt on every xdist worker that draws one of
  its tests): the same 4 steps, the losses of (d) and of JAX, the dp
  replicas bitwise, every line of copies bitwise.
* ``flax_to_torch`` cuts a stage on a tp rank: joined, the cuts are the
  full conversion.

Under xdist the JAX reference and the four-rank world are computed once
per session and shared by the workers through a file (the xdist recipe for
an expensive fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from horovod_tpu.models.pipelined import PipelinedLM as JaxPipelinedLM
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.mesh import create_mesh as jax_create_mesh
from horovod_tpu.parallel.sharding import PIPELINE_RULES as JAX_PIPELINE_RULES
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.utils.compat import set_mesh

import _torch_port_workers as workers
from _torch_port_jax import shared as _shared
from horovod_tpu_torch.models.convert import flax_to_torch, tp_join
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.parallel.pipeline import stage_layers
from horovod_tpu_torch.parallel.tensor import shard_range, tp_cut
from horovod_tpu_torch.parallel.train import lm_loss

PLM_CFG = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_len=64,
               scan_layers=True)
TOL = {"bf16": dict(rtol=5e-2, atol=2e-2), "f32": dict(rtol=1e-5, atol=1e-5)}
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_RTOL = 1e-5


def _jax_reference() -> dict:
    """The JAX PipelinedLM on the reference's pp=2 x dp=2 x tp=2 mesh: its
    logits in bf16 and f32 from TransformerLM's init (PRNGKey 0), and
    PLM_STEPS steps of its make_train_step in f32 (the losses, and the
    step's initial weights)."""
    ids = workers.plm_ids()
    mesh = jax_create_mesh(workers.PPDPTP_MESH)
    out = {"params": {}, "logits": {}}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        cfg = JaxConfig(**PLM_CFG, dtype=dtype)
        variables = nn.unbox(JaxLM(cfg).init(jax.random.PRNGKey(0), ids))
        model = JaxPipelinedLM(cfg, mesh, num_microbatches=workers.PLM_M)
        with set_mesh(mesh):
            out["logits"][name] = np.asarray(
                jax.jit(lambda v, i: model.apply(v, i))(variables, ids), dtype=np.float32)
        out["params"][name] = jax.tree.map(np.asarray, variables["params"])
    plm = JaxPipelinedLM(JaxConfig(**PLM_CFG, dtype=jnp.float32), mesh,
                         num_microbatches=workers.PLM_M)
    build = jax_make_train_step(plm, optax.adam(workers.PLM_LR), jax_lm_loss, mesh=mesh,
                                rules=JAX_PIPELINE_RULES, shard_seq=True)
    init_fn, step_fn, _ = build(jax.random.PRNGKey(0), ids)
    state = init_fn(jax.random.PRNGKey(0))
    out["train_params"] = jax.tree.map(np.asarray, state.params)
    losses = []
    for _ in range(workers.PLM_STEPS):
        state, loss = step_fn(state, ids)
        losses.append(float(loss))
    out["losses"] = np.array(losses)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return _shared(tmp_path_factory, "pp_tp_jax", _jax_reference)


@pytest.fixture(scope="module")
def pp_tp(tmp_path_factory, jax_ref):
    return _shared(tmp_path_factory, "pp_tp_world4", lambda: workers.spawn_world(
        4, tmp_path_factory.mktemp("pp_tp"), "_run_pp_tp_world", jax_ref["params"],
        jax_ref["train_params"]))


def _stage_dicts(ranks, key: str, cfg) -> dict:
    """Each stage's tensors ``key`` joined over its tp line, by stage."""
    out = {}
    for stage in range(2):
        shards = sorted((r for r in ranks if r["coords"]["pp"] == stage),
                        key=lambda r: r["coords"]["tp"])
        assert [r["coords"]["tp"] for r in shards] == [0, 1]
        out[stage] = tp_join([{k: torch.from_numpy(np.asarray(v)) for k, v in r[key].items()}
                              for r in shards], cfg)
    return out


def _joined(ranks, key: str, cfg) -> dict:
    """The full model's tensors ``key`` from the stages joined over tp; the
    tensors every stage holds must agree bitwise."""
    full = {}
    for stage, part in _stage_dicts(ranks, key, cfg).items():
        blocks = {int(k.split(".")[2]) for k in part if k.startswith("stack.layers.")}
        assert blocks == set(stage_layers(cfg.n_layers, 2, stage))
        for k, v in part.items():
            if k in full:
                assert torch.equal(full[k], v), k
            full[k] = v
    return full


def _assert_lines_of_copies_bitwise(ranks, key: str, cfg) -> None:
    """Every tensor bitwise on its line of copies: the ranks of one stage
    (for a block's tensor) and one tp index (for a tp-cut tensor)."""
    for res in ranks:
        for k, v in res[key].items():
            for other in ranks:
                same_stage = other["coords"]["pp"] == res["coords"]["pp"]
                same_tp = other["coords"]["tp"] == res["coords"]["tp"]
                cut = tp_cut(k, cfg, 2, 0) is not None
                if (k.startswith("stack.") and not same_stage) or (cut and not same_tp):
                    continue
                np.testing.assert_array_equal(v, other[key][k], err_msg=k)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_logits_are_the_jax_pipelined_lm_vocab_shards(pp_tp, jax_ref, dtype):
    want = jax_ref["logits"][dtype]
    for res in pp_tp:
        units = shard_range(PLM_CFG["vocab_size"], 2, res["coords"]["tp"])
        got = res[f"logits_{dtype}"]
        assert got.shape == want.shape[:-1] + (len(units),)
        np.testing.assert_allclose(got, want[..., units.start:units.stop], **TOL[dtype])


def test_init_holds_the_world_one_weights(pp_tp):
    cfg = workers.plm_config(torch)
    got = _joined(pp_tp, "init", cfg)
    want = TransformerLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0)).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_gradients_equal_world_one(pp_tp, jax_ref):
    cfg = workers.plm_config(torch)
    full = TransformerLM(cfg, device="cpu")
    full.load_state_dict(flax_to_torch(jax_ref["params"]["f32"], cfg))
    ids = torch.from_numpy(workers.plm_ids())
    loss = lm_loss(full(ids), ids)
    loss.backward()
    for res in pp_tp:
        np.testing.assert_allclose(res["loss"], float(loss.detach()), rtol=LOSS_RTOL)
    for stage, grads in _stage_dicts(pp_tp, "grads", cfg).items():
        ref = dict(full.named_parameters())
        assert {k for k in grads if k.startswith("stack.")} == {
            k for k in ref if k.startswith("stack.layers.")
            and int(k.split(".")[2]) in stage_layers(cfg.n_layers, 2, stage)}
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref[k].grad.numpy(), err_msg=k, **GRAD_TOL)


def test_training_matches_jax_and_keeps_copies_bitwise(pp_tp, jax_ref):
    ranks = [r["train"] for r in pp_tp]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jax_ref["losses"], rtol=LOSS_RTOL)
        np.testing.assert_array_equal(res["losses"], ranks[0]["losses"])
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    _assert_lines_of_copies_bitwise(ranks, "params", workers.plm_config(torch))


@pytest.mark.parametrize("dtype", workers.PPTP_REMAT_DTYPES)
def test_remat_is_bitwise_no_remat(pp_tp, dtype):
    for res in pp_tp:
        got = res["remat"][dtype]
        assert got["loss_bitwise"] and not got["differ"], got


@pytest.mark.parametrize("case", sorted(workers.PPTP_RAISES))
def test_refusals_that_stay_name_roadmap_a3(pp_tp, case):
    for res in pp_tp:
        msg = res["raises"][case]
        assert msg.startswith("NotImplementedError") and "ROADMAP A3" in msg, msg


@pytest.mark.parametrize("case", sorted(workers.PPTP_RUNS))
def test_combinations_that_ran_into_refusals_give_the_jax_logits(pp_tp, jax_ref, case):
    want = jax_ref["logits"]["f32"]
    for res in pp_tp:
        got = res["runs"][case]
        coords = got["coords"]
        sp, tp = (2 if axis in coords else 1 for axis in ("sp", "tp"))
        S = want.shape[1] // sp
        s0 = coords.get("sp", 0) * S
        units = shard_range(PLM_CFG["vocab_size"], tp, coords.get("tp", 0))
        np.testing.assert_allclose(got["logits"],
                                   want[:, s0:s0 + S, units.start:units.stop], **TOL["f32"])


def test_train_gpt2_pp_tp_on_four_ranks(pp_tp):
    for res in pp_tp:
        assert len(res["train_gpt2"]) == 2 and np.all(np.isfinite(res["train_gpt2"]))
        np.testing.assert_array_equal(res["train_gpt2"], pp_tp[0]["train_gpt2"])


def test_pp_dp_tp_world_trains_as_jax_with_bitwise_replicas(tmp_path, pp_tp, jax_ref):
    ranks = workers.spawn_world(8, tmp_path, "_run_pp_dp_tp_world", jax_ref["train_params"])
    assert [tuple(r["coords"][a] for a in ("pp", "dp", "tp")) for r in ranks] == [
        (p, d, t) for p in range(2) for d in range(2) for t in range(2)]
    four = pp_tp[0]["train"]["losses"]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jax_ref["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["losses"], four, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(res["losses"], ranks[0]["losses"])
    for res in ranks:    # the dp replicas: every tensor, a stage's blocks among them
        mate = ranks[res["coords"]["pp"] * 4 + (1 - res["coords"]["dp"]) * 2
                     + res["coords"]["tp"]]
        assert mate["params"].keys() == res["params"].keys()
        for k, v in res["params"].items():
            np.testing.assert_array_equal(v, mate["params"][k], err_msg=k)
    _assert_lines_of_copies_bitwise(ranks, "params", workers.plm_config(torch))


def test_convert_cuts_a_stage_on_a_tp_rank():
    cfg = workers.plm_config(torch)
    params = jax.tree.map(np.asarray, nn.unbox(JaxLM(JaxConfig(**PLM_CFG)).init(
        jax.random.PRNGKey(0), workers.plm_ids()))["params"])
    full = flax_to_torch(params, cfg)
    for stage in range(2):
        shards = [flax_to_torch(params, cfg, stages=2, stage=stage, tp=2, tp_rank=t)
                  for t in range(2)]
        joined = tp_join(shards, cfg)
        layers = {int(k.split(".")[2]) for k in joined if k.startswith("stack.layers.")}
        assert layers == set(stage_layers(cfg.n_layers, 2, stage))
        assert {k for k in full if not k.startswith("stack.")} <= set(joined)
        for k, v in joined.items():
            assert torch.equal(v, full[k]), k
        for t, shard in enumerate(shards):
            assert shard["lm_head.weight"].shape[0] == len(
                shard_range(cfg.vocab_size, 2, t))
