"""Tensor parallelism in the port (``parallel/tensor.py``, the tp rows of
``parallel/sharding.py``, the tp axis of ``parallel/mesh.py``, the tp
layers of ``models/transformer.py``, ``models/convert.py``'s tp cut and
``tp_join``, and ``make_train_step`` over dp x tp) against the JAX package,
on spawned gloo ranks.

* gpt2-tiny (4 heads, 2 layers) at a vocabulary of 131, which neither 2
  nor 4 divides, on tp=2 and tp=4, and bert-tiny (2 heads) under a padding
  mask on tp=2, each rank loaded with its shard of one set of weights
  drawn with numpy (``flax_to_torch(..., tp=, tp_rank=)``): the logits
  shards joined against the JAX model's at rtol 1e-5, atol 1e-5 in f32 and
  rtol 5e-2, atol 2e-2 in bf16; the gradients of the vocab-parallel loss,
  joined by ``tp_join``, against ``jax.grad`` of ``lm_loss`` (BERT:
  ``softmax_xent``) at rtol 1e-5, atol 1e-7 (the tolerances of
  tests/test_torch_port_pipeline.py); the replicated parameters' gradients
  bitwise equal on every tp rank. GSPMD does not change the function, so
  the JAX side runs unsharded. One case runs flash attention: the port's
  plain version, the JAX kernel in interpret mode.
* The tp initialisation: every tp layout of one torch seed holds the
  weights of the model built with no mesh, bitwise.
* gpt2-tiny (f32, vocab 128) trained 3 AdamW steps through
  ``make_train_step`` on dp=2 x tp=2 against JAX's ``make_train_step`` on
  a {"dp": 2, "tp": 2} CPU mesh with ``DEFAULT_RULES`` from the same
  weights: the losses at rtol 1e-5, the joined parameters at rtol 1e-5,
  atol 1e-6 wherever the step-1 gradient exceeds 100 x AdamW's eps (the
  rule of tests/test_torch_port_sp.py for the rest); the tp-replicated
  parameters bitwise equal across the tp line.
* Ring and Ulysses on a tp line with no sp line fall back to dense
  attention (bitwise the dense case, and the JAX model's logits), Switch
  experts under tp, an ep axis beside tp and ``PipelinedLM`` on pp=2 x
  tp=2 give the JAX model's logits (tests/test_torch_port_tp_moe.py holds
  MoE under tp and ep against JAX in full, tests/test_torch_port_pp_tp.py
  tp under pp), and tp with sp trains
  (its step-1 loss the JAX model's ``lm_loss``;
  tests/test_torch_port_tp_sp.py holds the composition against JAX in
  full); ``train_gpt2 --tp 2`` trains on two ranks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh

from horovod_tpu.models.transformer import BERT_CONFIGS as JAX_BERT
from horovod_tpu.models.transformer import GPT2_CONFIGS as JAX_GPT2
from horovod_tpu.models.transformer import TransformerEncoder as JaxEncoder
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.sharding import DEFAULT_RULES as JAX_RULES
from horovod_tpu.parallel.train import TrainState as JaxTrainState
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.parallel.train import softmax_xent as jax_softmax_xent

import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import flax_to_torch, tp_join
from horovod_tpu_torch.parallel.mesh import Comm
from horovod_tpu_torch.parallel.sharding import DEFAULT_RULES
from horovod_tpu_torch.parallel.tensor import (TP_PARAMS, shard_range, tp_cut,
                                               vocab_parallel_lm_loss)
from horovod_tpu_torch.parallel.train import lm_loss

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=5e-2, atol=2e-2)}
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _jax_config(name: str, vocab: int = workers.TP_VOCAB, **overrides):
    kind, dtype, attn, _ = workers.TP_CASES[name]
    base = JAX_GPT2["gpt2-tiny"] if kind == "gpt2" else JAX_BERT["bert-tiny"]
    return dataclasses.replace(base, **{"vocab_size": vocab, "max_len": 64, "attn_impl": attn,
                                        "dtype": getattr(jnp, dtype), **overrides})


def _jax_model(name: str, vocab: int = workers.TP_VOCAB, **overrides):
    cls = JaxLM if workers.TP_CASES[name][0] == "gpt2" else JaxEncoder
    return cls(_jax_config(name, vocab, **overrides))


def _numpy_params(name: str, vocab: int = workers.TP_VOCAB, seed: int = 0, **overrides):
    """The JAX model's parameter tree drawn with numpy: kernels, embeddings
    and biases normal(0, 0.02), LayerNorm scales 1 + normal(0, 0.1), so a
    misplaced bias or a wrong head cut shows."""
    ids, mask = workers.tp_batch(vocab)
    shapes = jax.eval_shape(lambda: nn.unbox(_jax_model(name, vocab, **overrides).init(
        jax.random.PRNGKey(0), ids))["params"])
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_reference(name: str, params) -> dict:
    """The JAX model's logits and (for the f32 cases) the gradients of its
    loss, as the port's full state_dict layout."""
    kind, dtype, _, with_grads = workers.TP_CASES[name]
    model = _jax_model(name)
    ids, mask = (jnp.asarray(a) for a in workers.tp_batch())

    def logits_of(p):
        if kind == "gpt2":
            return model.apply({"params": p}, ids)
        return model.apply({"params": p}, ids, mask=mask)

    def loss_of(p):
        z = logits_of(p)
        return jax_lm_loss(z, ids) if kind == "gpt2" else jax_softmax_xent(z, ids)

    out = {"logits": np.asarray(logits_of(params), dtype=np.float32)}
    if with_grads:
        cfg = workers.tp_config(torch, name)
        convert = flax_to_torch if kind == "gpt2" else _bert_convert
        out["grads"] = convert(jax.tree.map(np.asarray, jax.grad(loss_of)(params)), cfg)
    return out


def _bert_convert(params, cfg):
    from horovod_tpu_torch.models.convert import bert_flax_to_torch

    return bert_flax_to_torch(params, cfg)


def _jax_mesh(shape: dict) -> Mesh:
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())),
                tuple(shape))


@pytest.fixture(scope="module")
def tp_worlds(tmp_path_factory):
    params = {name: _numpy_params(name) for name in workers.TP_CASES}
    train_params = _numpy_params("gpt2_f32_dense", vocab=workers.TP_TRAIN_VOCAB, seed=1)
    # Each combination that runs: the dense case's weights, drawn with its
    # experts where it has them.
    run_params = {combo: _numpy_params("gpt2_f32_dense", **_param_overrides(combo))
                  for combo in workers.TP_RUNS}
    np_params = {k: jax.tree.map(np.asarray, v) for k, v in params.items()}
    worlds = {size: workers.spawn_world(size, tmp_path_factory.mktemp(f"tp{size}"),
                                        "_run_tp_world", np_params,
                                        jax.tree.map(np.asarray, train_params),
                                        jax.tree.map(np.asarray, run_params))
              for size in workers.TP_WORLDS}
    return {"ranks": worlds, "params": params, "train_params": train_params,
            "run_params": run_params}


def _param_overrides(combo: str) -> dict:
    """The configuration overrides of a TP_RUNS combination that shape its
    weights or its function with no sp line (not the attention, which falls
    back to dense there)."""
    return {k: v for k, v in workers.TP_RUNS[combo][1].items() if k != "attn_impl"}


CASES = [(size, name) for size, names in workers.TP_WORLDS.items() for name in names]
GRAD_CASES = [(size, name) for size, name in CASES if workers.TP_CASES[name][3]]


def _case_id(case):
    return f"tp{case[0]}-{case[1]}"


@pytest.mark.parametrize("size,name", CASES, ids=map(_case_id, CASES))
def test_tp_logits_match_jax(tp_worlds, size, name):
    ranks = tp_worlds["ranks"][size]
    want = _jax_reference(name, tp_worlds["params"][name])["logits"]
    shards = [r[name]["logits"] for r in ranks]
    assert [s.shape[-1] for s in shards] == [len(shard_range(workers.TP_VOCAB, size, r))
                                             for r in range(size)]
    got = np.concatenate(shards, axis=-1)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[workers.TP_CASES[name][1]])
    losses = [r[name]["loss"] for r in ranks]
    assert losses == [losses[0]] * size     # every tp rank computes the same loss


@pytest.mark.parametrize("size,name", GRAD_CASES, ids=map(_case_id, GRAD_CASES))
def test_tp_gradients_match_jax(tp_worlds, size, name):
    ranks = tp_worlds["ranks"][size]
    want = _jax_reference(name, tp_worlds["params"][name])["grads"]
    got = tp_join([{k: torch.from_numpy(g) for k, g in r[name]["grads"].items()}
                   for r in ranks], workers.tp_config(torch, name))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("size,name", GRAD_CASES, ids=map(_case_id, GRAD_CASES))
def test_tp_replicated_gradients_are_bitwise_equal(tp_worlds, size, name):
    ranks = tp_worlds["ranks"][size]
    cfg = workers.tp_config(torch, name)
    replicated = [k for k in ranks[0][name]["grads"] if tp_cut(k, cfg, size, 0) is None]
    assert any(k.endswith("attn.out.bias") for k in replicated)
    for res in ranks[1:]:
        for k in replicated:
            np.testing.assert_array_equal(res[name]["grads"][k], ranks[0][name]["grads"][k],
                                          err_msg=k)


@pytest.mark.parametrize("size", sorted(workers.TP_WORLDS))
def test_tp_init_holds_the_world_one_weights(tp_worlds, size):
    from horovod_tpu_torch.models.transformer import TransformerLM

    cfg = workers.tp_config(torch, "gpt2_f32_dense")
    full = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ranks = tp_worlds["ranks"][size]
    got = tp_join([{k: torch.from_numpy(v) for k, v in r["init"].items()} for r in ranks],
                  cfg)
    for k, v in full.state_dict().items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("combo", sorted(workers.TP_RUNS))
def test_tp_combinations_now_run(tp_worlds, combo):
    shape, overrides = workers.TP_RUNS[combo]
    size = int(np.prod(list(shape.values())))
    ranks = tp_worlds["ranks"][size]
    params = tp_worlds["params"]["gpt2_f32_dense"]
    if "sp" not in shape:
        # No sp line: dense attention, as the JAX dispatch falls back; the
        # tp shards of the first ep and pp index put together, the others
        # equal (under pp the JAX model is the unpipelined one: the
        # pipeline does not change the function).
        runs = [r["runs"][combo] for r in ranks]
        if "attn_impl" in overrides:
            for res in ranks:
                np.testing.assert_array_equal(res["runs"][combo]["logits"],
                                              res["gpt2_f32_dense"]["logits"])
        first = sorted((r for r in runs
                        if r["coords"].get("ep", 0) == 0 and r["coords"].get("pp", 0) == 0),
                       key=lambda r: r["coords"]["tp"])
        assert len(first) == shape["tp"]
        for r in runs:
            np.testing.assert_array_equal(r["logits"], first[r["coords"]["tp"]]["logits"])
        got = np.concatenate([r["logits"] for r in first], axis=-1)
        ids = jnp.asarray(workers.tp_batch()[0])
        jmodel = _jax_model("gpt2_f32_dense", **_param_overrides(combo))
        want = np.asarray(jmodel.apply({"params": tp_worlds["run_params"][combo]}, ids))
        np.testing.assert_allclose(got, want, **TOL["float32"])
        return
    ids = jnp.asarray(workers.tp_batch()[0])
    want = float(jax_lm_loss(_jax_model("gpt2_f32_dense").apply({"params": params}, ids), ids))
    for res in ranks:
        losses = res["runs"][combo]["losses"]
        assert len(losses) == workers.TP_RUN_STEPS and np.all(np.isfinite(losses))
        np.testing.assert_allclose(losses[0], want, rtol=1e-5)
        np.testing.assert_array_equal(losses, ranks[0]["runs"][combo]["losses"])


def test_train_gpt2_tp_on_two_ranks(tp_worlds):
    ranks = tp_worlds["ranks"][2]
    for res in ranks:
        assert len(res["train_gpt2"]) == 2 and np.all(np.isfinite(res["train_gpt2"]))
    np.testing.assert_array_equal(ranks[0]["train_gpt2"], ranks[1]["train_gpt2"])


@pytest.fixture(scope="module")
def jax_train(tp_worlds):
    """JAX's make_train_step on a {"dp": 2, "tp": 2} mesh from the numpy
    weights: the step-1 gradients, the losses and the final parameters (the
    port's full layout)."""
    params = tp_worlds["train_params"]
    cfg = workers.tp_config(torch, "gpt2_f32_dense", vocab=workers.TP_TRAIN_VOCAB)
    model = _jax_model("gpt2_f32_dense", vocab=workers.TP_TRAIN_VOCAB)
    ids = workers.tp_batch(workers.TP_TRAIN_VOCAB, seed=6)[0]
    tx = optax.adamw(workers.TP_LR, weight_decay=workers.TP_WD, eps=workers.TP_EPS)
    build = jax_make_train_step(model, tx, jax_lm_loss, mesh=_jax_mesh({"dp": 2, "tp": 2}),
                                rules=JAX_RULES)
    _, step_fn, shardings = build(jax.random.PRNGKey(0), ids, ids)
    state = jax.device_put(JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                         opt_state=tx.init(params)), shardings)
    grads = flax_to_torch(jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_lm_loss(model.apply({"params": p}, jnp.asarray(ids)),
                              jnp.asarray(ids)))(params)), cfg)
    losses = []
    for _ in range(workers.TP_STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    return {"grads": grads, "losses": losses, "cfg": cfg,
            "params": flax_to_torch(jax.tree.map(np.asarray, state.params), cfg)}


def test_dp_tp_train_step_matches_jax(tp_worlds, jax_train):
    ranks = [r["train"] for r in tp_worlds["ranks"][4]]
    assert [tuple(r["coords"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jax_train["losses"], rtol=1e-5)
    for d in range(2):
        got = tp_join([{k: torch.from_numpy(v) for k, v in ranks[2 * d + t]["params"].items()}
                       for t in range(2)], jax_train["cfg"])
        for key, w in jax_train["params"].items():
            w, a, g = w.numpy(), got[key].numpy(), jax_train["grads"][key].numpy()
            well = np.abs(g) > 100 * workers.TP_EPS
            np.testing.assert_allclose(a[well], w[well], rtol=1e-5, atol=1e-6, err_msg=key)
            assert np.all(np.abs(a[~well] - w[~well])
                          <= 2.0001 * workers.TP_LR * workers.TP_STEPS), key


def test_dp_tp_replicas_are_bitwise_equal(tp_worlds):
    """The tp-replicated parameters are bitwise equal along the tp line,
    and every parameter along the dp line (its replica line)."""
    ranks = [r["train"]["params"] for r in tp_worlds["ranks"][4]]
    cfg = workers.tp_config(torch, "gpt2_f32_dense", vocab=workers.TP_TRAIN_VOCAB)
    replicated = [k for k in ranks[0] if tp_cut(k, cfg, 2, 0) is None]
    assert "embed.pos_embedding" in replicated and "ln_f.weight" in replicated
    for a, b in ((0, 1), (2, 3)):
        for k in replicated:
            np.testing.assert_array_equal(ranks[a][k], ranks[b][k], err_msg=k)
    for a, b in ((0, 2), (1, 3)):
        for k in ranks[a]:
            np.testing.assert_array_equal(ranks[a][k], ranks[b][k], err_msg=k)


# ---------------------------------------------------------------------------
# One process: the cut rule, the rule table, the loss at tp=1.
@pytest.mark.parametrize("n,tp,want", [(131, 2, [66, 65]), (131, 4, [33, 33, 33, 32]),
                                       (50257, 4, [12565, 12565, 12565, 12562]),
                                       (8192, 4, [2048] * 4)])
def test_shard_range_is_the_jax_split(n, tp, want):
    got = [shard_range(n, tp, r) for r in range(tp)]
    assert [len(g) for g in got] == want
    assert [g.start for g in got] == [r * -(-n // tp) for r in range(tp)]
    assert got[-1].stop == n


def test_shard_range_rejects_an_empty_shard():
    with pytest.raises(ValueError, match="leave rank 3 none"):
        shard_range(5, 4, 3)


@pytest.mark.parametrize("key", sorted(TP_PARAMS))
def test_tp_cut_take_and_join_round_trip(key):
    """Each tp-cut parameter's shards join back to the full tensor; the qkv
    shard holds its heads of each of q, k and v."""
    from horovod_tpu_torch.models.transformer import TransformerEncoder, TransformerLM

    bert = key.startswith("mlm_head")
    cfg = workers.tp_config(torch, "bert_f32_dense" if bert else "gpt2_f32_dense")
    if key.startswith("moe."):
        cfg = dataclasses.replace(cfg, n_experts=2)
    full = dict((TransformerEncoder if bert else TransformerLM)(cfg, device="cpu").state_dict())
    key = next(k for k in full if k == key or k.endswith("." + key))
    t = torch.randn(full[key].shape)
    for tp in (2, 4):
        cuts = [tp_cut(key, cfg, tp, r) for r in range(tp)]
        shards = [c.take(t) for c in cuts]
        assert all(s.shape[c.dim] == c.local_size() for s, c in zip(shards, cuts))
        assert torch.equal(cuts[0].join(shards), t)
    if key.endswith("qkv.weight"):
        H, Hd = cfg.n_heads, cfg.head_dim
        q1 = tp_cut(key, cfg, 2, 1).take(t).view(3, H // 2, Hd, -1)
        assert torch.equal(q1, t.view(3, H, Hd, -1)[:, H // 2:])


def test_sharding_rules_put_the_tp_rows_over_tp():
    rules = dict(DEFAULT_RULES)
    for logical in ("mlp", "heads", "vocab", "expert_mlp"):
        assert rules[logical] == ("tp",) and dict(JAX_RULES)[logical] == ("tp",)


def test_vocab_parallel_loss_at_one_rank_is_lm_loss():
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(2, 9, 37).astype(np.float32)).requires_grad_(True)
    ids = torch.from_numpy(rng.randint(0, 37, (2, 9)))
    one = Comm(None, 1, 0, (0,))
    got = vocab_parallel_lm_loss(logits, ids, one, 37)
    (g_got,) = torch.autograd.grad(got, logits)
    want = lm_loss(logits, ids)
    (g_want,) = torch.autograd.grad(want, logits)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g_got, g_want, rtol=1e-6, atol=1e-8)


def test_make_train_step_tp_needs_the_mesh_model_and_a_vocab_loss():
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import train

    class _Mesh:    # a dp=1 x tp=2 mesh's shape, as make_train_step reads it
        shape = {"dp": 1, "tp": 2}
        axis_names = ("dp", "tp")

        def comm(self, axes):
            return Comm(None, 1, 0, (0,))

    cfg = workers.tp_config(torch, "gpt2_f32_dense")
    model = TransformerLM(cfg, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    mesh = _Mesh()
    with pytest.raises(ValueError, match="built on the step's mesh"):
        train.make_train_step(model, opt, lm_loss, mesh=mesh)
    model.mesh = mesh
    with pytest.raises(ValueError, match="lm_loss or softmax_xent"):
        train.make_train_step(model, opt, lambda z, y: z.sum(), mesh=mesh)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_local_qkv_views_pass_the_kernels_layout_check(tp):
    """GPT-2 1.3B's attention at H/tp heads of head dim 128: the q, k, v
    views of the column-parallel qkv output, as ``MultiHeadAttention``
    makes them, are what K1/K2's tensor maps read in place."""
    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS
    from horovod_tpu_torch.ops.flash_attention import check_tma_layout

    cfg = GPT2_CONFIGS["gpt2-1p3b"]
    n_local = cfg.n_heads // tp
    qkv = torch.zeros(2, 16, 3 * n_local * cfg.head_dim, dtype=torch.bfloat16)
    for name, t in zip("qkv", qkv.view(2, 16, 3, n_local, cfg.head_dim).unbind(dim=2)):
        assert t.shape == (2, 16, n_local, cfg.head_dim)
        check_tma_layout(t, name)

