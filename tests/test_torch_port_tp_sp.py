"""tp composed with sp in the port (``check_tp_supported``, the attention
dispatch on H/tp heads over the sp line, ``parallel/ring.py`` and
``parallel/ulysses.py`` on the local heads, the vocab-parallel embedding
and positions of a sequence block, the sequence-sharded vocab-parallel
``lm_loss`` of ``make_train_step``, ``replica_comm``'s lines and the
gradient lines) against the JAX package on a 4-device CPU mesh
{"sp": 2, "tp": 2}, on four spawned gloo ranks (rank 2·s + t holds sp
index s and tp index t, the coordinates of JAX device 2·s + t).

* gpt2-tiny (4 heads, 2 layers) at a vocabulary of 131, which 2 does not
  divide, with dense, gathered flash (the port's plain version, the JAX
  kernel in interpret mode), ring, Ulysses and Ulysses through flash
  attention, and bert-tiny at 4 heads under a padding mask with dense,
  ring and Ulysses-flash, each rank loaded with its tp shard of one set of
  numpy-drawn weights: the logits (sequence blocks and vocabulary shards
  joined) against the JAX model's on the mesh at rtol 1e-5, atol 1e-6; the
  gradients of the loss (gpt2: ``lm_loss`` over the global shifted
  sequence, bert: ``softmax_xent``), averaged over the sp line and joined
  over tp by ``tp_join``, against ``jax.grad`` at rtol 1e-5, atol 1e-6
  (the dp x tp step's tolerance in tests/test_torch_port_tp.py); the
  replicated gradients bitwise on every tp line, every gradient on every
  sp line; the ring's block checkpoint nested in remat's gives the same
  gradients bitwise.
* the vocab-parallel embedding of a sequence block and its positions
  (``seq_offset``) against the full tables; every tp layout of one seed
  holds the mesh-less model's weights, whatever the sp index.
* the sequence-sharded vocab-parallel ``lm_loss`` on random logits against
  the JAX ``lm_loss`` over the whole sequence, the label across the sp
  boundary included; every tp rank computes the same share.
* ``ring_attention`` in bf16 on the local heads within 2 bf16 ulps of the
  JAX ring under ``shard_map`` over sp and tp (as
  tests/test_torch_port_sp.py holds it at sp=4).
* 3 AdamW steps of ``make_train_step(shard_seq=True)`` (dense, flash,
  ring, Ulysses) against JAX's ``make_train_step(shard_seq=True)`` on the
  same mesh: losses at rtol 1e-5, step-1 gradients at rtol 1e-5, atol
  1e-7, parameters at rtol 1e-5, atol 1e-6 where the step-1 gradient
  exceeds 100 x eps (tests/test_torch_port_tp.py's rule); init's
  broadcasts run on each tensor's line of copies (ranks loaded with
  moved weights come out with the right ones) and the replicas stay
  bitwise after the steps.
* Ulysses whose local heads do not split over sp raises ``ValueError``;
  ``train_gpt2 --tp 2 --sp 2 --attn ring --remat`` trains.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.models.transformer import BERT_CONFIGS as JAX_BERT
from horovod_tpu.models.transformer import GPT2_CONFIGS as JAX_GPT2
from horovod_tpu.models.transformer import TransformerEncoder as JaxEncoder
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.ring import ring_attention as jax_ring
from horovod_tpu.parallel.sharding import DEFAULT_RULES as JAX_RULES
from horovod_tpu.parallel.train import TrainState as JaxTrainState
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.parallel.train import softmax_xent as jax_softmax_xent
from horovod_tpu.utils.compat import set_mesh, shard_map

import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import bert_flax_to_torch, flax_to_torch, tp_join
from horovod_tpu_torch.parallel.tensor import tp_cut

TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
SP, TP = workers.TPSP_MESH["sp"], workers.TPSP_MESH["tp"]
CASES = ([("gpt2", a) for a in workers.TPSP_ATTNS]
         + [("bert", a) for a in workers.TPSP_BERT_ATTNS])


def _jax_mesh() -> Mesh:
    return Mesh(np.asarray(jax.devices()[:SP * TP]).reshape(SP, TP), ("sp", "tp"))


def _jax_model(kind: str, attn: str, vocab: int = workers.TP_VOCAB):
    base = JAX_GPT2["gpt2-tiny"] if kind == "gpt2" else JAX_BERT["bert-tiny"]
    cfg = dataclasses.replace(base, n_heads=4, vocab_size=vocab, max_len=64,
                              attn_impl="ulysses" if attn == "ulysses_flash" else attn,
                              sp_use_flash=attn == "ulysses_flash", dtype=jnp.float32)
    return (JaxLM if kind == "gpt2" else JaxEncoder)(cfg)


@functools.lru_cache(maxsize=None)
def _numpy_params(kind: str, vocab: int = workers.TP_VOCAB, seed: int = 0):
    """The JAX model's parameter tree drawn with numpy: kernels, embeddings
    and biases normal(0, 0.02), LayerNorm scales 1 + normal(0, 0.1), so a
    misplaced bias or a wrong head cut shows."""
    ids = workers.tp_batch(vocab)[0]
    shapes = jax.eval_shape(lambda: nn.unbox(_jax_model(kind, "dense", vocab).init(
        jax.random.PRNGKey(0), ids))["params"])
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


@pytest.fixture(scope="module")
def tp_sp_world(tmp_path_factory):
    params = {"gpt2": _numpy_params("gpt2"), "bert": _numpy_params("bert")}
    train_params = _numpy_params("gpt2", vocab=workers.TP_TRAIN_VOCAB, seed=1)
    ranks = workers.spawn_world(SP * TP, tmp_path_factory.mktemp("tpsp"), "_run_tp_sp_world",
                                params["gpt2"], params["bert"], train_params)
    return {"ranks": ranks, "params": params, "train_params": train_params}


def _rank(s: int, t: int) -> int:
    return s * TP + t


def _assemble(ranks, get) -> np.ndarray:
    """The global array from the ranks' pieces: sequence blocks (dim 1) over
    sp, vocabulary shards (last dim) over tp."""
    rows = [np.concatenate([get(ranks[_rank(s, t)]) for t in range(TP)], axis=-1)
            for s in range(SP)]
    return np.concatenate(rows, axis=1)


def _port_cfg(kind: str, attn: str = "dense", vocab: int = workers.TP_VOCAB):
    return workers.tpsp_config(torch, kind, attn, vocab=vocab)


def _joined(ranks, key: str, cfg, s: int = 0) -> dict:
    """The tp ranks' tensors of sp index ``s`` joined to the full model's."""
    return tp_join([{k: torch.from_numpy(v) for k, v in ranks[_rank(s, t)][key].items()}
                    for t in range(TP)], cfg)


@functools.lru_cache(maxsize=None)
def _jax_reference(kind: str, attn: str) -> dict:
    """The JAX model on the {"sp": 2, "tp": 2} mesh from the numpy weights:
    its logits and the gradients of its loss, in the port's full layout."""
    params = _numpy_params(kind)
    model = _jax_model(kind, attn)
    ids, mask = (jnp.asarray(a) for a in workers.tp_batch())

    def logits_of(p):
        if kind == "gpt2":
            return model.apply({"params": p}, ids)
        return model.apply({"params": p}, ids, mask=mask)

    def loss_of(p):
        z = logits_of(p)
        return jax_lm_loss(z, ids) if kind == "gpt2" else jax_softmax_xent(z, ids)

    with set_mesh(_jax_mesh()):
        logits = jax.jit(logits_of)(params)
        grads = jax.jit(jax.grad(loss_of))(params)
    convert = flax_to_torch if kind == "gpt2" else bert_flax_to_torch
    return {"logits": np.asarray(logits),
            "grads": convert(jax.tree.map(np.asarray, grads), _port_cfg(kind, attn))}


def test_ranks_hold_the_jax_device_coordinates(tp_sp_world):
    mesh = _jax_mesh()
    for rank, res in enumerate(tp_sp_world["ranks"]):
        s, t = (int(i) for i in np.argwhere(mesh.devices == jax.devices()[rank])[0])
        assert tuple(res["coords"]) == (s, t)


@pytest.mark.parametrize("kind,attn", CASES)
def test_tp_sp_logits_match_jax(tp_sp_world, kind, attn):
    ranks = tp_sp_world["ranks"]
    want = _jax_reference(kind, attn)["logits"]
    got = _assemble(ranks, lambda r: r[f"{kind}_{attn}"]["logits"])
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    losses = [r[f"{kind}_{attn}"]["loss"] for r in ranks]
    assert losses == [losses[0]] * len(ranks)     # every rank computes the global loss


@pytest.mark.parametrize("kind,attn", CASES)
def test_tp_sp_gradients_match_jax(tp_sp_world, kind, attn):
    ranks = tp_sp_world["ranks"]
    want = _jax_reference(kind, attn)["grads"]
    cfg = _port_cfg(kind, attn)
    got = _joined([r[f"{kind}_{attn}"] for r in ranks], "grads", cfg)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), err_msg=key, **TOL)


@pytest.mark.parametrize("kind,attn", CASES)
def test_tp_sp_gradients_are_bitwise_on_every_line(tp_sp_world, kind, attn):
    """Replicated gradients equal on each tp line; every gradient equal on
    each sp line (the average the optimizer would take)."""
    ranks = [r[f"{kind}_{attn}"]["grads"] for r in tp_sp_world["ranks"]]
    cfg = _port_cfg(kind, attn)
    replicated = [k for k in ranks[0] if tp_cut(k, cfg, TP, 0) is None]
    assert any(k.endswith("attn.out.bias") for k in replicated)
    assert "embed.pos_embedding" in replicated
    for s in range(SP):
        for k in replicated:
            np.testing.assert_array_equal(ranks[_rank(s, 1)][k], ranks[_rank(s, 0)][k],
                                          err_msg=k)
    for t in range(TP):
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[_rank(1, t)][k], ranks[_rank(0, t)][k],
                                          err_msg=k)


def test_ring_checkpoint_nested_in_remat_gives_equal_gradients(tp_sp_world):
    for res in tp_sp_world["ranks"]:
        plain, remat = res["gpt2_ring"], res["gpt2_ring_remat"]
        np.testing.assert_array_equal(remat["logits"], plain["logits"])
        for k, g in plain["grads"].items():
            np.testing.assert_array_equal(remat["grads"][k], g, err_msg=k)


def test_embedding_of_a_sequence_block_on_tp_x_sp(tp_sp_world):
    """The vocab-parallel lookup of this rank's (B, S/sp) ids summed over
    tp, plus the position rows from sp index · S/sp."""
    cfg = _port_cfg("gpt2")
    full = flax_to_torch(tp_sp_world["params"]["gpt2"], cfg)
    table, pos = full["embed.embedding"].numpy(), full["embed.pos_embedding"].numpy()
    ids = workers.tp_batch()[0]
    per = ids.shape[1] // SP
    for res in tp_sp_world["ranks"]:
        s = int(res["coords"][0])
        case = res["gpt2_dense"]
        assert int(case["seq_offset"]) == s * per
        blk = ids[:, s * per:(s + 1) * per]
        np.testing.assert_array_equal(case["embed"], table[blk] + pos[s * per:(s + 1) * per])


def test_tp_init_holds_the_world_one_weights_at_every_sp_index(tp_sp_world):
    from horovod_tpu_torch.models.transformer import TransformerLM

    cfg = workers.tp_config(torch, "gpt2_f32_dense")
    full = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ranks = tp_sp_world["ranks"]
    for s in range(SP):
        got = _joined(ranks, "init", cfg, s)
        for k, v in full.state_dict().items():
            assert torch.equal(got[k], v), (s, k)


def test_convert_cuts_by_tp_rank_whatever_the_sp_index(tp_sp_world):
    """``flax_to_torch(..., tp=, tp_rank=)`` gives a rank its tp rank's
    shard (parameters are not cut over sp): the weights the gpt2 cases load
    join back to the full model's, and the loaded model's gradients have
    their shapes."""
    params = tp_sp_world["params"]["gpt2"]
    cfg = _port_cfg("gpt2")
    full = flax_to_torch(params, cfg)
    shards = [flax_to_torch(params, cfg, tp=TP, tp_rank=t) for t in range(TP)]
    joined = tp_join(shards, cfg)
    for k, v in full.items():
        assert torch.equal(joined[k], v), k
    for res in tp_sp_world["ranks"]:
        t = int(res["coords"][1])
        for k, g in res["gpt2_dense"]["grads"].items():
            assert g.shape == tuple(shards[t][k].shape), k


def test_sequence_sharded_vocab_parallel_loss_is_lm_loss(tp_sp_world):
    ranks = tp_sp_world["ranks"]
    logits, ids = workers.tpsp_logits(), workers.tp_batch()[0]
    want, grad = jax.value_and_grad(jax_lm_loss)(jnp.asarray(logits), jnp.asarray(ids))
    grad = np.asarray(grad)
    for s in range(SP):
        shares = [ranks[_rank(s, t)]["loss"]["share"] for t in range(TP)]
        assert shares == [shares[0]] * TP       # every tp rank alike
    for res in ranks:
        np.testing.assert_allclose(res["loss"]["loss"], float(want), rtol=1e-6)
    got = _assemble(ranks, lambda r: r["loss"]["grad"])
    np.testing.assert_allclose(got, grad, rtol=1e-5, atol=1e-9)
    per = ids.shape[1] // SP
    # The first block's last position is labelled with the second block's
    # first id; the last position of the sequence has no label.
    assert np.abs(got[:, per - 1]).max() > 0
    assert np.abs(got[:, -1]).max() == 0
    np.testing.assert_allclose(got[:, per - 1], grad[:, per - 1], rtol=1e-5, atol=1e-9)


def _bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at |want|."""
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("causal", [True, False])
def test_tp_sp_ring_bf16_matches_jax(tp_sp_world, causal):
    q, k, v, cot, _ = workers.sp_inputs()
    spec = P(None, "sp", "tp")
    fn = jax.jit(shard_map(lambda a, b, c: jax_ring(a, b, c, "sp", causal=causal),
                           mesh=_jax_mesh(), in_specs=(spec,) * 3, out_specs=spec))
    o, vjp = jax.vjp(fn, *[jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)])
    want = [np.asarray(x, np.float32) for x in (o, *vjp(jnp.asarray(cot, jnp.bfloat16)))]
    ranks = tp_sp_world["ranks"]
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        rows = [np.concatenate([ranks[_rank(s, t)]["ring_bf16"][causal][i] for t in range(TP)],
                               axis=2) for s in range(SP)]
        got = np.concatenate(rows, axis=1)
        assert got.shape == want[i].shape and np.isfinite(got).all(), name
        assert _bf16_ulps(got, want[i]).max() <= 2.0, name


def test_ulysses_heads_that_do_not_split_raise(tp_sp_world):
    for res in tp_sp_world["ranks"]:
        msg = res["raises"]
        assert msg.startswith("ValueError") and "1 local heads" in msg and "sp=2" in msg, msg


@pytest.fixture(scope="module")
def jax_train(tp_sp_world):
    """JAX's make_train_step(shard_seq=True) on {"sp": 2, "tp": 2} from the
    numpy weights, per attention: the step-1 gradients, the losses and the
    final parameters (the port's full layout)."""
    params = tp_sp_world["train_params"]
    ids = workers.tp_batch(workers.TP_TRAIN_VOCAB, seed=6)[0]
    out = {}
    for attn in workers.TPSP_TRAIN_ATTNS:
        model = _jax_model("gpt2", attn, vocab=workers.TP_TRAIN_VOCAB)
        cfg = _port_cfg("gpt2", attn, vocab=workers.TP_TRAIN_VOCAB)
        tx = optax.adamw(workers.TP_LR, weight_decay=workers.TP_WD, eps=workers.TP_EPS)
        build = jax_make_train_step(model, tx, jax_lm_loss, mesh=_jax_mesh(), rules=JAX_RULES,
                                    shard_seq=True)
        _, step_fn, shardings = build(jax.random.PRNGKey(0), ids, ids)
        state = jax.device_put(JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                             opt_state=tx.init(params)), shardings)
        grads = flax_to_torch(jax.tree.map(np.asarray, jax.grad(
            lambda p: jax_lm_loss(model.apply({"params": p}, jnp.asarray(ids)),
                                  jnp.asarray(ids)))(params)), cfg)
        losses = []
        for _ in range(workers.TPSP_STEPS):
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
        out[attn] = {"grads": grads, "losses": losses, "cfg": cfg,
                     "params": flax_to_torch(jax.tree.map(np.asarray, state.params), cfg)}
    return out


@pytest.mark.parametrize("attn", workers.TPSP_TRAIN_ATTNS)
def test_tp_sp_train_step_matches_jax(tp_sp_world, jax_train, attn):
    ranks = [r[f"train_{attn}"] for r in tp_sp_world["ranks"]]
    ref = jax_train[attn]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-5)
    for s in range(SP):
        grads = _joined(ranks, "grads", ref["cfg"], s)
        params = _joined(ranks, "params", ref["cfg"], s)
        for key, w in ref["params"].items():
            g = ref["grads"][key].numpy()
            np.testing.assert_allclose(grads[key].numpy(), g, err_msg=key, **TRAIN_GRAD_TOL)
            w, a = w.numpy(), params[key].numpy()
            well = np.abs(g) > 100 * workers.TP_EPS
            np.testing.assert_allclose(a[well], w[well], rtol=1e-5, atol=1e-6, err_msg=key)
            assert np.all(np.abs(a[~well] - w[~well])
                          <= 2.0001 * workers.TP_LR * workers.TPSP_STEPS), key


@pytest.mark.parametrize("attn", workers.TPSP_TRAIN_ATTNS)
def test_tp_sp_init_broadcasts_on_each_line_and_replicas_stay_bitwise(tp_sp_world, attn):
    """init restores the weights that ranks were loaded with moved off
    (the tp-cut ones from the first member of their sp line, the
    replicated ones from rank 0); ``replica_comm`` names those lines; after
    3 steps the replicated parameters are bitwise on every tp line and
    every parameter on its sp line."""
    ranks = [r[f"train_{attn}"] for r in tp_sp_world["ranks"]]
    cfg = _port_cfg("gpt2", attn, vocab=workers.TP_TRAIN_VOCAB)
    for rank, res in enumerate(ranks):
        assert bool(res["init_restored"]), rank
        t = rank % TP
        for name, line in res["lines"].items():
            want = ([_rank(s, t) for s in range(SP)] if tp_cut(name, cfg, TP, t) is not None
                    else list(range(SP * TP)))
            assert list(line) == want, (rank, name)
    replicated = [k for k in ranks[0]["params"] if tp_cut(k, cfg, TP, 0) is None]
    assert "embed.pos_embedding" in replicated and "ln_f.weight" in replicated
    for s in range(SP):
        for k in replicated:
            np.testing.assert_array_equal(ranks[_rank(s, 1)]["params"][k],
                                          ranks[_rank(s, 0)]["params"][k], err_msg=k)
    for t in range(TP):
        for k, v in ranks[_rank(0, t)]["params"].items():
            np.testing.assert_array_equal(ranks[_rank(1, t)]["params"][k], v, err_msg=k)


def test_train_gpt2_tp_sp_ring_remat(tp_sp_world):
    ranks = tp_sp_world["ranks"]
    for res in ranks:
        assert len(res["train_gpt2"]) == 2 and np.all(np.isfinite(res["train_gpt2"]))
        np.testing.assert_array_equal(res["train_gpt2"], ranks[0]["train_gpt2"])
