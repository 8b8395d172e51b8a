"""The Switch-MoE FFN under tensor parallelism in the port (each expert's
d_ff cut over tp, the JAX "expert_mlp" axis, composed with ep, dp and sp:
``SwitchMoE``, the ``moe.wi``/``moe.wo`` rows of ``TP_PARAMS``,
``init_param_``, ``flax_to_torch(..., ep=, tp=)``, ``ep_join``,
``logical_axes``/``replica_comm`` and ``make_train_step(moe_aux_weight=)``)
against the JAX package on four spawned gloo ranks, each case against the
JAX model on a 4-device CPU mesh of the same shape.

* gpt2-tiny (4 heads, 2 layers, f32) with 4 Switch experts in block 1 at a
  vocabulary of 131, on {"ep": 2, "tp": 2} (capacity 1.25), {"dp": 2,
  "tp": 2} (capacity 0.5, so tokens are dropped), {"tp": 4} and {"sp": 2,
  "tp": 2} (Ulysses through flash: the port's plain version, the JAX
  kernel in interpret mode; ``shard_seq``), each rank loaded with its ep
  slice and tp shard of one set of numpy-drawn weights: the logits
  (dp rows, sequence blocks and vocabulary shards put together) against
  the JAX model's at rtol 1e-5, atol 1e-6; the gradients of ``lm_loss``
  plus 0.01 times the auxiliary loss, averaged over the (dp, sp) line and
  joined over tp and ep (``tp_join``, ``ep_join``), against ``jax.grad``
  at rtol 1e-5, atol 1e-6; the dropped tokens equal to those counted from
  the flax router's logits.
* 3 AdamW steps of ``make_train_step(moe_aux_weight=0.01)`` (vocab 128)
  against JAX's ``make_train_step`` on the same mesh: losses at rtol 1e-5,
  step-1 gradients at rtol 1e-5, atol 1e-7, parameters at rtol 1e-5, atol
  1e-6 where the step-1 gradient exceeds 100 x AdamW's eps (elsewhere
  within two steps' updates a step, tests/test_torch_port_tp.py's rule),
  the dropped tokens of every step equal to JAX's.
* Bitwise: the routes on every rank of each tp and ep line, at every step;
  the replicated gradients on every tp line and the non-expert ones on
  every ep line; every ep x tp layout of one torch seed holds the weights
  of the model built with no mesh; ``flax_to_torch``'s ep x tp cut joins
  back to the full model; the expert weights' line of copies is the (dp,
  sp) line; a dp=1 x ep=1 x sp=1 x tp=1 mesh trains bitwise the model with
  no mesh; ``train_gpt2 --tp 2 --ep 2 --n-experts 4 --remat`` trains.
* Under remat, backward's recomputation of a Switch block leaves the aux
  loss, dropped tokens and routes of the forward, and no recomputed
  activation alive after backward (one process).
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

from horovod_tpu.models.transformer import GPT2_CONFIGS as JAX_GPT2
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.sharding import DEFAULT_RULES as JAX_RULES
from horovod_tpu.parallel.train import TrainState as JaxTrainState
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.utils.compat import set_mesh

import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import EXPERT_PARAMS, ep_join, flax_to_torch, tp_join
from horovod_tpu_torch.parallel.tensor import shard_range, tp_cut

TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
CASES = list(workers.TPMOE_CASES)


def _shape(name: str) -> dict:
    shape = workers.TPMOE_CASES[name][0]
    return {a: shape.get(a, 1) for a in ("dp", "ep", "sp", "tp")}


def _jax_mesh(name: str) -> Mesh:
    shape = workers.TPMOE_CASES[name][0]
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


def _jax_model(name: str, vocab: int = workers.TP_VOCAB, attn: str = None):
    _, cf, case_attn = workers.TPMOE_CASES[name]
    attn = attn or case_attn
    cfg = dataclasses.replace(
        JAX_GPT2["gpt2-tiny"], n_heads=4, vocab_size=vocab, max_len=64,
        attn_impl="ulysses" if attn == "ulysses_flash" else attn,
        sp_use_flash=attn == "ulysses_flash", dtype=jnp.float32,
        n_experts=workers.TPMOE_E, capacity_factor=cf)
    return JaxLM(cfg)


@functools.lru_cache(maxsize=None)
def _numpy_params(vocab: int = workers.TP_VOCAB, seed: int = 0):
    """The JAX model's parameter tree drawn with numpy: kernels, embeddings,
    biases and experts normal(0, 0.02), LayerNorm scales 1 + normal(0,
    0.1)."""
    ids = workers.tp_batch(vocab)[0]
    shapes = jax.eval_shape(lambda: nn.unbox(_jax_model("tp4", vocab, "dense").init(
        jax.random.PRNGKey(0), ids))["params"])
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


def _objective(model, ids):
    """lm_loss plus TPMOE_AUX times the sown auxiliary losses."""
    def f(p):
        logits, upd = model.apply({"params": p}, ids, mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(upd["losses"]))
        return jax_lm_loss(logits, ids) + workers.TPMOE_AUX * aux
    return f


def _jax_dropped(name: str, params, ids, vocab: int) -> list:
    """Each MoE layer's dropped tokens, from the flax router's logits (the
    model with dense attention, the same function)."""
    model = _jax_model(name, vocab, "dense")
    _, inter = model.apply({"params": params}, jnp.asarray(ids),
                           capture_intermediates=True, mutable=["intermediates"])
    C = max(1, int(model.cfg.capacity_factor * ids.size / workers.TPMOE_E))
    stack = inter["intermediates"]["stack"]
    out = []
    for layer in sorted(stack):
        if "moe" in stack[layer]:
            logits = np.asarray(stack[layer]["moe"]["router"]["__call__"][0], np.float32)
            counts = np.bincount(logits.argmax(-1), minlength=workers.TPMOE_E)
            out.append(int(np.maximum(counts - C, 0).sum()))
    return out


def _port_cfg(name: str, vocab: int = workers.TP_VOCAB):
    return workers.tpmoe_config(torch, name, vocab=vocab)


@pytest.fixture(scope="module")
def tp_moe_world(tmp_path_factory):
    params = _numpy_params()
    train_params = _numpy_params(workers.TP_TRAIN_VOCAB, seed=1)
    ranks = workers.spawn_world(4, tmp_path_factory.mktemp("tpmoe"), "_run_tp_moe_world",
                                params, train_params)
    one = workers.spawn_world(1, tmp_path_factory.mktemp("tpmoe1"), "_run_tp_moe_one")[0]
    return {"ranks": ranks, "one": one}


def _at(ranks, name: str, **coords) -> list:
    """The ranks' results of case ``name`` whose coordinates match."""
    return [r[name] for r in ranks
            if all(r[name]["coords"][a] == v for a, v in coords.items())]


def _joined(ranks, name: str, get, cfg, dp: int = 0, sp: int = 0) -> dict:
    """The tensors ``get(result)`` of the ranks at (dp, sp) joined over tp
    within each ep index, then over ep: the full model's."""
    shape = _shape(name)
    per_ep = []
    for e in range(shape["ep"]):
        by_tp = [{k: torch.from_numpy(v) for k, v in get(_at(ranks, name, dp=dp, sp=sp, ep=e,
                                                               tp=t)[0]).items()}
                 for t in range(shape["tp"])]
        per_ep.append(tp_join(by_tp, cfg))
    return ep_join(per_ep)


@functools.lru_cache(maxsize=None)
def _jax_reference(name: str) -> dict:
    """The JAX model on the case's mesh from the numpy weights: its logits,
    the gradients of the objective (the port's full layout) and the dropped
    tokens."""
    params = _numpy_params()
    model = _jax_model(name)
    ids = jnp.asarray(workers.tp_batch()[0])
    with set_mesh(_jax_mesh(name)):
        logits = jax.jit(lambda p: model.apply({"params": p}, ids))(params)
        grads = jax.jit(jax.grad(_objective(model, ids)))(params)
    return {"logits": np.asarray(logits),
            "grads": flax_to_torch(jax.tree.map(np.asarray, grads), _port_cfg(name)),
            "dropped": _jax_dropped(name, params, np.asarray(ids), workers.TP_VOCAB)}


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_logits_match_jax(tp_moe_world, name):
    want = _jax_reference(name)["logits"]
    shape = _shape(name)
    B, S, V = want.shape
    Bl, Sl = B // shape["dp"], S // shape["sp"]
    got = np.full(want.shape, np.nan, np.float32)
    for r in tp_moe_world["ranks"]:
        c, logits = r[name]["coords"], r[name]["model"]["logits"]
        cols = shard_range(V, shape["tp"], c["tp"])
        block = got[c["dp"] * Bl:(c["dp"] + 1) * Bl, c["sp"] * Sl:(c["sp"] + 1) * Sl,
                    cols.start:cols.stop]
        if c["ep"] == 0:
            block[...] = logits
        else:   # tokens are replicated over ep
            np.testing.assert_array_equal(logits, block)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    losses = [r[name]["model"]["loss"] for r in tp_moe_world["ranks"]]
    assert losses == [losses[0]] * len(losses)     # every rank computes the global objective


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_gradients_match_jax(tp_moe_world, name):
    want = _jax_reference(name)["grads"]
    ranks = tp_moe_world["ranks"]
    shape = _shape(name)
    cfg = _port_cfg(name)
    for dp in range(shape["dp"]):
        for sp in range(shape["sp"]):
            got = _joined(ranks, name, lambda r: r["model"]["grads"], cfg, dp, sp)
            assert sorted(got) == sorted(want)
            for key, w in want.items():
                assert got[key].shape == w.shape, key
                np.testing.assert_allclose(got[key].numpy(), w.numpy(), err_msg=key, **TOL)


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_dropped_tokens_match_jax(tp_moe_world, name):
    want = _jax_reference(name)["dropped"]
    for r in tp_moe_world["ranks"]:
        assert list(r[name]["model"]["dropped"]) == want
    if workers.TPMOE_CASES[name][1] < 1:
        assert sum(want) > 0


def _lines(ranks, name: str, axis: str) -> list:
    """The ranks' results of case ``name`` grouped by every coordinate but
    ``axis``: the lines along ``axis``."""
    out = {}
    for r in ranks:
        c = r[name]["coords"]
        out.setdefault(tuple(v for a, v in sorted(c.items()) if a != axis), []).append(r[name])
    return list(out.values())


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_routes_are_bitwise_on_every_tp_and_ep_line(tp_moe_world, name):
    ranks = tp_moe_world["ranks"]
    for axis in ("tp", "ep"):
        for line in _lines(ranks, name, axis):
            first = line[0]
            for res in line[1:]:
                for a, b in zip(res["model"]["routes"], first["model"]["routes"]):
                    np.testing.assert_array_equal(a, b)
                for step_a, step_b in zip(res["train"]["routes"], first["train"]["routes"]):
                    for a, b in zip(step_a, step_b):
                        np.testing.assert_array_equal(a, b)
    assert all(len(r[name]["train"]["routes"]) == workers.TPMOE_STEPS for r in ranks)


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_replicated_gradients_are_bitwise(tp_moe_world, name):
    """Every gradient not cut over tp is equal on each tp line, every one
    not cut over ep (the non-expert ones) on each ep line: in the model
    case and in the train step's step-1 gradients."""
    ranks = tp_moe_world["ranks"]
    shape = _shape(name)
    cfg = _port_cfg(name)
    for kind in ("model", "train"):
        keys = list(ranks[0][name][kind]["grads"])
        not_tp = [k for k in keys if tp_cut(k, cfg, shape["tp"], 0) is None]
        not_ep = [k for k in keys if not k.endswith(EXPERT_PARAMS)]
        assert any(k.endswith("moe.router.weight") for k in not_tp)
        for axis, replicated in (("tp", not_tp), ("ep", not_ep)):
            for line in _lines(ranks, name, axis):
                for res in line[1:]:
                    for k in replicated:
                        np.testing.assert_array_equal(res[kind]["grads"][k],
                                                      line[0][kind]["grads"][k], err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_init_holds_the_weights_of_the_model_with_no_mesh(tp_moe_world, name):
    from horovod_tpu_torch.models.transformer import TransformerLM

    cfg = _port_cfg("ep2_tp2")
    full = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    shape = _shape(name)
    for dp in range(shape["dp"]):
        for sp in range(shape["sp"]):
            got = _joined(tp_moe_world["ranks"], name, lambda r: r["init"], cfg, dp, sp)
            for k, v in full.state_dict().items():
                assert torch.equal(got[k], v), (dp, sp, k)


@pytest.fixture(scope="module")
def jax_train(tp_moe_world):
    """JAX's make_train_step(moe_aux_weight=0.01) on each case's mesh from
    the numpy weights: the step-1 gradients, the losses, the dropped tokens
    before each step and the final parameters (the port's full layout)."""
    params = _numpy_params(workers.TP_TRAIN_VOCAB, seed=1)
    ids = workers.tp_batch(workers.TP_TRAIN_VOCAB, seed=6)[0]
    out = {}
    for name in CASES:
        model = _jax_model(name, workers.TP_TRAIN_VOCAB)
        cfg = _port_cfg(name, workers.TP_TRAIN_VOCAB)
        tx = optax.adamw(workers.TP_LR, weight_decay=workers.TP_WD, eps=workers.TP_EPS)
        build = jax_make_train_step(model, tx, jax_lm_loss, mesh=_jax_mesh(name),
                                    rules=JAX_RULES, shard_seq=_shape(name)["sp"] > 1,
                                    moe_aux_weight=workers.TPMOE_AUX)
        _, step_fn, shardings = build(jax.random.PRNGKey(0), ids, ids)
        state = jax.device_put(JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                             opt_state=tx.init(params)), shardings)
        dense = _jax_model(name, workers.TP_TRAIN_VOCAB, "dense")
        grads = flax_to_torch(jax.tree.map(np.asarray, jax.grad(
            _objective(dense, jnp.asarray(ids)))(params)), cfg)
        losses, dropped = [], []
        for _ in range(workers.TPMOE_STEPS):
            dropped.append(_jax_dropped(name, jax.tree.map(np.asarray, state.params), ids,
                                        workers.TP_TRAIN_VOCAB))
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
        out[name] = {"grads": grads, "losses": losses, "dropped": np.array(dropped),
                     "params": flax_to_torch(jax.tree.map(np.asarray, state.params), cfg)}
    return out


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_train_step_matches_jax(tp_moe_world, jax_train, name):
    ranks = tp_moe_world["ranks"]
    ref = jax_train[name]
    cfg = _port_cfg(name, workers.TP_TRAIN_VOCAB)
    for r in ranks:
        np.testing.assert_allclose(r[name]["train"]["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_array_equal(r[name]["train"]["dropped"], ref["dropped"])
    if workers.TPMOE_CASES[name][1] < 1:
        assert ref["dropped"].sum() > 0
    shape = _shape(name)
    for dp in range(shape["dp"]):
        for sp in range(shape["sp"]):
            grads = _joined(ranks, name, lambda r: r["train"]["grads"], cfg, dp, sp)
            params = _joined(ranks, name, lambda r: r["train"]["params"], cfg, dp, sp)
            assert sorted(params) == sorted(ref["params"])
            for key, w in ref["params"].items():
                g = ref["grads"][key].numpy()
                np.testing.assert_allclose(grads[key].numpy(), g, err_msg=key,
                                           **TRAIN_GRAD_TOL)
                w, a = w.numpy(), params[key].numpy()
                well = np.abs(g) > 100 * workers.TP_EPS
                np.testing.assert_allclose(a[well], w[well], rtol=1e-5, atol=1e-6, err_msg=key)
                assert np.all(np.abs(a[~well] - w[~well])
                              <= 2.0001 * workers.TP_LR * workers.TPMOE_STEPS), key


@pytest.mark.parametrize("name", CASES)
def test_tp_moe_expert_weights_are_copied_over_the_data_line(tp_moe_world, name):
    """``logical_axes`` gives an expert weight "expert" and "expert_mlp",
    so ``replica_comm`` (where init broadcasts it) is its (dp, sp) line."""
    for r in tp_moe_world["ranks"]:
        res = r[name]["train"]
        for key in EXPERT_PARAMS:
            names = [n for n in res["lines"] if n.endswith(key)]
            assert names
            for n in names:
                assert list(res["lines"][n]) == list(res["data_line"]), n


@pytest.mark.parametrize("ep,tp", [(2, 2), (1, 4), (4, 1)])
def test_convert_ep_tp_cut_joins_back(ep, tp):
    params = _numpy_params()
    cfg = _port_cfg("tp4")
    full = flax_to_torch(params, cfg)
    shards = [[flax_to_torch(params, cfg, ep=ep, ep_rank=e, tp=tp, tp_rank=t)
               for t in range(tp)] for e in range(ep)]
    d_ff = {len(shard_range(cfg.d_ff, tp, t)) for t in range(tp)}
    for e in range(ep):
        for t in range(tp):
            wi = shards[e][t]["stack.layers.1.moe.wi"]
            assert wi.shape[0] == workers.TPMOE_E // ep and wi.shape[2] in d_ff
    joined = ep_join([tp_join(by_tp, cfg) for by_tp in shards])
    assert sorted(joined) == sorted(full)
    for k, v in full.items():
        assert torch.equal(joined[k], v), k


def test_tp1_ep1_mesh_is_bitwise_the_model_with_no_mesh(tp_moe_world):
    one = tp_moe_world["one"]
    np.testing.assert_array_equal(one["mesh"]["losses"], one["bare"]["losses"])
    np.testing.assert_array_equal(one["mesh"]["dropped"], one["bare"]["dropped"])
    assert one["mesh"]["dropped"].sum() > 0
    for k, g in one["bare"]["grads"].items():
        np.testing.assert_array_equal(one["mesh"]["grads"][k], g, err_msg=k)


def test_train_gpt2_tp_ep_moe(tp_moe_world):
    ranks = tp_moe_world["ranks"]
    for res in ranks:
        assert len(res["train_gpt2"]) == 2 and np.all(np.isfinite(res["train_gpt2"]))
        np.testing.assert_array_equal(res["train_gpt2"], ranks[0]["train_gpt2"])


def _live_bytes(model) -> int:
    """The bytes of the tensors alive other than the model's parameters."""
    import gc

    gc.collect()
    params = {p.data_ptr() for p in model.parameters()}
    return sum(o.untyped_storage().nbytes() for o in gc.get_objects()
               if isinstance(o, torch.Tensor) and o.data_ptr() not in params)


def test_remat_recomputation_leaves_the_moe_state_of_the_forward():
    """Under remat, backward runs each block's forward again; a Switch
    FFN keeps the aux loss, dropped tokens and routes of the forward, so
    the recomputed block's activations do not stay alive through the aux
    loss's graph after backward: what is left is what the model keeps
    without remat."""
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.train import lm_loss

    ids = torch.from_numpy(workers.tp_batch()[0]).long()
    left = {}
    for remat in (False, True):
        cfg = dataclasses.replace(_port_cfg("tp4"), remat=remat, n_layers=4, attn_impl="dense")
        model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        for p in model.parameters():
            p.register_post_accumulate_grad_hook(lambda p: setattr(p, "grad", None))
        loss = lm_loss(model(ids), ids) + workers.TPMOE_AUX * model.moe_aux_loss()
        state = [(b.aux, b.dropped, b.expert_idx) for b in model.moe_blocks()]
        loss.backward()
        del loss
        for block, (aux, dropped, routes) in zip(model.moe_blocks(), state):
            assert block.aux is aux and block.dropped is dropped
            assert block.expert_idx is routes
        left[remat] = _live_bytes(model)
        del model, state
    assert left[True] <= left[False] + 4096, left
