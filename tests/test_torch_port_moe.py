"""The Switch-MoE FFN of the port (``models/transformer.py`` ``SwitchMoE``)
and expert-parallel training against the JAX package.

* One rank: ``SwitchMoE``'s output, its auxiliary loss and its dropped
  tokens against the flax ``SwitchMoE`` on the same weights, in f32, at
  capacity factors 1.25 and 0.5 (output rtol 1e-5, atol 1e-6; aux rtol
  1e-6; the dropped tokens, counted from the flax router's logits,
  exactly); and the port's dispatch and combine by index bitwise equal to
  the one-hot einsum formulation it replaces.
* Four gloo ranks: gpt2-tiny (f32) with 4 experts in block 1, 3 AdamW
  steps (lr 1e-4, wd 1e-4, eps 1e-8) through ``make_train_step(
  moe_aux_weight=0.01)`` on dp=2 x ep=2 (dense attention) and on
  ep=2 x sp=2 (Ulysses attention, ``shard_seq``, capacity factor 0.5, so
  that tokens are dropped and the slots of a rank depend on the counts of
  the ranks before it), against JAX's ``make_train_step`` on the same
  meshes (rank i stands for JAX device i): the losses at rtol 1e-5; the
  parameters after the 3 steps at rtol 1e-5, atol 1e-6 where the step-1
  gradient exceeds 100 x AdamW's eps (elsewhere within two steps' updates
  a step, as tests/test_torch_port_gpt2.py explains), each rank's experts
  against its ep slice of JAX's; the dropped tokens of every step and MoE
  layer exactly, JAX's counted from its router's logits on the same
  parameters. The replicated parameters must be bitwise equal across ep
  ranks, and ``n_experts % ep != 0`` must raise.
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

from horovod_tpu.models.transformer import GPT2_CONFIGS as JAX_GPT2
from horovod_tpu.models.transformer import SwitchMoE as JaxSwitchMoE
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step

import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import flax_to_torch
from horovod_tpu_torch.models.transformer import (GPT2_CONFIGS, SwitchMoE, combine_by_index,
                                                  dispatch_by_index, dispatch_combine_einsum)

LR, WD, EPS, STEPS = workers.SP_LR, workers.SP_WD, workers.SP_EPS, workers.SP_STEPS


def _jax_mesh(shape: dict) -> Mesh:
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


def _dropped_from_logits(logits: np.ndarray, capacity: int) -> int:
    counts = np.bincount(np.asarray(logits, np.float32).argmax(-1), minlength=logits.shape[-1])
    return int(np.maximum(counts - capacity, 0).sum())


def _jax_dropped(jmodel, params, ids, cf) -> list:
    """Each MoE layer's dropped tokens, from the flax router's logits."""
    _, inter = jmodel.apply({"params": params}, jnp.asarray(ids),
                            capture_intermediates=True, mutable=["intermediates"])
    T = ids.size
    C = max(1, int(cf * T / workers.MOE_E))
    stack = inter["intermediates"]["stack"]
    return [_dropped_from_logits(stack[name]["moe"]["router"]["__call__"][0], C)
            for name in sorted(stack) if "moe" in stack[name]]


def _moe_cfgs(cf, **kw):
    jcfg = dataclasses.replace(JAX_GPT2["gpt2-tiny"], dtype=jnp.float32,
                               n_experts=workers.MOE_E, capacity_factor=cf, **kw)
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32,
                              n_experts=workers.MOE_E, capacity_factor=cf, **kw)
    return jcfg, cfg


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_switch_moe_matches_flax_on_one_rank(cf):
    jcfg, cfg = _moe_cfgs(cf)
    x = np.random.RandomState(3).randn(2, 24, jcfg.d_model).astype(np.float32)
    jmod = JaxSwitchMoE(jcfg)
    params = jax.tree.map(np.asarray, nn.unbox(jmod.init(jax.random.PRNGKey(1), x))["params"])
    want, coll = jmod.apply({"params": params}, x, mutable=["losses", "intermediates"],
                            capture_intermediates=True)
    C = max(1, int(cf * x.shape[0] * x.shape[1] / workers.MOE_E))
    mod = SwitchMoE(cfg, device="cpu")
    mod.load_state_dict({"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
                         "wi": torch.from_numpy(np.array(params["wi"])),
                         "wo": torch.from_numpy(np.array(params["wo"]))})
    got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(mod.aux.detach()), float(coll["losses"]["moe_aux"][0]), rtol=1e-6)
    logits = coll["intermediates"]["router"]["__call__"][0]
    assert int(mod.dropped) == _dropped_from_logits(logits, C)
    if cf < 1:
        assert int(mod.dropped) > 0


def test_dispatch_and_combine_by_index_equal_the_einsum_form():
    jcfg, cfg = _moe_cfgs(0.5)
    mod = SwitchMoE(cfg, device="cpu")
    torch.manual_seed(0)
    for p in mod.parameters():
        torch.nn.init.normal_(p, std=0.02)
    x = torch.randn(2, 24, cfg.d_model)
    with torch.no_grad():
        tokens, _, idx, gate, pos, keep, C, _, _ = mod.route(x)
        want_in, want_out = dispatch_combine_einsum(tokens, idx, gate, pos, keep,
                                                    cfg.n_experts, C, mod.experts, cfg.dtype)
        slots = torch.where(keep, idx * C + pos, cfg.n_experts * C)
        got_in = dispatch_by_index(tokens, slots, cfg.n_experts, C)
        got_out = combine_by_index(mod.experts(got_in), slots, gate)
    assert not keep.all()
    assert torch.equal(got_in, want_in) and torch.equal(got_out, want_out)


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    ids = workers.moe_ids()
    params, jax_runs = [], {}
    for name, shape, cf, attn, shard_seq in workers.MOE_CASES:
        jcfg, _ = _moe_cfgs(cf, attn_impl=attn)
        jmodel = JaxLM(jcfg)
        build = jax_make_train_step(jmodel, optax.adamw(LR, weight_decay=WD, eps=EPS),
                                    jax_lm_loss, mesh=_jax_mesh(shape), shard_seq=shard_seq,
                                    moe_aux_weight=workers.MOE_AUX)
        init_fn, step_fn, _ = build(jax.random.PRNGKey(0), ids, ids)
        state = init_fn(jax.random.PRNGKey(0))
        p0 = jax.tree.map(np.asarray, state.params)
        dense = JaxLM(dataclasses.replace(jcfg, attn_impl="dense"))

        def objective(p):
            logits, upd = dense.apply({"params": p}, jnp.asarray(ids), mutable=["losses"])
            aux = sum(jnp.sum(v) for v in jax.tree.leaves(upd["losses"]))
            return jax_lm_loss(logits, jnp.asarray(ids)) + workers.MOE_AUX * aux

        grads = jax.tree.map(np.asarray, jax.grad(objective)(p0))
        losses, dropped = [], []
        for _ in range(STEPS):
            dropped.append(_jax_dropped(dense, jax.tree.map(np.asarray, state.params), ids, cf))
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
        params.append(p0)
        jax_runs[name] = {"losses": losses, "dropped": np.array(dropped), "grads": grads,
                          "params": jax.tree.map(np.asarray, state.params)}
    ranks = workers.spawn_world(4, tmp_path_factory.mktemp("moe"), "_run_moe_world", params)
    return ranks, jax_runs


@pytest.mark.parametrize("case", [c[0] for c in workers.MOE_CASES])
def test_expert_parallel_training_matches_jax(moe_world, case):
    ranks, jax_runs = moe_world
    run = jax_runs[case]
    _, shape, cf, attn, _ = next(c for c in workers.MOE_CASES if c[0] == case)
    _, cfg = _moe_cfgs(cf, attn_impl=attn)
    ep = shape["ep"]
    for res in ranks:
        got = res[case]
        e = got["coords"]["ep"]
        np.testing.assert_allclose(got["losses"], run["losses"], rtol=1e-5)
        np.testing.assert_array_equal(got["dropped"], run["dropped"])
        want = flax_to_torch(run["params"], cfg, ep=ep, ep_rank=e)
        grads = flax_to_torch(run["grads"], cfg, ep=ep, ep_rank=e)
        assert set(want) == set(got["params"])
        for key, w in want.items():
            w, a, g = w.numpy(), got["params"][key], grads[key].numpy()
            well = np.abs(g) > 100 * EPS
            np.testing.assert_allclose(a[well], w[well], rtol=1e-5, atol=1e-6, err_msg=key)
            assert np.all(np.abs(a[~well] - w[~well]) <= 2.0001 * LR * STEPS), key
    assert run["dropped"].sum() > 0 or cf > 1


@pytest.mark.parametrize("case", [c[0] for c in workers.MOE_CASES])
def test_replicated_parameters_bitwise_equal_across_ep(moe_world, case):
    ranks, _ = moe_world
    by_data = {}
    for res in ranks:
        got = res[case]
        c = got["coords"]
        by_data.setdefault((c.get("dp", 0), c.get("sp", 0)), []).append(got["params"])
    for members in by_data.values():
        assert len(members) == 2
        for key, val in members[0].items():
            if key.endswith(("moe.wi", "moe.wo")):
                assert not np.array_equal(val, members[1][key]), key
            else:
                np.testing.assert_array_equal(val, members[1][key], err_msg=key)


def test_n_experts_indivisible_by_ep_raises(moe_world):
    ranks, _ = moe_world
    for res in ranks:
        assert "n_experts=3 must be divisible by ep=2" in res["indivisible"]
