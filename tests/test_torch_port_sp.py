"""Sequence parallelism in the port (``parallel/ring.py``,
``parallel/ulysses.py``, the sp dispatch of ``models/transformer.py`` and
``make_train_step(shard_seq=True)``) against the JAX package on the
8-device CPU mesh, on spawned gloo ranks whose mesh coordinates are those
of the JAX devices they stand for (``np.asarray(devices).reshape``).

* ``ring_attention`` and ``ulysses_attention`` (with and without
  ``use_flash``; on the CPU the port's flash takes its plain version, the
  JAX flash runs in interpret mode) at sp=4 on 4 ranks, causal and not,
  with and without a padding mask whose second row has two all-padding sp
  blocks: o and the gradients of q, k, v for one output cotangent against
  the JAX functions under ``shard_map``, at rtol 2e-4, atol 2e-5 (the
  tolerances of tests/test_parallel.py and tests/test_flash_attention.py).
* ``ring_attention`` in bf16 at sp=4, causal and not, on the same draws
  rounded to bf16: o and the gradients of q, k, v within 2 bf16 ulps of the
  JAX ring's (``test_sp_ring_bf16_matches_jax``). Each case also records the
  JAX ring's relative-norm distance from the JAX model's dense attention on
  the same inputs, the reference's own spread between the two.
* bert-tiny (4 heads) with Ulysses through flash under a padding mask on
  dp=2 x sp=2: the logits against the JAX model on the same mesh, at
  rtol 2e-4, atol 2e-4 (``test_model_ulysses_flash_on_dp_sp_mesh``).
* gpt2-tiny in f32 trained by ``make_train_step(shard_seq=True)`` with
  AdamW (lr 1e-4, wd 1e-4, eps 1e-8) for 3 steps on dp=2 x sp=2, with ring
  attention and with dense attention (gathered along sp), against JAX's
  ``make_train_step(shard_seq=True)`` on the same mesh: the losses at rtol
  1e-5, and the parameters at rtol 1e-5, atol 1e-6 wherever the step-1
  gradient exceeds 100 x AdamW's eps; elsewhere (the k bias, whose
  gradient is zero in exact arithmetic) AdamW's update is decided by
  rounding noise in both packages, and the two may differ by at most two
  steps' updates a step (tests/test_torch_port_gpt2.py).
* the collectives under ``axis_name=`` on the same world: allreduce,
  grouped_allreduce, allgather, broadcast, alltoall and reducescatter over
  ``"sp"``, over ``"dp"`` and over ``("dp", "sp")``, against closed forms.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import linen as nn
from jax.sharding import PartitionSpec as P

from horovod_tpu.models.transformer import BERT_CONFIGS as JAX_BERT
from horovod_tpu.models.transformer import GPT2_CONFIGS as JAX_GPT2
from horovod_tpu.models.transformer import TransformerEncoder as JaxEncoder
from horovod_tpu.models.transformer import TransformerLM as JaxLM
from horovod_tpu.parallel.mesh import create_mesh as jax_create_mesh
from horovod_tpu.parallel.ring import ring_attention as jax_ring
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from horovod_tpu.utils.compat import set_mesh, shard_map
from jax.sharding import Mesh

import _torch_port_workers as workers

SP = 4
ATTN_CASES = [(impl, causal, masked) for impl in workers.SP_IMPLS
              for causal in (True, False) for masked in (False, True)]
STEPS = 3
LR, WD, EPS = 1e-4, 1e-4, 1e-8


def _jax_mesh(shape: dict) -> Mesh:
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(tuple(shape.values())),
                tuple(shape))


@pytest.fixture(scope="module")
def sp_ranks(tmp_path_factory):
    return workers.spawn_world(SP, tmp_path_factory.mktemp("sp"), "_run_sp_attention",
                               ATTN_CASES, RING_BF16_CASES)


def _jax_attention(impl, causal, masked):
    q, k, v, cot, mask = workers.sp_inputs()
    mesh = _jax_mesh({"sp": SP})
    if impl == "ring":
        fn = lambda q, k, v, m: jax_ring(q, k, v, "sp", causal=causal, mask=m)
    else:
        fn = lambda q, k, v, m: jax_ulysses(q, k, v, "sp", causal=causal, mask=m,
                                            use_flash=impl == "ulysses_flash")
    spec = P(None, "sp")
    sm = shard_map(fn, mesh=mesh, in_specs=(spec,) * 4, out_specs=spec)
    m = jnp.asarray(mask if masked else np.ones_like(mask))
    if not masked:
        sm = shard_map(lambda q, k, v: fn(q, k, v, None), mesh=mesh,
                       in_specs=(spec,) * 3, out_specs=spec)
    args = (q, k, v, m) if masked else (q, k, v)
    o, vjp = jax.vjp(jax.jit(sm), *map(jnp.asarray, args))
    grads = vjp(jnp.asarray(cot))[:3]
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl,causal,masked", ATTN_CASES)
def test_sp_attention_matches_jax(sp_ranks, impl, causal, masked):
    want = _jax_attention(impl, causal, masked)
    key = f"{impl}-{causal}-{masked}"
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        got = np.concatenate([r[key][i] for r in sp_ranks], axis=1)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want[i], rtol=2e-4, atol=2e-5, err_msg=name)


RING_BF16_CASES = (True, False)      # causal


def _bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at |want| (f32's spacing
    times 2**16: bf16 keeps the top 16 bits of an f32)."""
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    return np.abs(got - want) / ulp


def _jax_bf16(fn, causal):
    q, k, v, cot, _ = workers.sp_inputs()
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    o, vjp = jax.vjp(fn, *args)
    return [np.asarray(t, np.float32) for t in (o, *vjp(jnp.asarray(cot, jnp.bfloat16)))]


@pytest.mark.parametrize("causal", RING_BF16_CASES)
def test_sp_ring_bf16_matches_jax(sp_ranks, causal, record_property):
    from horovod_tpu.models.transformer import _dense_attention_masked

    spec = P(None, "sp")
    ring = _jax_bf16(jax.jit(shard_map(
        lambda q, k, v: jax_ring(q, k, v, "sp", causal=causal), mesh=_jax_mesh({"sp": SP}),
        in_specs=(spec,) * 3, out_specs=spec)), causal)
    cfg = dataclasses.replace(JAX_GPT2["gpt2-tiny"], dtype=jnp.bfloat16, causal=causal)
    dense = _jax_bf16(lambda q, k, v: _dense_attention_masked(cfg, q, k, v, None), causal)
    spread = {}
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        got = np.concatenate([r[f"ring-bf16-{causal}"][i] for r in sp_ranks], axis=1)
        assert np.isfinite(got).all(), name
        assert _bf16_ulps(got, ring[i]).max() <= 2.0, name
        spread[name] = float(np.linalg.norm(ring[i] - dense[i]) / np.linalg.norm(dense[i]))
    # The reference's own spread: the JAX ring against the JAX model's dense
    # attention (probabilities rounded to bf16 before P·V), relative norm.
    print(f"JAX ring vs JAX dense, bf16, causal={causal}: {spread}")
    record_property("jax_ring_vs_dense_rel_norm", spread)


TRAIN_ATTNS = ("ring", "dense")


def _jax_bert():
    base = dataclasses.replace(JAX_BERT["bert-tiny"], max_len=64, n_layers=1, n_heads=4,
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               logits_dtype=jnp.float32)
    ids, mask = workers.sp_bert_batch()
    init = JaxEncoder(dataclasses.replace(base, attn_impl="dense"))
    params = jax.tree.map(np.asarray, nn.unbox(init.init(jax.random.PRNGKey(0), ids,
                                                         mask=mask))["params"])
    model = JaxEncoder(dataclasses.replace(base, attn_impl="ulysses", sp_use_flash=True))
    with set_mesh(_jax_mesh({"dp": 2, "sp": 2})):
        logits = jax.jit(lambda p, i, m: model.apply({"params": p}, i, mask=m))(
            params, ids, mask)
    return params, np.asarray(logits)


def _jax_gpt2_params():
    jmodel = JaxLM(dataclasses.replace(JAX_GPT2["gpt2-tiny"], dtype=jnp.float32))
    ids = workers.sp_train_ids()
    return jax.tree.map(np.asarray, nn.unbox(jmodel.init(jax.random.PRNGKey(0), ids))["params"])


@pytest.fixture(scope="module")
def sp_world(tmp_path_factory):
    bert_params, bert_logits = _jax_bert()
    gpt_params = _jax_gpt2_params()
    ranks = workers.spawn_world(4, tmp_path_factory.mktemp("spw"), "_run_sp_world",
                                bert_params, gpt_params, TRAIN_ATTNS)
    return {"ranks": ranks, "bert_logits": bert_logits, "gpt_params": gpt_params}


def _assemble(ranks, key):
    """The global (B, S, ...) array from the ranks' (dp, sp) blocks."""
    rows = []
    for d in range(2):
        rows.append(np.concatenate([ranks[d * 2 + s][key] for s in range(2)], axis=1))
    return np.concatenate(rows, axis=0)


def test_ranks_hold_the_jax_device_coordinates(sp_world):
    mesh = _jax_mesh({"dp": 2, "sp": 2})
    for rank, res in enumerate(sp_world["ranks"]):
        d, s = (int(i) for i in np.argwhere(mesh.devices == jax.devices()[rank])[0])
        assert tuple(res["coords"]) == (d, s)


def test_model_ulysses_flash_on_dp_sp_mesh_matches_jax(sp_world):
    got = _assemble(sp_world["ranks"], "bert_logits")
    np.testing.assert_allclose(got, sp_world["bert_logits"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("attn", TRAIN_ATTNS)
def test_train_step_shard_seq_matches_jax(sp_world, attn):
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS
    import torch

    ids = workers.sp_train_ids()
    jmodel = JaxLM(dataclasses.replace(JAX_GPT2["gpt2-tiny"], dtype=jnp.float32,
                                       attn_impl=attn))
    build = jax_make_train_step(jmodel, optax.adamw(LR, weight_decay=WD, eps=EPS),
                                jax_lm_loss, mesh=_jax_mesh({"dp": 2, "sp": 2}),
                                shard_seq=True)
    init_fn, step_fn, _ = build(jax.random.PRNGKey(0), ids, ids)
    state = init_fn(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state.params)
    # The jitted, sharded init draws what model.init draws, up to f32
    # rounding of the initialiser's scaling (~1e-8): the ranks start from
    # model.init's.
    for a, b in zip(jax.tree.leaves(params0), jax.tree.leaves(sp_world["gpt_params"])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)
    grads = flax_to_torch(jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_lm_loss(jmodel.apply({"params": p}, jnp.asarray(ids)),
                              jnp.asarray(ids)))(params0)), cfg)
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    want = flax_to_torch(jax.tree.map(np.asarray, state.params), cfg)
    for res in sp_world["ranks"]:
        got = res[f"train_{attn}"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for key, w in want.items():
            w, a, g = w.numpy(), got[key], grads[key].numpy()
            well = np.abs(g) > 100 * EPS
            np.testing.assert_allclose(a[well], w[well], rtol=1e-5, atol=1e-6, err_msg=key)
            assert np.all(np.abs(a[~well] - w[~well]) <= 2.0001 * LR * STEPS), key


def _line(rank, axes):
    """Global ranks of ``rank``'s line along ``axes`` of dp=2 x sp=2."""
    grid = np.arange(4).reshape(2, 2)
    d, s = divmod(rank, 2)
    if axes == "sp":
        return list(grid[d])
    if axes == "dp":
        return list(grid[:, s])
    return list(grid.reshape(-1))


@pytest.mark.parametrize("axes", ["sp", "dp", "dp+sp"])
def test_collectives_over_an_axis(sp_world, axes):
    line_axes = axes if "+" not in axes else ("dp", "sp")
    for rank, res in enumerate(sp_world["ranks"]):
        line = _line(rank, line_axes)
        vals = [workers.axis_value(r) for r in line]
        n, me = len(line), line.index(rank)
        np.testing.assert_array_equal(res[f"sum_{axes}"], sum(vals))
        np.testing.assert_allclose(res[f"avg_{axes}"], sum(vals) / n, rtol=1e-7)
        np.testing.assert_array_equal(res[f"grouped_{axes}"][1], sum(v[0] * 2 for v in vals))
        np.testing.assert_array_equal(res[f"gather_{axes}"], np.concatenate(
            [v[: 1 + r % 2] for v, r in zip(vals, line)]))
        np.testing.assert_array_equal(res[f"bcast_{axes}"], vals[1])
        rows = [np.arange(n * 2, dtype=np.float32) + 10 * r for r in line]
        np.testing.assert_array_equal(res[f"alltoall_{axes}"],
                                      np.concatenate([x[me * 2: me * 2 + 2] for x in rows]))
        np.testing.assert_array_equal(res[f"rs_{axes}"], sum(rows)[me * 2: me * 2 + 2])
