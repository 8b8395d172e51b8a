"""FSDP in the port (``FSDP_RULES`` in ``parallel/sharding.py``,
``parallel/fsdp.py``, the model under ``rules=FSDP_RULES``,
``models/convert.py``'s dp cut and ``fsdp_join``, ``make_train_step(rules=
FSDP_RULES)``) against the JAX package, on spawned gloo ranks.

gpt2-tiny cut to vocab 128, d_model 32, d_ff 64, 2 layers, S=16, B=4
(``workers.zm_config``), weights drawn with numpy, each rank loading its
cut (``flax_to_torch(..., dp=, dp_rank=, tp=, tp_rank=)``), 3 AdamW steps:

* on dp=2 (a plain optimizer, and a ``DistributedOptimizer`` passed in)
  and on dp=2 x tp=2 (f32 and bf16) against JAX's ``make_train_step(rules=
  FSDP_RULES)`` on the same CPU mesh: the losses, and the parameters joined
  by ``fsdp_join`` then ``tp_join``; every rank's parameter shapes equal
  the shard shapes of JAX's ``NamedSharding``s under ``FSDP_RULES``; the
  tensors without a d_model dimension bitwise equal along the dp line;
  optimizer-state bytes at their closed form (two f32 moments of what the
  rank holds);
* the initialisation: every FSDP layout of one torch seed holds the
  weights of the model built with no mesh, bitwise;
* the rule table (``FSDP_RULES`` is the JAX table's rows for the port's
  parameters), the dp cut's uneven split, the gather and its backward at a
  line of one member and over uneven shards;
* FSDP with Switch experts under tp, with pp, with sp and tp together
  (dp x sp x tp, named on a mesh of eight without its communicators),
  ``DistributedOptimizer(backward_passes_per_step=2)`` on FSDP-cut
  parameters, and the BERT encoder under ``FSDP_RULES`` raise
  ``NotImplementedError`` naming ROADMAP A3 (FSDP under sp runs:
  tests/test_torch_port_fsdp_sp.py; with ep and experts:
  tests/test_torch_port_fsdp_moe.py).

Tolerances as tests/test_torch_port_zero_mesh.py (``_torch_port_jax``).
"""
import numpy as np
import pytest
import torch

from horovod_tpu.parallel.sharding import FSDP_RULES as JAX_FSDP

import _torch_port_jax as ref
import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import flax_to_torch, fsdp_join, tp_join
from horovod_tpu_torch.parallel.fsdp import FSDP_PARAMS, fsdp_cut, gathered
from horovod_tpu_torch.parallel.mesh import Comm
from horovod_tpu_torch.parallel.sharding import DEFAULT_RULES, FSDP_RULES

SHAPES = {2: {"dp": 2}, 4: {"dp": 2, "tp": 2}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params = {"float32": ref.numpy_params(seed=0), "bfloat16": ref.numpy_params(seed=1)}
    ranks = {size: workers.spawn_world(size, tmp_path_factory.mktemp(f"fsdp{size}"),
                                       "_run_fsdp_world", params["float32"],
                                       params["bfloat16"])
             for size in (2, 4)}
    return {"ranks": ranks, "params": params}


@pytest.fixture(scope="module")
def jax_runs(worlds):
    p = worlds["params"]
    return {"fsdp_dp2": ref.train(SHAPES[2], p["float32"], rules=JAX_FSDP),
            "fsdp_dp2_tp2": ref.train(SHAPES[4], p["float32"], rules=JAX_FSDP),
            "fsdp_dp2_tp2_bf16": ref.train(SHAPES[4], p["bfloat16"], "bfloat16",
                                           rules=JAX_FSDP)}


def _joined(ranks, key: str) -> dict:
    """The full model from every rank's ``ranks[r][key]`` (a state_dict of
    numpy arrays): the dp shards of each tp rank joined, then the tp
    ranks'."""
    cfg = workers.zm_config(torch)
    by_tp = {}
    for r in ranks:
        c = r["coords"]
        by_tp.setdefault(c.get("tp", 0), []).append(
            (c["dp"], {k: torch.from_numpy(v) for k, v in r[key].items()}))
    tps = [fsdp_join([sd for _, sd in sorted(by_tp[t], key=lambda x: x[0])])
           for t in sorted(by_tp)]
    return tp_join(tps, cfg)


CASES = [("fsdp_dp2", 2, "float32"), ("fsdp_dp2_passed", 2, "float32"),
         ("fsdp_dp2_tp2", 4, "float32"), ("fsdp_dp2_tp2_bf16", 4, "bfloat16")]


@pytest.mark.parametrize("name,size,dtype", CASES, ids=[c[0] for c in CASES])
def test_fsdp_train_step_matches_jax(worlds, jax_runs, name, size, dtype):
    runs = [r[name] for r in worlds["ranks"][size]]
    want = jax_runs[name.replace("_passed", "")]
    tol = dict(rtol=ref.F32_LOSS_RTOL) if dtype == "float32" else ref.BF16_TOL
    for r in runs:
        np.testing.assert_allclose(r["losses"], want["losses"], **tol)
    ref.assert_params_match(_joined(runs, "params"), want, dtype)


@pytest.mark.parametrize("size", sorted(SHAPES))
def test_fsdp_shard_shapes_are_jax_shardings(worlds, jax_runs, size):
    name = "fsdp_dp2" if size == 2 else "fsdp_dp2_tp2"
    want = ref.torch_shard_shapes(jax_runs[name]["shardings"], worlds["params"]["float32"])
    for r in worlds["ranks"][size]:
        got = {k: v.shape for k, v in r[name]["params"].items()}
        assert got == want
    # Every parameter with a d_model dimension is cut; the others are not.
    marked = worlds["ranks"][size][0]["marked"]
    assert marked and all(k.endswith(tuple(FSDP_PARAMS)) for k in marked)
    assert not any(k.endswith(("qkv.bias", "wi.bias")) for k in marked)


@pytest.mark.parametrize("size", sorted(SHAPES))
def test_fsdp_replicas_and_state_bytes(worlds, size):
    """The tensors without a d_model dimension are bitwise equal along the
    dp line (their gradients were all-reduced there), and the optimizer
    holds two f32 moments of what the rank holds."""
    name = "fsdp_dp2" if size == 2 else "fsdp_dp2_tp2"
    runs = [r[name] for r in worlds["ranks"][size]]
    tp = SHAPES[size].get("tp", 1)
    for r in runs:
        mate = runs[r["coords"].get("tp", 0)]
        for k, v in r["params"].items():
            if not k.endswith(tuple(FSDP_PARAMS)):
                np.testing.assert_array_equal(v, mate["params"][k], err_msg=k)
        assert r["state_bytes"] == 2 * 4 * sum(v.size for v in r["params"].values())
    held = sum(v.size for v in runs[0]["params"].values())
    full = sum(v.numel() for v in _joined(runs, "params").values())
    assert held < full / tp      # each rank holds less than its tp share


@pytest.mark.parametrize("size", sorted(SHAPES))
def test_fsdp_init_holds_the_world_one_weights(worlds, size):
    from horovod_tpu_torch.models.transformer import TransformerLM

    cfg = workers.zm_config(torch)
    full = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ranks = [dict(r, coords=r[f"fsdp_{'dp2' if size == 2 else 'dp2_tp2'}"]["coords"])
             for r in worlds["ranks"][size]]
    got = _joined(ranks, "init")
    for k, v in full.state_dict().items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("combo", ["dp_sp_tp", "moe_tp", "pp", "accumulation", "bert"])
def test_fsdp_combinations_not_ported_raise(worlds, combo):
    for r in worlds["ranks"][4]:
        msg = r["raises"][combo]
        assert msg.startswith("NotImplementedError") and "ROADMAP A3" in msg, msg


def test_fsdp_convert_cuts_and_joins(worlds):
    """flax_to_torch's dp cut at dp=2 and dp=4 joins back to the full
    state_dict bitwise, composed with tp=2."""
    cfg = workers.zm_config(torch)
    params = worlds["params"]["float32"]
    full = flax_to_torch(params, cfg)
    for dp in (2, 4):
        tps = [fsdp_join([flax_to_torch(params, cfg, tp=2, tp_rank=t, dp=dp, dp_rank=d)
                          for d in range(dp)]) for t in range(2)]
        got = tp_join(tps, cfg)
        for k, v in full.items():
            assert torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# One process: the rule table, the cut and the gather.
def test_fsdp_rules_are_the_jax_table():
    jax_rows = dict(JAX_FSDP)
    for logical, axes in FSDP_RULES:
        assert jax_rows[logical] == axes, logical
    assert dict(FSDP_RULES)["embed"] == ("dp",) and dict(DEFAULT_RULES)["embed"] is None
    assert {k: v for k, v in FSDP_RULES if k != "embed"} == {
        k: v for k, v in DEFAULT_RULES if k != "embed"}


@pytest.mark.parametrize("n,dp,want", [(32, 2, [16, 16]), (10, 4, [3, 3, 3, 1]),
                                       (2048, 4, [512] * 4)])
def test_fsdp_cut_is_the_jax_split(n, dp, want):
    cfg = workers.zm_config(torch, d_model=n, n_heads=1)
    cuts = [fsdp_cut("stack.layers.0.mlp.wi.weight", cfg, Comm(None, dp, r, tuple(range(dp))))
            for r in range(dp)]
    assert [len(c.units) for c in cuts] == want
    t = torch.randn(6, n)
    assert torch.equal(torch.cat([c.take(t) for c in cuts], dim=1), t)


def test_fsdp_gather_at_one_member_is_the_parameter():
    p = torch.nn.Parameter(torch.randn(5, 3))
    assert gathered(p) is p
    cut = fsdp_cut("ln_f.weight", workers.zm_config(torch), Comm(None, 1, 0, (0,)))
    assert cut is None


def test_fsdp_gather_over_uneven_shards_is_the_tensor_on_one_rank(monkeypatch):
    """The padded gather and its backward over an uneven split, with the
    line's collective replaced by this rank's copies (every member holding
    the same padded shard): the narrow cuts the padding away, and backward
    returns the padded rows' cotangent nowhere."""
    from horovod_tpu_torch.parallel import fsdp

    calls = []

    def fake_all_gather(x, comm, dim, name):
        calls.append((tuple(x.shape), dim, name))
        return torch.cat([x] * comm.size, dim=dim)

    monkeypatch.setattr(fsdp, "all_gather", fake_all_gather)
    cfg = workers.zm_config(torch, d_model=10, n_heads=1)
    cut = fsdp_cut("ln_f.weight", cfg, Comm(None, 4, 3, (0, 1, 2, 3)))
    p = torch.arange(1.0, 2.0, requires_grad=True)      # rank 3 holds 1 of 10
    full = cut.gather(p)
    assert full.shape == (10,) and calls == [((3,), 0, "hvd.fsdp.all_gather")]
    assert torch.equal(full[9:], p.detach())
    full.sum().backward()
    assert p.grad.shape == (1,)
