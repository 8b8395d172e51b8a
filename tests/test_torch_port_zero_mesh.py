"""ZeRO on a mesh line in the port (``optim/zero.py`` over a ``Comm``,
``DistributedOptimizer(zero=, error_feedback=, axis_name=)``,
``make_train_step(zero=True)``) and the plain optimizer through
``make_train_step``, against the JAX package, on spawned gloo ranks.

gpt2-tiny cut to vocab 128, d_model 32, d_ff 64, 2 layers, S=16, B=4
(``workers.zm_config``), weights drawn with numpy, 3 AdamW steps:

* a plain ``torch.optim.AdamW`` through ``make_train_step`` on dp=2: the
  replicas bitwise equal, the losses and parameters those of the JAX
  ``make_train_step(model, optax.adamw, ...)`` on a dp=2 CPU mesh. Both
  assertions fail where the step stepped a plain optimizer on each rank's
  own gradients (the replicas then differ after one step);
* ``make_train_step(zero=True)`` on dp=2 (with the plain optimizer, and
  with a ``DistributedOptimizer(zero=1)`` passed in) and on dp=2 x tp=2
  (f32 and bf16) against JAX's ``make_train_step(zero=True)`` on the same
  mesh; the optimizer-state bytes a rank holds at their closed form (two
  f32 moments of a 1/dp share of its parameters, plus the padding);
* ZeRO over ("dp", "sp") with ``shard_seq`` (dp=2 x sp=2) and over dp with
  ep=2 and a Switch FFN (4 experts), each against ``zero=False`` on the same
  mesh;
* the optimizer over the dp line of a dp=2 x tp=2 mesh, each rank with
  its own gradients: ZeRO-1 against the replicated optimizer on the line,
  the lines apart; ZeRO-1 and ZeRO-2 with SGD, whose step shows AVERAGE's
  divisor, against the replicated optimizer and the closed form; the ``HOROVOD_ZERO_SHARDING`` default on the line;
  error feedback's drift on the bf16 lane; the
  line-stacked state re-cut 2 -> 3 -> 2 bitwise and one member's shard out
  of it;
* what raises: ``zero=True`` without a dp axis, with ``FSDP_RULES``, with a
  ``DistributedOptimizer`` that is not ZeRO; ``rules=`` that are not the
  model's; ZeRO and error feedback on FSDP-cut parameters.

Tolerances (``_torch_port_jax``): losses rtol 1e-5 in f32; parameters rtol
1e-5, atol 1e-6 wherever the step-1 gradient exceeds 100 x AdamW's eps (the
rest within 2 lr a step, tests/test_torch_port_tp.py's rule); bf16 losses
and parameters at the tp tests' bf16 tolerance, rtol 5e-2, atol 2e-2.
"""
import numpy as np
import pytest
import torch

import _torch_port_jax as ref
import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import tp_join

RTOL, ATOL = 1e-5, 1e-6     # the line cases, as tests/test_torch_port_zero.py


@pytest.fixture(scope="module")
def params():
    return {"float32": ref.numpy_params(seed=0), "bfloat16": ref.numpy_params(seed=1)}


@pytest.fixture(scope="module")
def worlds(params, tmp_path_factory):
    ranks = {size: workers.spawn_world(size, tmp_path_factory.mktemp(f"zm{size}"),
                                       "_run_zero_mesh_world", params["float32"],
                                       params["bfloat16"])
             for size in (2, 4)}
    return {"ranks": ranks, "params": params}


@pytest.fixture(scope="module")
def plain_world(params, tmp_path_factory):
    return workers.spawn_world(2, tmp_path_factory.mktemp("zm_plain"), "_run_plain_step_world",
                               params["float32"])


@pytest.fixture(scope="module")
def jax_runs(params):
    p = params
    return {"plain_dp2": ref.train({"dp": 2}, p["float32"]),
            "zero_dp2": ref.train({"dp": 2}, p["float32"], zero=True),
            "zero_dp2_tp2": ref.train({"dp": 2, "tp": 2}, p["float32"], zero=True),
            "zero_dp2_tp2_bf16": ref.train({"dp": 2, "tp": 2}, p["bfloat16"], "bfloat16",
                                           zero=True)}


def _joined(runs, tp: int) -> dict:
    """Rank (dp 0)'s tp shards joined to the full model."""
    cfg = workers.zm_config(torch)
    return tp_join([{k: torch.from_numpy(v) for k, v in runs[t]["params"].items()}
                    for t in range(tp)], cfg)


def test_plain_optimizer_keeps_bitwise_replicas_and_matches_jax(plain_world, jax_runs):
    """make_train_step wraps a plain optimizer over the data line, as GSPMD
    averages the JAX step's gradients whatever tx is. The case passes no
    keyword the wrap added, so it runs on the commit before the wrap, where
    both ranks stepped their own gradients and the replica assertion
    fails."""
    runs = plain_world
    for k in runs[0]["params"]:
        np.testing.assert_array_equal(runs[0]["params"][k], runs[1]["params"][k], err_msg=k)
    want = jax_runs["plain_dp2"]
    for r in runs:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=ref.F32_LOSS_RTOL)
    ref.assert_params_match(_joined(runs, 1), want, "float32")
    assert [r["optimizer"] for r in runs] == ["DistributedOptimizer"] * 2


CASES = [("zero_dp2", 2, 1, "float32"), ("zero_dp2_passed", 2, 1, "float32"),
         ("zero_dp2_tp2", 4, 2, "float32"), ("zero_dp2_tp2_bf16", 4, 2, "bfloat16")]


@pytest.mark.parametrize("name,size,tp,dtype", CASES, ids=[c[0] for c in CASES])
def test_zero_train_step_matches_jax(worlds, jax_runs, name, size, tp, dtype):
    runs = [r[name] for r in worlds["ranks"][size]]
    want = jax_runs[name.replace("_passed", "")]
    tol = dict(rtol=ref.F32_LOSS_RTOL) if dtype == "float32" else ref.BF16_TOL
    for r in runs:
        np.testing.assert_allclose(r["losses"], want["losses"], **tol)
    ref.assert_params_match(_joined(runs, tp), want, dtype)
    # Every member of a dp line holds the same parameters, bitwise.
    for r in runs[tp:]:
        mate = runs[r["coords"].get("tp", 0)]
        for k in r["params"]:
            np.testing.assert_array_equal(r["params"][k], mate["params"][k], err_msg=k)


@pytest.mark.parametrize("name,size,tp,dtype", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_zero_state_bytes_are_the_closed_form(worlds, name, size, tp, dtype):
    """Two f32 AdamW moments over this rank's 1/dp share of the flat
    parameters (padded to a multiple of dp)."""
    for r in worlds["ranks"][size]:
        total = sum(v.size for v in r[name]["params"].values())
        assert r[name]["state_bytes"] == 2 * 4 * (-(-total // 2))


@pytest.mark.parametrize("what", ["sp", "moe"])
def test_zero_over_the_data_line_matches_replicated(worlds, what):
    """ZeRO over ("dp", "sp") with shard_seq on dp=2 x sp=2, and over dp on
    dp=2 x ep=2 with 4 Switch experts, against zero=False on the same
    mesh: the losses and every rank's parameters."""
    for r in worlds["ranks"][4]:
        z, rep = r[f"{what}_zero1"], r[f"{what}_zero0"]
        np.testing.assert_allclose(z["losses"], rep["losses"], rtol=ref.F32_LOSS_RTOL)
        assert z["state_bytes"] < rep["state_bytes"]
        for k, v in rep["params"].items():
            np.testing.assert_allclose(z["params"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_sgd_on_a_line_steps_by_the_line_mean(worlds, stage):
    """SGD's step is the reduced gradient itself (AdamW's normalised step
    hides a wrong AVERAGE divisor): ZeRO over the dp line of dp=2 x tp=2
    against the replicated optimizer on the same line and against p0 - lr
    times the sum over steps of the line members' mean gradient."""
    p0, grads = workers.zero_params(), workers.zero_grads(4, 3)
    for r in worlds["ranks"][4]:
        line = list(r["line"]["line"])
        got, rep = r["line"][f"sgd_zero{stage}"], r["line"]["sgd_replicated"]
        for i, k in enumerate(workers.ZERO_KEYS):
            want = p0[k].astype(np.float64) - workers.ZERO_SGD_LR * sum(
                g[k][line].astype(np.float64).mean(0) for g in grads)
            np.testing.assert_allclose(got[i], rep[i], rtol=RTOL, atol=ATOL, err_msg=k)
            np.testing.assert_allclose(got[i], want, rtol=RTOL, atol=ATOL, err_msg=k)


def test_zero_on_a_line_matches_the_replicated_optimizer(worlds):
    ranks = [r["line"] for r in worlds["ranks"][4]]
    assert [tuple(r["line"]) for r in ranks] == [(0, 2), (1, 3), (0, 2), (1, 3)]
    for r in ranks:
        for a, b in zip(r["zero"], r["replicated"]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        assert r["status_world"] == 2
        assert r["env_default"] == (2, tuple(r["line"]))   # HOROVOD_ZERO_SHARDING=2
        # Two f32 moments over each member's half of the 270 elements.
        assert r["zero_bytes"] == 2 * 4 * 135 and r["replicated_bytes"] == 2 * 4 * 270
    for a, b in ((0, 2), (1, 3)):
        for x, y in zip(ranks[a]["zero"], ranks[b]["zero"]):
            np.testing.assert_array_equal(x, y)
    # Each line averaged its own members' gradients.
    assert not np.allclose(ranks[0]["zero"][1], ranks[1]["zero"][1], rtol=1e-3)


def test_state_recut_over_a_line_is_bitwise(worlds):
    for r in (w["line"] for w in worlds["ranks"][4]):
        assert r["global_world"] == 2 and r["from_global_matches"]
        assert sorted(r["global"]) == sorted(r["recut_back"])
        for k, v in r["global"].items():
            np.testing.assert_array_equal(r["recut_back"][k], v, err_msg=k)


def test_error_feedback_over_a_line_carries_the_residual(worlds):
    """150 SGD(1.0) steps of a constant gradient bf16 cannot represent, over
    the dp line: the bf16 wire drifts without error feedback, ten times
    less with it (tests/test_torch_port_zero.py's check, on a line)."""
    for r in (w["line"] for w in worlds["ranks"][4]):
        drift = r["drift"]
        assert drift["stateless"] > 0.1
        assert drift["ef0"] < drift["stateless"] / 10
        assert drift["zero1_ef"] < drift["stateless"] / 10


RAISES = {
    "zero_without_dp": ("ValueError", "needs a 'dp' axis"),
    "zero_with_fsdp": ("ValueError", "does not combine with FSDP_RULES"),
    "zero_with_replicated_optimizer": ("ValueError", "not ZeRO"),
    "rules_not_the_models": ("ValueError", "must be the model's rules"),
    "zero_optimizer_on_fsdp_params": ("ValueError", "ZeRO does not take parameters cut"),
    "error_feedback_on_fsdp_params": ("ValueError",
                                      "error feedback does not take parameters cut"),
}


@pytest.mark.parametrize("combo", sorted(RAISES))
def test_zero_combinations_that_raise(worlds, combo):
    kind, words = RAISES[combo]
    for r in worlds["ranks"][4]:
        msg = r["raises"][combo]
        assert msg.startswith(kind) and words in msg, msg


def test_jax_zero_is_the_plain_step(jax_runs):
    """The reference itself: JAX's zero=True changes only where the moments
    live, so its losses equal the plain step's."""
    np.testing.assert_allclose(jax_runs["zero_dp2"]["losses"], jax_runs["plain_dp2"]["losses"],
                               rtol=1e-6)
