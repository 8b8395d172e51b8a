"""FSDP with Switch experts and ep in the port: ``FSDP_RULES`` cutting the
router's and the experts' d_model over dp (``parallel/fsdp.py``,
``SwitchMoE``'s gathers in ``models/transformer.py``, the optimizer's line
in ``optim/distributed.py``, ``models/convert.py``'s ep and dp cuts,
``make_train_step(rules=FSDP_RULES, moe_aux_weight=)``) against the JAX
``make_train_step(rules=FSDP_RULES, moe_aux_weight=)`` on a CPU mesh of the
same shape, on four spawned gloo ranks (``workers.FSDPMOE_CASES``):
{"dp": 2, "ep": 2} with experts and dense, {"dp": 4} with experts, and
{"dp": 2, "sp": 2} with experts under Ulysses.

The model is tests/test_torch_port_fsdp.py's (``workers.zm_config``: vocab
128, d_model 32, 4 heads, d_ff 64, 2 layers, B=4, S=16) with 4 Switch
experts in block 1 (capacity 1.25, the auxiliary loss at 0.01; the
router sends most tokens to one expert at this seed, so tokens are
dropped), weights drawn with numpy, each rank loading its ep slice and dp
cut, 3 AdamW steps:

* every case in f32: the losses within ``F32_LOSS_RTOL`` of JAX's and the
  parameters, joined over dp (``fsdp_join``) and ep (``ep_join``), at
  ``F32_PARAM_TOL``; {"dp": 2, "ep": 2} under a ``DistributedOptimizer``
  passed in, bitwise the plain optimizer's run, and in bf16 at
  ``BF16_TOL``; {"dp": 2, "sp": 2} on the grouped after-backward reduction;
* the step-1 gradients AdamW gets, joined, against the world-1 model's
  (``lm_loss`` plus the weighted auxiliary loss) at rtol 1e-5, atol 1e-7:
  neither the gather's reduce-scatter over dp nor the optimizer's sum over
  sp may be dropped or doubled, and nothing may sum an expert over ep;
* each step's dropped tokens and every rank's routes equal to JAX's, from
  the same parameters;
* after every step each line of copies bitwise (a dp shard's copies
  across ep and sp, an expert's across sp, the uncut tensors everywhere);
  each rank's parameters and AdamW moments at their closed form; every
  rank's shapes the shard shapes of JAX's ``NamedSharding``s (the router
  ``P('dp', None)``, ``moe.wi`` ``P('ep', 'dp', None)``, ``moe.wo`` ``P('ep',
  None, 'dp')``);
* the initialisation from torch seed 0 and ``flax_to_torch(..., ep=,
  ep_rank=, dp=, dp_rank=)`` join to the world-1 model bitwise; the ep and
  dp cuts of the converter join back bitwise; an optimizer over ep, or
  over ("dp", "ep"), refuses the cut experts.

Under xdist the JAX references and the world are computed once per session
and shared through a file (``_torch_port_jax.shared``).
"""
import itertools

import numpy as np
import pytest
import torch

from horovod_tpu.parallel.sharding import FSDP_RULES as JAX_FSDP

import _torch_port_jax as ref
import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import (EXPERT_PARAMS, ep_join, flax_to_torch,
                                              fsdp_join)
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.parallel.fsdp import FSDP_PARAMS
from horovod_tpu_torch.parallel.train import lm_loss

CASES = list(workers.FSDPMOE_CASES)
MOE_CASES = [c for c in CASES if workers.FSDPMOE_CASES[c][2]]
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _shape(name: str) -> dict:
    return workers.FSDPMOE_CASES[name][0]


def _moe(name: str) -> bool:
    return workers.FSDPMOE_CASES[name][2]


def _cfg(name: str, dtype: str = "float32"):
    return workers.zm_config(torch, dtype, **workers.fsdpmoe_overrides(name))


def _jax_reference() -> dict:
    moe = {"n_experts": workers.FSDPMOE_E}
    params = {"float32": ref.numpy_params(seed=0, **moe),
              "bfloat16": ref.numpy_params(seed=1, **moe), "dense": ref.numpy_params(seed=0)}
    runs = {}
    for name in CASES:
        shape = _shape(name)
        runs[name] = ref.train(shape, params["float32" if _moe(name) else "dense"],
                               rules=JAX_FSDP, shard_seq=shape.get("sp", 1) > 1,
                               moe_aux_weight=workers.FSDPMOE_AUX if _moe(name) else 0.0,
                               **workers.fsdpmoe_overrides(name))
    name = workers.FSDPMOE_BF16
    runs["bf16"] = ref.train(_shape(name), params["bfloat16"], "bfloat16", rules=JAX_FSDP,
                             moe_aux_weight=workers.FSDPMOE_AUX,
                             **workers.fsdpmoe_overrides(name))
    for name, run in runs.items():
        sh = run.pop("shardings")
        if name in CASES:
            run["shard_shapes"] = ref.torch_shard_shapes(
                sh, params["float32" if _moe(name) else "dense"])
    return {"params": params, "runs": runs}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.shared(tmp_path_factory, "fsdp_moe_jax", _jax_reference)


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_ref):
    p = jax_ref["params"]
    return ref.shared(tmp_path_factory, "fsdp_moe_world4", lambda: workers.spawn_world(
        4, tmp_path_factory.mktemp("fsdp_moe"), "_run_fsdp_moe_world", p["float32"],
        p["bfloat16"], p["dense"]))


def _run(world, r, name: str, run: str = None) -> dict:
    return world[r]["runs"][run or name]


def _joined(world, name: str, get) -> dict:
    """The full model from ``get(run)`` (a state_dict of numpy arrays) on
    the ranks of sp index 0 of case ``name``: each ep index's dp shards
    joined, then the ep indices' experts."""
    shape = _shape(name)
    per_ep = []
    for e in range(shape.get("ep", 1)):
        line = sorted((r for r in range(len(world))
                       if _run(world, r, name)["coords"].get("ep", 0) == e
                       and _run(world, r, name)["coords"].get("sp", 0) == 0),
                      key=lambda r: _run(world, r, name)["coords"]["dp"])
        per_ep.append(fsdp_join([{k: torch.from_numpy(v) for k, v in get(world, r).items()}
                                 for r in line]))
    return ep_join(per_ep)


def _cut_axes(key: str) -> tuple:
    """The mesh axes parameter ``key`` is cut along under FSDP_RULES."""
    return ((("dp",) if key.endswith(tuple(FSDP_PARAMS)) else ())
            + (("ep",) if key.endswith(EXPERT_PARAMS) else ()))


def _mate(world, name: str, r: int, key: str) -> int:
    """The first rank of rank ``r``'s line of copies of ``key``: its
    coordinates on the axes ``key`` is cut along, 0 on the others."""
    own = _run(world, r, name)["coords"]
    cut = _cut_axes(key)
    for m in range(len(world)):
        c = _run(world, m, name)["coords"]
        if all(c.get(a, 0) == (own.get(a, 0) if a in cut else 0) for a in ("dp", "ep", "sp")):
            return m
    raise AssertionError(f"no first copy of {key} for rank {r}")


def test_world_coordinates(world):
    for name in CASES:
        shape = _shape(name)
        got = [tuple(_run(world, r, name)["coords"][a] for a in shape) for r in range(4)]
        assert got == list(itertools.product(*(range(n) for n in shape.values()))), name


@pytest.mark.parametrize("name", CASES)
def test_case_trains_as_the_jax_step(world, jax_ref, name):
    want = jax_ref["runs"][name]
    for r in range(4):
        np.testing.assert_allclose(_run(world, r, name)["losses"], want["losses"],
                                   rtol=ref.F32_LOSS_RTOL)
    ref.assert_params_match(_joined(world, name, lambda w, r: _run(w, r, name)["params"]),
                            want, "float32")


def test_passed_distributed_optimizer_is_the_plain_step(world):
    name = workers.FSDPMOE_PASSED
    for r in range(4):
        plain, passed = _run(world, r, name), _run(world, r, name, "passed")
        assert passed["optimizer"] == plain["optimizer"] == "DistributedOptimizer"
        np.testing.assert_array_equal(passed["losses"], plain["losses"])
        for k, v in plain["params"].items():
            np.testing.assert_array_equal(passed["params"][k], v, err_msg=k)


def test_grouped_reduction_trains_as_the_jax_step(world, jax_ref):
    name = workers.FSDPMOE_GROUPED
    want = jax_ref["runs"][name]
    for r in range(4):
        np.testing.assert_allclose(_run(world, r, name, "grouped")["losses"], want["losses"],
                                   rtol=ref.F32_LOSS_RTOL)
    ref.assert_params_match(
        _joined(world, name, lambda w, r: _run(w, r, name, "grouped")["params"]), want,
        "float32")


def test_bf16_trains_as_the_jax_step(world, jax_ref):
    name = workers.FSDPMOE_BF16
    want = jax_ref["runs"]["bf16"]
    for r in range(4):
        np.testing.assert_allclose(_run(world, r, name, "bf16")["losses"], want["losses"],
                                   **ref.BF16_TOL)
    ref.assert_params_match(_joined(world, name, lambda w, r: _run(w, r, name, "bf16")["params"]),
                            want, "bfloat16")


@pytest.fixture(scope="module")
def world_one_grads(jax_ref):
    """By case: the world-1 model's f32 gradients of ``lm_loss`` plus the
    weighted auxiliary loss on the whole batch."""
    ids = torch.from_numpy(workers.zm_ids())
    out = {}
    for name in CASES:
        cfg = _cfg(name)
        full = TransformerLM(cfg, device="cpu")
        full.load_state_dict(flax_to_torch(
            jax_ref["params"]["float32" if _moe(name) else "dense"], cfg))
        loss = lm_loss(full(ids), ids)
        if _moe(name):
            loss = loss + workers.FSDPMOE_AUX * full.moe_aux_loss()
        loss.backward()
        out[name] = {k: p.grad.numpy() for k, p in full.named_parameters()}
    return out


@pytest.mark.parametrize("name", CASES)
def test_step1_gradients_are_the_world_one_models(world, world_one_grads, name):
    got = _joined(world, name, lambda w, r: _run(w, r, name)["grads"])
    want = world_one_grads[name]
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=k, **GRAD_TOL)
    for r in range(4):   # the reduced gradient is the same on every member of a line of copies
        for k, g in _run(world, r, name)["grads"].items():
            np.testing.assert_array_equal(
                g, _run(world, _mate(world, name, r, k), name)["grads"][k], err_msg=k)


@pytest.mark.parametrize("name", MOE_CASES)
def test_dropped_tokens_and_routes_are_jaxs_at_every_step(world, jax_ref, name):
    want = jax_ref["runs"][name]
    assert want["dropped"].sum() > 0
    B, S = workers.ZM_B, workers.ZM_S
    dp, sp = _shape(name).get("dp", 1), _shape(name).get("sp", 1)
    for r in range(4):
        run = _run(world, r, name)
        np.testing.assert_array_equal(run["dropped"], want["dropped"])
        d, s = run["coords"].get("dp", 0), run["coords"].get("sp", 0)
        for step, (got, routes) in enumerate(zip(run["routes"], want["routes"])):
            assert len(got) == len(routes) == 1
            rows = routes[0].reshape(B, S)[d * B // dp:(d + 1) * B // dp,
                                           s * S // sp:(s + 1) * S // sp]
            np.testing.assert_array_equal(got[0], rows.reshape(-1), err_msg=f"step {step + 1}")
    assert len(_run(world, 0, name)["routes"]) == workers.ZM_STEPS


@pytest.mark.parametrize("name", CASES)
def test_copies_stay_bitwise_after_every_step(world, name):
    """A dp shard's copies across ep and sp, an expert's across sp, and
    the uncut tensors on every rank, bitwise after each step."""
    for step in range(workers.ZM_STEPS):
        for r in range(4):
            got = _run(world, r, name)["by_step"][step]
            for k, v in got.items():
                mate = _run(world, _mate(world, name, r, k), name)["by_step"][step][k]
                np.testing.assert_array_equal(v, mate, err_msg=f"step {step + 1} {k}")


def held_closed_form(cfg, dp: int, ep: int) -> int:
    """The parameters a rank holds under FSDP_RULES on a dp line of ``dp``
    and an ep line of ``ep`` (over sp nothing is cut): per dense block the
    LayerNorms and the row-parallel biases (6 d) and the four kernels (4 d²
    + 2 d·d_ff) over dp, the qkv and wi biases (3 d + d_ff) whole; per
    Switch block the LayerNorms and the out bias (5 d), the attention
    kernels (4 d²), the router (E·d) and the E/ep experts' two kernels (2
    E/ep·d·d_ff) over dp, the qkv bias whole; the token embedding, the
    head, the positions and ln_f over dp."""
    from horovod_tpu_torch.models.transformer import uses_moe

    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    moe = sum(uses_moe(cfg, i) for i in range(cfg.n_layers))
    block = (6 * d + 4 * d * d + 2 * d * f) // dp + 3 * d + f
    switch = (5 * d + 4 * d * d + E * d + 2 * (E // max(ep, 1)) * d * f) // dp + 3 * d
    return ((cfg.n_layers - moe) * block + moe * switch
            + (2 * cfg.vocab_size * d + cfg.max_len * d + 2 * d) // dp)


@pytest.mark.parametrize("name", CASES)
def test_held_bytes_at_the_closed_form(world, name):
    shape = _shape(name)
    held = held_closed_form(_cfg(name), shape["dp"], shape.get("ep", 1))
    for r in range(4):
        run = _run(world, r, name)
        assert sum(v.size for v in run["params"].values()) == held
        assert run["state_bytes"] == 2 * 4 * held     # AdamW's two f32 moments


@pytest.mark.parametrize("name", CASES)
def test_shapes_are_the_jax_shard_shapes(world, jax_ref, name):
    want = jax_ref["runs"][name]["shard_shapes"]
    for r in range(4):
        got = {k: v.shape for k, v in _run(world, r, name)["params"].items()}
        assert got == want


@pytest.mark.parametrize("key", ["init", "loaded"])
def test_init_and_flax_cut_join_to_the_world_one_model(world, jax_ref, key):
    """Torch seed 0's initialisation and ``flax_to_torch(..., ep=, ep_rank=,
    dp=, dp_rank=)`` on {"dp": 2, "ep": 2}: the shards join to the world-1
    model bitwise."""
    cfg = _cfg("dp2_ep2")
    want = (TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            .state_dict() if key == "init"
            else flax_to_torch(jax_ref["params"]["float32"], cfg))
    got = _joined(world, "dp2_ep2", lambda w, r: w[r][key])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("ep,dp", [(2, 2), (1, 4), (4, 2)])
def test_convert_ep_dp_cut_joins_back(jax_ref, ep, dp):
    params = jax_ref["params"]["float32"]
    cfg = _cfg("dp2_ep2")
    full = flax_to_torch(params, cfg)
    shards = [[flax_to_torch(params, cfg, ep=ep, ep_rank=e, dp=dp, dp_rank=d)
               for d in range(dp)] for e in range(ep)]
    E, D = workers.FSDPMOE_E, cfg.d_model
    for e in range(ep):
        for d in range(dp):
            got = shards[e][d]
            assert got["stack.layers.1.moe.router.weight"].shape == (E, D // dp)
            assert got["stack.layers.1.moe.wi"].shape == (E // ep, D // dp, cfg.d_ff)
            assert got["stack.layers.1.moe.wo"].shape == (E // ep, cfg.d_ff, D // dp)
    joined = ep_join([fsdp_join(by_dp) for by_dp in shards])
    assert sorted(joined) == sorted(full)
    for k, v in full.items():
        assert torch.equal(joined[k], v), k


@pytest.mark.parametrize("line", ["ep", "dp_ep"])
def test_an_optimizer_off_the_cut_line_refuses_the_cut_experts(world, line):
    """Over ep the optimizer does not hold the cut's dp line; over ("dp",
    "ep") it would sum each expert with the other ep ranks' experts."""
    for r in world:
        msg = r["off_line"][line]
        assert msg.startswith("ValueError") and "axis_name" in msg, msg
