"""FSDP under sp in the port: ``FSDP_RULES`` on a mesh {"dp": 2, "sp": 2}
(``parallel/fsdp.py``, the cut gradients' sum over the sp line in
``optim/distributed.py``, ``make_train_step(rules=FSDP_RULES,
shard_seq=True)``, ``models/convert.py``'s dp cut on every sp member)
against the JAX ``make_train_step(rules=FSDP_RULES, shard_seq=True)`` on
four CPU devices, on four spawned gloo ranks (rank 2·d + s = (dp d, sp s)).

The model is tests/test_torch_port_fsdp.py's (``workers.zm_config``:
vocab 128, d_model 32, 4 heads, d_ff 64, 2 layers, B=4, S=16), weights drawn
with numpy, each rank loading its dp cut, 3 AdamW steps:

* every sp route (dense and flash gathered over sp, the ring, Ulysses,
  Ulysses through flash: the port's plain flash version, the JAX kernel in
  interpret mode) in f32: the losses within 1e-5 of JAX's and the
  parameters, joined over dp by ``fsdp_join``, at ``F32_PARAM_TOL``; the
  same model under a ``DistributedOptimizer(axis_name=("dp", "sp"))``
  passed in, bitwise the plain optimizer's run; the ring on the grouped
  after-backward reduction; Ulysses-flash in bf16 at ``BF16_TOL``;
* the step-1 gradients the optimizer hands AdamW, joined over dp, against
  the world-1 model's at rtol 1e-5, atol 1e-7;
* after every step the two sp members of each dp index hold bitwise the
  same shard, and the tensors without a d_model dimension are bitwise on
  every rank; each rank's parameters and AdamW moments at their closed form
  (the cut ones over dp, none over sp);
* the initialisation from torch seed 0 and ``flax_to_torch(..., dp=,
  dp_rank=)`` give every sp member its dp index's shard, and the shards
  join to the world-1 model bitwise; an optimizer over the sp line alone,
  which does not hold the cut's dp line, refuses the cut parameters.

Under xdist the JAX references and the world are computed once per session
and shared through a file (``_torch_port_jax.shared``).
"""
import numpy as np
import pytest
import torch

from horovod_tpu.parallel.sharding import FSDP_RULES as JAX_FSDP

import _torch_port_jax as ref
import _torch_port_workers as workers
from horovod_tpu_torch.models.convert import flax_to_torch, fsdp_join
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.parallel.fsdp import FSDP_PARAMS
from horovod_tpu_torch.parallel.train import lm_loss

ATTNS = workers.FSDPSP_ATTNS
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def _jax_reference() -> dict:
    params = {"float32": ref.numpy_params(seed=0), "bfloat16": ref.numpy_params(seed=1)}
    runs = {attn: ref.train(workers.FSDPSP_MESH, params["float32"], rules=JAX_FSDP,
                            shard_seq=True, **workers.ppsp_overrides(attn))
            for attn in ATTNS}
    runs["bf16"] = ref.train(workers.FSDPSP_MESH, params["bfloat16"], "bfloat16",
                             rules=JAX_FSDP, shard_seq=True,
                             **workers.ppsp_overrides(workers.FSDPSP_BF16))
    for run in runs.values():
        run.pop("shardings")
    return {"params": params, "runs": runs}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return ref.shared(tmp_path_factory, "fsdp_sp_jax", _jax_reference)


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_ref):
    p = jax_ref["params"]
    return ref.shared(tmp_path_factory, "fsdp_sp_world4", lambda: workers.spawn_world(
        4, tmp_path_factory.mktemp("fsdp_sp"), "_run_fsdp_sp_world", p["float32"],
        p["bfloat16"]))


def _dp_line(world) -> list:
    """The ranks of sp index 0, in dp order."""
    return [r for r in world if r["coords"]["sp"] == 0]


def _joined(world, get) -> dict:
    """The full model from ``get(rank)`` (a state_dict of numpy arrays) on
    the ranks of sp index 0, joined over dp."""
    return fsdp_join([{k: torch.from_numpy(v) for k, v in get(r).items()}
                      for r in _dp_line(world)])


def _cut(name: str) -> bool:
    return name.endswith(tuple(FSDP_PARAMS))


def test_world_coordinates(world):
    assert [(r["coords"]["dp"], r["coords"]["sp"]) for r in world] == [
        (d, s) for d in range(2) for s in range(2)]


@pytest.mark.parametrize("attn", ATTNS)
def test_route_trains_as_the_jax_step(world, jax_ref, attn):
    want = jax_ref["runs"][attn]
    for r in world:
        np.testing.assert_allclose(r["runs"][attn]["losses"], want["losses"],
                                   rtol=ref.F32_LOSS_RTOL)
    ref.assert_params_match(_joined(world, lambda r: r["runs"][attn]["params"]), want,
                            "float32")


@pytest.mark.parametrize("attn", ATTNS)
def test_passed_distributed_optimizer_is_the_plain_step(world, attn):
    for r in world:
        plain, passed = r["runs"][attn], r["runs"][f"{attn}_passed"]
        assert passed["optimizer"] == plain["optimizer"] == "DistributedOptimizer"
        np.testing.assert_array_equal(passed["losses"], plain["losses"])
        for k, v in plain["params"].items():
            np.testing.assert_array_equal(passed["params"][k], v, err_msg=k)


def test_grouped_reduction_trains_as_the_jax_step(world, jax_ref):
    attn = workers.FSDPSP_GROUPED
    want = jax_ref["runs"][attn]
    for r in world:
        np.testing.assert_allclose(r["runs"][f"{attn}_grouped"]["losses"], want["losses"],
                                   rtol=ref.F32_LOSS_RTOL)
    ref.assert_params_match(_joined(world, lambda r: r["runs"][f"{attn}_grouped"]["params"]),
                            want, "float32")


def test_bf16_route_trains_as_the_jax_step(world, jax_ref):
    want = jax_ref["runs"]["bf16"]
    name = f"{workers.FSDPSP_BF16}_bf16"
    for r in world:
        np.testing.assert_allclose(r["runs"][name]["losses"], want["losses"], **ref.BF16_TOL)
    ref.assert_params_match(_joined(world, lambda r: r["runs"][name]["params"]), want,
                            "bfloat16")


@pytest.fixture(scope="module")
def world_one_grads(jax_ref):
    """The world-1 model's f32 gradients of lm_loss on the whole batch."""
    cfg = workers.zm_config(torch)
    full = TransformerLM(cfg, device="cpu")
    full.load_state_dict(flax_to_torch(jax_ref["params"]["float32"], cfg))
    ids = torch.from_numpy(workers.zm_ids())
    lm_loss(full(ids), ids).backward()
    return {k: p.grad.numpy() for k, p in full.named_parameters()}


@pytest.mark.parametrize("attn", ATTNS)
def test_step1_gradients_are_the_world_one_models(world, world_one_grads, attn):
    got = _joined(world, lambda r: r["runs"][attn]["grads"])
    assert sorted(got) == sorted(world_one_grads)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), world_one_grads[k], err_msg=k, **GRAD_TOL)
    for r in world:   # the reduced gradient is the same on every member of a line of copies
        mate = world[2 * r["coords"]["dp"]]
        for k, g in r["runs"][attn]["grads"].items():
            np.testing.assert_array_equal(g, mate["runs"][attn]["grads"][k], err_msg=k)


@pytest.mark.parametrize("attn", ATTNS)
def test_copies_stay_bitwise_after_every_step(world, attn):
    """The sp members of a dp index hold the same shard, and the tensors
    without a d_model dimension are the same on every rank, after each
    step."""
    for step in range(workers.ZM_STEPS):
        for r in world:
            got = r["runs"][attn]["by_step"][step]
            for k, v in got.items():
                mate = world[2 * r["coords"]["dp"]] if _cut(k) else world[0]
                np.testing.assert_array_equal(v, mate["runs"][attn]["by_step"][step][k],
                                              err_msg=f"step {step + 1} {k}")


def held_closed_form(cfg, dp: int) -> int:
    """The parameters a rank holds under FSDP_RULES on a dp line of ``dp``
    (over sp nothing is cut): per block the LayerNorms and the row-parallel
    biases (6 d) and the four kernels (4 d² + 2 d·d_ff) over dp, the qkv
    and wi biases (3 d + d_ff) whole; the token embedding, the head, the
    positions and ln_f over dp."""
    d, f = cfg.d_model, cfg.d_ff
    block = (6 * d + 4 * d * d + 2 * d * f) // dp + 3 * d + f
    return cfg.n_layers * block + (2 * cfg.vocab_size * d + cfg.max_len * d + 2 * d) // dp


@pytest.mark.parametrize("attn", ATTNS)
def test_held_bytes_at_the_closed_form(world, attn):
    held = held_closed_form(workers.zm_config(torch), workers.FSDPSP_MESH["dp"])
    for r in world:
        run = r["runs"][attn]
        assert sum(v.size for v in run["params"].values()) == held
        assert run["state_bytes"] == 2 * 4 * held     # AdamW's two f32 moments


@pytest.mark.parametrize("key", ["init", "loaded"])
def test_every_sp_member_holds_its_dp_shard(world, jax_ref, key):
    """Torch seed 0's initialisation and ``flax_to_torch(..., dp=,
    dp_rank=)``: the sp members of a dp index hold bitwise the same shard,
    and the shards join to the world-1 model bitwise."""
    for r in world:
        mate = world[2 * r["coords"]["dp"]]
        for k, v in r[key].items():
            np.testing.assert_array_equal(v, mate[key][k], err_msg=k)
    cfg = workers.zm_config(torch)
    want = (TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            .state_dict() if key == "init"
            else flax_to_torch(jax_ref["params"]["float32"], cfg))
    got = _joined(world, lambda r: r[key])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_an_optimizer_off_the_cut_line_refuses_the_cut_parameters(world):
    for r in world:
        assert r["off_line"].startswith("ValueError") and "axis_name" in r["off_line"], \
            r["off_line"]
