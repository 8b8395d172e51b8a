"""pp under sp and ep in the port: ``PipelinedLM``'s stages attending over
the rank's sp line (``models/pipelined.py``, ``parallel/pipeline.py``,
``parallel/ring.py``, ``parallel/ulysses.py``, the gathered dense and flash
attention), the positions of a sequence block, the sequence-sharded
``lm_loss`` of ``make_train_step`` on every rank of a pp line, and
``models/convert.py``'s stage cut on every sp rank, against the JAX
``PipelinedLM`` on CPU meshes {"pp": 2, "sp": 2}, {"pp": 2, "dp": 2, "sp":
2} and {"pp": 2, "ep": 2}, on spawned gloo ranks.

The model is the reference test's (vocab 128, d_model 32, 4 heads, 4
layers, d_ff 64, scan-stacked, ``tests/test_parallel.py:135-172``), its
batch ``plm_ids()`` (8 x 16), 4 microbatches.

* On pp=2 x sp=2 (four ranks, rank 2·p + s), each stage loaded from the
  JAX ``TransformerLM``'s weights (``flax_to_torch(..., stages=, stage=)``,
  the same on both sp ranks of a stage): (a) every rank's logits are its
  sequence block of the JAX ``PipelinedLM``'s on {"pp": 2, "sp": 2} with
  dense, ring, Ulysses and Ulysses through flash attention (the port's
  plain flash version, the JAX kernel in interpret mode), at 1e-5 in f32
  and rtol 5e-2, atol 2e-2 in bf16 (tests/test_torch_port_pp_tp.py's
  ``TOL``); the gathered flash route against the JAX dense logits, since
  the JAX flash route raises inside the pipeline (ROADMAP C); (b) in f32,
  for every route, the stages' gradients of the sequence-sharded loss,
  averaged over each stage's sp line and joined over the stages, equal the
  world-1 ``TransformerLM``'s at rtol 1e-5, atol 1e-7; (c) 4 Adam steps
  through ``make_train_step`` in f32 with dense attention give the JAX
  ``make_train_step(plm, optax.adam(1e-3), lm_loss, rules=PIPELINE_RULES,
  shard_seq=True)``'s losses on {"pp": 2, "sp": 2} within 1e-5, with every
  line of copies bitwise; (d) the gathered flash, ring, Ulysses and
  Ulysses-flash routes give (c)'s losses within 1e-5 (the JAX train step
  raises for each of them on this mesh, ROADMAP C); (e) remat is
  bitwise no remat (ring and Ulysses-flash, f32 and bf16); (f) ``train_gpt2
  --pp 2 --sp 2 --attn ulysses --sp-use-flash --remat`` trains; the ranks'
  weights from torch seed 0, joined over stages, are bitwise
  ``TransformerLM``'s on every sp rank.
* (h) On pp=2 x ep=2 (the same world) a dense ``PipelinedLM``, replicated
  over ep, trains to the JAX losses on {"pp": 2, "ep": 2}.
* (g) On pp=2 x dp=2 x sp=2 (eight ranks, one test): the JAX losses on that
  mesh, every line of copies bitwise, the dp replicas among them.

Under xdist the JAX reference and the four-rank world are computed once
per session and shared by the workers through a file
(``_torch_port_jax.shared``).
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
from horovod_tpu.parallel.sharding import PIPELINE_RULES as JAX_PIPELINE_RULES
from horovod_tpu.parallel.train import lm_loss as jax_lm_loss
from horovod_tpu.parallel.train import make_train_step as jax_make_train_step
from horovod_tpu.utils.compat import set_mesh

import _torch_port_workers as workers
from _torch_port_jax import mesh as jax_mesh
from _torch_port_jax import shared
from horovod_tpu_torch.models.convert import flax_to_torch
from horovod_tpu_torch.models.transformer import TransformerLM
from horovod_tpu_torch.parallel.pipeline import stage_layers
from horovod_tpu_torch.parallel.train import lm_loss

PLM_CFG = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_len=64,
               scan_layers=True)
TOL = {"bf16": dict(rtol=5e-2, atol=2e-2), "f32": dict(rtol=1e-5, atol=1e-5)}
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_RTOL = 1e-5
# The route whose JAX logits each port route is held against: the JAX
# flash route raises inside the pipeline, so gathered flash takes dense's.
JAX_ROUTE = {"dense": "dense", "flash": "dense", "ring": "ring", "ulysses": "ulysses",
             "ulysses_flash": "ulysses_flash"}
TRAIN_MESHES = {"pp_sp": workers.PPSP_MESH, "pp_dp_sp": workers.PPDPSP_MESH,
                "pp_ep": workers.PPEP_MESH}


def _jax_cfg(attn: str, dtype) -> JaxConfig:
    over = workers.ppsp_overrides(attn)
    return JaxConfig(**PLM_CFG, dtype=dtype, attn_impl=over["attn_impl"],
                     sp_use_flash=over.get("sp_use_flash", False))


def _jax_reference() -> dict:
    """The JAX PipelinedLM: its logits on {"pp": 2, "sp": 2} in bf16 and
    f32 by route from TransformerLM's init (PRNGKey 0), and PLM_STEPS steps
    of its make_train_step in f32 with dense attention on each of
    TRAIN_MESHES (the losses, and the step's initial weights)."""
    ids = workers.plm_ids()
    params = jax.tree.map(np.asarray, nn.unbox(JaxLM(JaxConfig(**PLM_CFG)).init(
        jax.random.PRNGKey(0), ids))["params"])
    mesh = jax_mesh(workers.PPSP_MESH)
    out = {"params": params, "logits": {}, "losses": {}}
    for attn in sorted(set(JAX_ROUTE.values())):
        for name, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
            model = JaxPipelinedLM(_jax_cfg(attn, dtype), mesh, num_microbatches=workers.PLM_M)
            with set_mesh(mesh):
                out["logits"][f"{attn}-{name}"] = np.asarray(
                    jax.jit(lambda p, i: model.apply({"params": p}, i))(params, ids),
                    dtype=np.float32)
    for key, shape in TRAIN_MESHES.items():
        tmesh = jax_mesh(shape)
        plm = JaxPipelinedLM(JaxConfig(**PLM_CFG, dtype=jnp.float32), tmesh,
                             num_microbatches=workers.PLM_M)
        build = jax_make_train_step(plm, optax.adam(workers.PLM_LR), jax_lm_loss, mesh=tmesh,
                                    rules=JAX_PIPELINE_RULES, shard_seq=True)
        init_fn, step_fn, _ = build(jax.random.PRNGKey(0), ids)
        state = init_fn(jax.random.PRNGKey(0))
        start = jax.tree.map(np.asarray, state.params)
        out.setdefault("train_params", start)
        jax.tree.map(np.testing.assert_array_equal, start, out["train_params"])
        losses = []
        for _ in range(workers.PLM_STEPS):
            state, loss = step_fn(state, ids)
            losses.append(float(loss))
        out["losses"][key] = np.array(losses)
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared(tmp_path_factory, "pp_sp_jax", _jax_reference)


@pytest.fixture(scope="module")
def pp_sp(tmp_path_factory, jax_ref):
    return shared(tmp_path_factory, "pp_sp_world4", lambda: workers.spawn_world(
        4, tmp_path_factory.mktemp("pp_sp"), "_run_pp_sp_world", jax_ref["params"],
        jax_ref["train_params"]))


def _block(a: np.ndarray, coords: dict) -> np.ndarray:
    """The sequence block (dim 1) of sp index ``coords["sp"]``."""
    S = a.shape[1] // 2
    return a[:, coords["sp"] * S:(coords["sp"] + 1) * S]


def _is_block(key: str) -> bool:
    return key.startswith("stack.")


def _joined(ranks, get, cfg) -> dict:
    """The full model's tensors from each stage's (``get(rank)``, already
    the same on its sp line, or averaged over it by the caller): a stage
    holds its own blocks, and the tensors every stage holds agree bitwise."""
    full = {}
    for stage in range(2):
        part = get(stage)
        blocks = {int(k.split(".")[2]) for k in part if _is_block(k)}
        assert blocks == set(stage_layers(cfg.n_layers, 2, stage))
        for k, v in part.items():
            if k in full:
                np.testing.assert_array_equal(full[k], v, err_msg=k)
            full[k] = v
    return full


def _stage(ranks, stage: int):
    return [r for r in ranks if r["coords"]["pp"] == stage]


def _assert_lines_of_copies_bitwise(ranks, key: str) -> None:
    """Every tensor bitwise on its line of copies: a block's on the ranks
    of its stage, the rest on every rank."""
    for res in ranks:
        for k, v in res[key].items():
            for other in ranks:
                if _is_block(k) and other["coords"]["pp"] != res["coords"]["pp"]:
                    continue
                np.testing.assert_array_equal(v, other[key][k], err_msg=k)


def _assert_trains(ranks, want) -> None:
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(res["losses"], ranks[0]["losses"])
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    _assert_lines_of_copies_bitwise(ranks, "params")


def test_world_coordinates(pp_sp):
    assert [(r["coords"]["pp"], r["coords"]["sp"]) for r in pp_sp] == [
        (p, s) for p in range(2) for s in range(2)]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("attn", workers.PPSP_ATTNS)
def test_logits_are_the_jax_pipelined_lm_blocks(pp_sp, jax_ref, attn, dtype):
    want = jax_ref["logits"][f"{JAX_ROUTE[attn]}-{dtype}"]
    for res in pp_sp:
        got = res["logits"][f"{attn}-{dtype}"]
        assert got.shape == (want.shape[0], want.shape[1] // 2, want.shape[2])
        np.testing.assert_allclose(got, _block(want, res["coords"]), **TOL[dtype])


@pytest.fixture(scope="module")
def world_one(jax_ref):
    """The world-1 TransformerLM in f32: its lm_loss and gradients."""
    cfg = workers.plm_config(torch)
    full = TransformerLM(cfg, device="cpu")
    full.load_state_dict(flax_to_torch(jax_ref["params"], cfg))
    ids = torch.from_numpy(workers.plm_ids())
    loss = lm_loss(full(ids), ids)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in full.named_parameters()}


@pytest.mark.parametrize("attn", workers.PPSP_ATTNS)
def test_gradients_equal_world_one(pp_sp, world_one, attn):
    loss, want = world_one
    for stage in range(2):
        shares = [r["loss"][attn] for r in _stage(pp_sp, stage)]
        np.testing.assert_allclose(np.mean(shares), loss, rtol=LOSS_RTOL)

    def averaged(stage):
        ranks = _stage(pp_sp, stage)
        return {k: np.mean([r["grads"][attn][k] for r in ranks], axis=0)
                for k in ranks[0]["grads"][attn]}

    got = _joined(pp_sp, averaged, workers.plm_config(torch))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], err_msg=k, **GRAD_TOL)


def test_convert_loads_a_stage_on_every_sp_rank(pp_sp, jax_ref):
    cfg = workers.plm_config(torch)
    for res in pp_sp:
        want = flax_to_torch(jax_ref["params"], cfg, stages=2, stage=res["coords"]["pp"])
        assert sorted(res["loaded"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(res["loaded"][k], v.numpy(), err_msg=k)


def test_init_holds_the_world_one_weights_on_every_sp_rank(pp_sp):
    cfg = workers.plm_config(torch)
    _assert_lines_of_copies_bitwise(pp_sp, "init")
    got = _joined(pp_sp, lambda stage: _stage(pp_sp, stage)[0]["init"], cfg)
    want = TransformerLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0)).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_training_matches_jax_and_keeps_copies_bitwise(pp_sp, jax_ref):
    _assert_trains([r["train"]["dense"] for r in pp_sp], jax_ref["losses"]["pp_sp"])


@pytest.mark.parametrize("attn", [a for a in workers.PPSP_ATTNS if a != "dense"])
def test_every_route_trains_to_the_dense_losses(pp_sp, attn):
    _assert_trains([r["train"][attn] for r in pp_sp], pp_sp[0]["train"]["dense"]["losses"])


@pytest.mark.parametrize("case", [f"{a}-{d}" for a, d in workers.PPSP_REMAT])
def test_remat_is_bitwise_no_remat(pp_sp, case):
    for res in pp_sp:
        got = res["remat"][case]
        assert got["loss_bitwise"] and not got["differ"], got


def test_dense_pipeline_on_pp_ep_trains_as_jax(pp_sp, jax_ref):
    ranks = [r["train_ep"] for r in pp_sp]
    assert [(r["coords"]["pp"], r["coords"]["ep"]) for r in ranks] == [
        (p, e) for p in range(2) for e in range(2)]
    _assert_trains(ranks, jax_ref["losses"]["pp_ep"])


def test_train_gpt2_pp_sp_ulysses_flash_on_four_ranks(pp_sp):
    for res in pp_sp:
        assert len(res["train_gpt2"]) == 2 and np.all(np.isfinite(res["train_gpt2"]))
        np.testing.assert_array_equal(res["train_gpt2"], pp_sp[0]["train_gpt2"])


def test_pp_dp_sp_world_trains_as_jax_with_bitwise_replicas(tmp_path, pp_sp, jax_ref):
    ranks = workers.spawn_world(8, tmp_path, "_run_pp_dp_sp_world", jax_ref["train_params"])
    assert [tuple(r["coords"][a] for a in ("pp", "dp", "sp")) for r in ranks] == [
        (p, d, s) for p in range(2) for d in range(2) for s in range(2)]
    _assert_trains(ranks, jax_ref["losses"]["pp_dp_sp"])
    for res in ranks:
        np.testing.assert_allclose(res["losses"], pp_sp[0]["train"]["dense"]["losses"],
                                   rtol=LOSS_RTOL)
