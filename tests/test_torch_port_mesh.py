"""The port's mesh (``parallel/mesh.py``) and ``wrap_step``
(``parallel/step.py``).

* Coordinates and lines of ``{"dp": 2, "ep": 2, "sp": 2}`` (and of a
  ``{"dp": 2, "sp": 4}`` mesh with -1 filling) against the JAX mesh built
  from ``np.asarray(jax.devices()[:8]).reshape(shape)``: port rank i must
  hold the coordinates of JAX device i, and its line along each axis and
  pair of axes the devices that differ from it only there, in mesh order.
  Pure functions, no world needed.
* ``-1`` filling and the errors: sizes that do not cover or divide the
  world, two -1s, tp above 1 (``NotImplementedError`` naming the ROADMAP
  item), an axis that is not in the mesh; pp builds (its case once held
  that pp raised, and keeps that case's id).
* On 2 gloo ranks, the counterparts of tests/test_parallel.py:174-232: a
  gradient taken inside ``wrap_step`` and averaged by ``hvd.allreduce`` is
  the global-batch gradient (not the cross-rank sum), and linear regression
  through ``wrap_step`` + ``DistributedOptimizer(SGD(0.3))`` converges to
  a loss under 1e-3 in 30 steps; ``out_replicated=False`` concatenates the
  ranks' outputs in rank order.
"""
import itertools

import jax
import numpy as np
import pytest

import _torch_port_workers as workers
import horovod_tpu_torch as hvd
from horovod_tpu.parallel.mesh import _factor_devices as jax_factor
from horovod_tpu_torch.parallel import mesh as port_mesh


def _jax_layout(shape: dict):
    return np.asarray([d.id for d in jax.devices()[:8]]).reshape(tuple(shape.values()))


@pytest.mark.parametrize("sizes", [{"dp": 2, "ep": 2, "sp": 2}, {"sp": 4, "dp": -1}])
def test_coordinates_and_lines_match_the_jax_layout(sizes):
    shape = port_mesh._factor_devices(8, sizes)
    assert shape == jax_factor(8, dict(sizes))
    names = port_mesh.axis_names_in_order(shape)
    shape = {a: shape[a] for a in names}
    ids = _jax_layout(shape)
    ids_to_rank = {d.id: i for i, d in enumerate(jax.devices()[:8])}
    for rank in range(8):
        coords = port_mesh.coords_of(rank, names, shape)
        pos = tuple(int(i) for i in np.argwhere(ids == jax.devices()[rank].id)[0])
        assert tuple(coords[a] for a in names) == pos
        assert port_mesh.rank_of(coords, names, shape) == rank
        for k in (1, 2):
            for axes in itertools.combinations(names, k):
                index = tuple(slice(None) if a in axes else pos[i]
                              for i, a in enumerate(names))
                want = [ids_to_rank[int(i)] for i in ids[index].reshape(-1)]
                assert list(port_mesh.line_ranks(rank, axes, names, shape)) == want


def test_axis_order_and_hybrid_merge_follow_jax():
    from horovod_tpu.parallel.mesh import AXIS_ORDER

    assert port_mesh.AXIS_ORDER == AXIS_ORDER
    assert port_mesh.axis_names_in_order(["sp", "hvd", "dp", "ep"]) == ("dp", "ep", "sp", "hvd")


@pytest.fixture
def cpu_world():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("sizes", [{"dp": 2}, {"dp": 2, "sp": 2}, {"dp": 3, "sp": -1},
                                   {"dp": -1, "sp": -1}, {"ep": 4, "sp": -1}])
def test_factoring_errors_match_jax(sizes):
    """The same sizes fail with the same message in both packages (8 ranks)."""
    try:
        jax_factor(8, dict(sizes))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("} ")[-1]):
            port_mesh._factor_devices(8, dict(sizes))
    else:
        assert port_mesh._factor_devices(8, dict(sizes)) == jax_factor(8, dict(sizes))


@pytest.mark.parametrize("sizes,exc,match", [
    ({"dp": 2}, ValueError, "do not divide"),
    ({"dp": -1, "sp": -1}, ValueError, "at most one"),
    # tp and pp are ported: on this world of one, each fills to 1 and
    # builds; size 2 meets the factoring like any axis.
    pytest.param({"dp": 1, "tp": -1}, None, None,
                 id="sizes2-NotImplementedError-tp=2.*ROADMAP A7"),
    pytest.param({"pp": -1, "dp": 1}, None, None,
                 id="sizes3-NotImplementedError-pp=2.*ROADMAP A7"),
])
def test_mesh_errors(cpu_world, sizes, exc, match):
    if exc is None:     # tp or pp builds
        axis = next(a for a in sizes if sizes[a] == -1)
        mesh = hvd.create_mesh(sizes)
        assert mesh.axis_names == port_mesh.axis_names_in_order(sizes)
        assert mesh.shape == {a: 1 for a in sizes}
        assert mesh.comm(axis).ranks == (0,) and port_mesh.current_mesh() is mesh
        with pytest.raises(ValueError, match="do not divide"):
            hvd.create_mesh({**sizes, axis: 2, next(a for a in sizes if a != axis): -1})
        return
    with pytest.raises(exc, match=match):
        hvd.create_mesh(sizes)


def test_fill_and_one_rank_lines(cpu_world):
    mesh = hvd.create_mesh({"dp": -1, "ep": 1, "sp": 1})
    assert mesh.shape == {"dp": 1, "ep": 1, "sp": 1} and mesh.axis_names == ("dp", "ep", "sp")
    assert mesh.comm(("dp", "sp")).ranks == (0,) and mesh.group("ep") is None
    assert port_mesh.current_mesh() is mesh
    with pytest.raises(ValueError, match="axis_name.*'tp' is not in the mesh"):
        mesh.comm("tp")
    merged = hvd.create_hybrid_mesh({"sp": 1}, {"dp": 1})
    assert merged.axis_names == ("dp", "sp")


@pytest.fixture(scope="module")
def wrap_ranks(tmp_path_factory):
    return workers.spawn_world(2, tmp_path_factory.mktemp("wrap"), "_run_wrap_step")


def test_wrap_step_grad_semantics(wrap_ranks):
    X = np.arange(32, dtype=np.float32)
    true_avg = X.mean()
    for rank, res in enumerate(wrap_ranks):
        np.testing.assert_allclose(res["grad"], [true_avg], rtol=1e-6)
        np.testing.assert_allclose(res["local_grad"], [X[rank * 16:(rank + 1) * 16].mean()],
                                   rtol=1e-6)


def test_wrap_step_distributed_optimizer_converges(wrap_ranks):
    x, y = workers.wrap_data()
    for res in wrap_ranks:
        assert float(np.mean((x @ res["w"] - y) ** 2)) < 1e-3
    np.testing.assert_array_equal(wrap_ranks[0]["w"], wrap_ranks[1]["w"])


def test_wrap_step_out_sharded_gathers_in_rank_order(wrap_ranks):
    x, _ = workers.wrap_data()
    for res in wrap_ranks:
        np.testing.assert_array_equal(res["gathered"], x * 2)


def test_train_gpt2_entry_point_on_the_cpu(capsys):
    from horovod_tpu_torch import train_gpt2

    hvd.shutdown()
    losses = train_gpt2.main(["--model", "gpt2-tiny", "--batch-size", "2", "--seq-len", "32",
                              "--steps", "2", "--n-experts", "2", "--attn", "ulysses",
                              "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert capsys.readouterr().out.count("tokens/sec") == 2
    assert not hvd.is_initialized()
    # tp and pp are ported: --tp 2 and --pp 2 need two ranks
    # (tests/test_torch_port_tp.py and tests/test_torch_port_pipeline.py
    # train on them), and one rank meets the mesh's factoring.
    with pytest.raises(ValueError, match="do not divide"):
        train_gpt2.main(["--model", "gpt2-tiny", "--tp", "2", "--device", "cpu"])
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="do not divide"):
        train_gpt2.main(["--model", "gpt2-tiny", "--pp", "2", "--device", "cpu"])
    assert not hvd.is_initialized()
    losses = train_gpt2.main(["--model", "gpt2-tiny", "--batch-size", "2", "--seq-len", "32",
                              "--steps", "2", "--remat", "--attn", "flash", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
