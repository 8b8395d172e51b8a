"""The port's collective surface on 2 and 3 gloo ranks against the JAX
package.

The port's ranks are spawned processes (tests/_torch_port_workers.py) that
meet through a FileStore in the test's tmp directory. The JAX package's
results come from two references on the same numpy inputs:

* its eager process-mode path (``horovod_tpu.ops`` and
  ``horovod_tpu.common.functions`` over the engine), run in-process as
  tests/test_engine.py runs it, one thread per rank over ``ThreadedGroup``,
  with ``basics``' rank, size, mode and engine answered per thread: ragged
  allgather (f32, uint8, bool), uneven alltoall and its ``recv_splits``,
  broadcast from each root, ``broadcast_object``, ``allgather_object`` and
  reducescatter with a row past ``size * per``;
* ``horovod_tpu.ops.traced`` in ``shard_map`` on a CPU mesh of as many
  devices: even allgather, and reducescatter under SUM, AVERAGE (its
  psum_scatter) and MIN, MAX (its all-reduce, sliced by axis index, the
  JAX eager path's way), and PRODUCT (its all-gather and product) through
  the all-reduce with and without pre- and postscale, the async form, the
  grouped all-reduce and ``DistributedOptimizer``.

Tolerances: data movement exact; reductions 1e-6 (f32).
"""
import multiprocessing as mp
import threading

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu.common.basics as jax_basics
import horovod_tpu.common.functions as jax_functions
import horovod_tpu.ops as jax_ops
from horovod_tpu.backend.threaded import ThreadedGroup
from horovod_tpu.common.types import ReduceOp
from horovod_tpu.engine.engine import Engine
from horovod_tpu.ops import traced
from horovod_tpu.utils.compat import axis_index, shard_map

import _torch_port_workers as workers

SIZES = [2, 3]
TOL = 1e-6
PRODUCT_KEYS = (*workers.PRODUCT_SCALES, "prod_async", "prod_grouped_0",
                "prod_grouped_1", "prod_opt")
AG_KEYS = ["ag_f32", "ag_u8", "ag_bool"]


def _spawn_port(size: int, tmp_dir) -> list:
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_file = str(tmp_dir / "store")
    procs = [ctx.Process(target=workers.collectives_worker,
                         args=(r, size, init_file, queue)) for r in range(size)]
    for p in procs:
        p.start()
    results = dict(queue.get(timeout=180) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    for r, res in results.items():
        assert isinstance(res, dict), f"rank {r} failed:\n{res}"
    return [results[r] for r in range(size)]


def _jax_rank(r: int, size: int) -> dict:
    """One rank's calls into the JAX package's eager process-mode path."""
    inp = workers.collective_inputs(r, size)
    out = {key: np.asarray(jax_ops.allgather(inp[key], name=key)) for key in AG_KEYS}
    out["a2a"], out["a2a_splits"] = jax_ops.alltoall(inp["a2a"], [r + 1] * size,
                                                     name="a2a")
    out["a2a_even"], out["a2a_even_splits"] = jax_ops.alltoall(inp["a2a_even"],
                                                               name="a2a_even")
    for root in range(size):
        out[f"bcast_{root}"] = jax_ops.broadcast(inp["bcast"], root, name=f"b{root}")
        out[f"object_{root}"] = jax_functions.broadcast_object(
            workers.collective_object(r) if r == root else None, root, name=f"o{root}")
    out["allgather_object"] = jax_functions.allgather_object(workers.collective_object(r))
    for op in ("SUM", "MIN", "MAX"):
        out[f"rs_{op}"] = np.asarray(jax_ops.reducescatter(inp["rs"], op=ReduceOp[op],
                                                           name=f"rs_{op}"))
    return out


def _jax_engine(size: int) -> list:
    """``_jax_rank`` on ``size`` engines over one ThreadedGroup, each thread
    seeing its own rank and engine through ``horovod_tpu.common.basics``."""
    group = ThreadedGroup(size)
    engines = [Engine(rank=r, size=size, backend=group.backend(r)) for r in range(size)]
    for e in engines:
        e.cycle_time_s = 0.001
        e.start()
    local = threading.local()
    results, errors = [None] * size, [None] * size

    def body(r):
        local.rank = r
        try:
            results[r] = _jax_rank(r, size)
        except BaseException as ex:  # noqa: BLE001 - re-raised below
            errors[r] = ex

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_basics, "rank", lambda: local.rank)
        patch.setattr(jax_basics, "size", lambda: size)
        patch.setattr(jax_basics, "mode", lambda: "process")
        patch.setattr(jax_basics, "engine", lambda: engines[local.rank])
        threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    stops = [threading.Thread(target=e.shutdown) for e in engines]
    for t in stops:
        t.start()
    for t in stops:
        t.join(timeout=60)
    for err in errors:
        if err is not None:
            raise err
    return results


def _jax_traced(size: int) -> list:
    """Even allgather and reducescatter of each rank's "even" input in
    shard_map over a mesh of ``size`` CPU devices; one dict per rank."""
    mesh = Mesh(np.array(jax.devices()[:size]), ("hvd",))
    x = np.concatenate([workers.collective_inputs(r, size)["even"] for r in range(size)])

    def body(xs):
        per = xs.shape[0] // size
        outs = {"even": traced.allgather(xs, "hvd")}
        for op in ("SUM", "AVERAGE"):
            outs[f"even_rs_{op}"] = traced.reducescatter(xs, "hvd", ReduceOp[op])
        for op in ("MIN", "MAX"):
            full = traced.allreduce(xs, "hvd", ReduceOp[op])
            outs[f"even_rs_{op}"] = jax.lax.dynamic_slice_in_dim(
                full, axis_index("hvd") * per, per)
        for key, (pre, post) in workers.PRODUCT_SCALES.items():
            outs[key] = traced.allreduce(xs, "hvd", ReduceOp.PRODUCT, pre, post)
        outs["prod_async"] = traced.allreduce(xs, "hvd", ReduceOp.PRODUCT, 2.0)
        outs["prod_grouped_0"], outs["prod_grouped_1"] = traced.grouped_allreduce(
            [xs, 2 * xs[:1]], "hvd", ReduceOp.PRODUCT)
        outs["prod_opt"] = traced.grouped_allreduce([xs], "hvd", ReduceOp.PRODUCT)[0]
        return outs

    keys = (["even"] + [f"even_rs_{op}" for op in workers.REDUCE_OPS]
            + list(PRODUCT_KEYS))
    run = shard_map(body, mesh=mesh, in_specs=P("hvd"),
                    out_specs={k: P("hvd") for k in keys})
    got = {k: np.split(np.asarray(v), size) for k, v in run(x).items()}
    return [{k: got[k][r] for k in keys} for r in range(size)]


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"{n}ranks")
def world(request, tmp_path_factory):
    size = request.param
    port = _spawn_port(size, tmp_path_factory.mktemp(f"gloo{size}"))
    return size, port, _jax_engine(size), _jax_traced(size)


@pytest.mark.parametrize("key", AG_KEYS)
def test_ragged_allgather_matches_engine(world, key):
    size, port, eng, _ = world
    for r in range(size):
        assert port[r][key].dtype == eng[r][key].dtype
        np.testing.assert_array_equal(port[r][key], eng[r][key])
    assert port[0][key].shape[0] == sum(
        workers.collective_inputs(r, size)[key].shape[0] for r in range(size))


@pytest.mark.parametrize("key", AG_KEYS + ["even"])
def test_allgather_async_matches_sync(world, key):
    size, port, _, _ = world
    for r in range(size):
        np.testing.assert_array_equal(port[r][f"{key}_async"], port[r][key])


def test_allgather_of_a_scalar_takes_one_row_per_rank(world):
    size, port, _, _ = world
    for r in range(size):
        np.testing.assert_array_equal(port[r]["ag_scalar"], np.arange(size, dtype=np.float32))


@pytest.mark.parametrize("suffix", ["", "_async"])
def test_uneven_alltoall_matches_engine(world, suffix):
    size, port, eng, _ = world
    for r in range(size):
        assert list(port[r][f"a2a{suffix}_splits"]) == list(eng[r]["a2a_splits"])
        assert list(eng[r]["a2a_splits"]) == [p + 1 for p in range(size)]
        np.testing.assert_array_equal(port[r][f"a2a{suffix}"], np.asarray(eng[r]["a2a"]))


def test_even_alltoall_matches_engine(world):
    size, port, eng, _ = world
    for r in range(size):
        assert list(port[r]["a2a_even_splits"]) == list(eng[r]["a2a_even_splits"]) == [2] * size
        np.testing.assert_array_equal(port[r]["a2a_even"], np.asarray(eng[r]["a2a_even"]))


@pytest.mark.parametrize("suffix", ["", "_async"])
def test_broadcast_from_each_root_matches_engine(world, suffix):
    size, port, eng, _ = world
    for root in range(size):
        for r in range(size):
            np.testing.assert_array_equal(port[r][f"bcast_{root}{suffix}"],
                                          np.asarray(eng[r][f"bcast_{root}"]))
            np.testing.assert_array_equal(port[r][f"bcast_{root}{suffix}"],
                                          np.full(3, root * 10, np.float32))


def test_broadcast_object_matches_jax(world):
    size, port, eng, _ = world
    for root in range(size):
        for r in range(size):
            assert port[r][f"object_{root}"] == eng[r][f"object_{root}"] \
                == workers.collective_object(root)


def test_allgather_object_matches_jax(world):
    size, port, eng, _ = world
    want = [workers.collective_object(r) for r in range(size)]
    for r in range(size):
        assert port[r]["allgather_object"] == eng[r]["allgather_object"] == want


def test_even_allgather_matches_traced(world):
    size, port, _, tr = world
    for r in range(size):
        np.testing.assert_array_equal(port[r]["even"], tr[r]["even"])


@pytest.mark.parametrize("op", workers.REDUCE_OPS)
def test_reducescatter_matches_traced(world, op):
    size, port, _, tr = world
    for r in range(size):
        np.testing.assert_allclose(port[r][f"even_rs_{op}"], tr[r][f"even_rs_{op}"],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("key", PRODUCT_KEYS)
def test_product_matches_traced(world, key):
    size, port, _, tr = world
    for r in range(size):
        np.testing.assert_allclose(port[r][key], tr[r][key], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(port[r][key], port[0][key])
    assert port[0]["rs_product"].startswith("ValueError"), port[0]["rs_product"]


@pytest.mark.parametrize("op", workers.REDUCE_OPS)
def test_reducescatter_drops_the_rows_past_size_times_per_as_the_engine(world, op):
    """For AVERAGE the reference is the engine's SUM over size: the JAX
    eager ``reducescatter`` resolves its op as ``op or ReduceOp.SUM``, and
    AVERAGE is 0, so it sums; the port averages, as
    ``traced.reducescatter`` does (test_reducescatter_matches_traced)."""
    size, port, eng, _ = world
    for r in range(size):
        want = eng[r]["rs_SUM"] / np.float32(size) if op == "AVERAGE" else eng[r][f"rs_{op}"]
        assert port[r][f"rs_{op}"].shape == (2, 3)
        np.testing.assert_allclose(port[r][f"rs_{op}"], want, rtol=TOL, atol=TOL)


def test_reducescatter_defaults_to_sum(world):
    size, port, _, _ = world
    for r in range(size):
        np.testing.assert_array_equal(port[r]["rs_default"], port[r]["rs_SUM"])


def test_allreduce_async_through_poll_and_synchronize(world):
    size, port, _, _ = world
    total = sum(workers.collective_inputs(r, size)["even"] for r in range(size))
    for r in range(size):
        np.testing.assert_array_equal(port[r]["allreduce_async_sum"], port[r]["allreduce_sum"])
        np.testing.assert_allclose(port[r]["allreduce_sum"], total, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(port[r]["allreduce_avg"], total / size, rtol=TOL, atol=TOL)


def test_average_and_op_together_raise(world):
    _, port, _, _ = world
    for res in port:
        assert res["conflict"].startswith("ValueError")
        assert "average=" in res["conflict"]


def test_a_handle_synchronizes_once(world):
    _, port, _, _ = world
    for res in port:
        assert res["handle_twice"].startswith("ValueError"), res["handle_twice"]


def test_trailing_dim_mismatch_names_the_op_and_both_shapes(world):
    size, port, _, _ = world
    for res in port:
        msg = res["trailing_mismatch"]
        assert msg.startswith("HorovodInternalError"), msg
        assert "[allgather.bad]" in msg     # the engine's name of the tensor
        # The coordinator names the first request to arrive and the first
        # that differs from it: two of the ranks' shapes [2, 3 + r].
        assert sum(f"[2, {3 + r}]" in msg for r in range(size)) == 2, msg


def test_dtype_mismatch_names_both_dtypes(world):
    _, port, _, _ = world
    for res in port:
        msg = res["dtype_mismatch"]
        assert msg.startswith("HorovodInternalError"), msg
        assert "FLOAT32" in msg and "FLOAT64" in msg, msg


def test_the_group_works_after_the_errors(world):
    size, port, _, _ = world
    for res in port:
        np.testing.assert_array_equal(res["after_errors"], [float(size)])
