"""Collectives and DistributedOptimizer of the port on 2 gloo ranks.

The ranks are spawned processes (tests/_torch_port_workers.py) that meet
through a FileStore in the test's tmp directory, so nothing collides with
other test workers. Closed forms are checked exactly where the arithmetic
is exact, and at f32 tolerance (1e-6) otherwise; 3 SGD steps on
rank-dependent data are held against the JAX DistributedOptimizer on a
2-device mesh from the same init at 1e-6.
"""
import multiprocessing as mp

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_jax
from horovod_tpu.utils.compat import shard_map

import _torch_port_workers as workers

SIZE = 2
TOL = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init_file = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=workers.worker, args=(r, SIZE, init_file, queue))
             for r in range(SIZE)]
    for p in procs:
        p.start()
    results = dict(queue.get(timeout=180) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    for r, res in results.items():
        assert isinstance(res, dict), f"rank {r} failed:\n{res}"
    return [results[r] for r in range(SIZE)]


def test_ranks_see_their_topology(ranks):
    assert [int(r["rank"]) for r in ranks] == [0, 1]
    assert all(int(r["size"]) == SIZE for r in ranks)


@pytest.mark.parametrize("op", ["AVERAGE", "SUM"])
@pytest.mark.parametrize("pre,post", workers.SCALES)
def test_allreduce_scaling_closed_form(ranks, op, pre, post):
    base = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    total = base * 3          # rank r holds base * (r + 1)
    want = total * pre * post / (SIZE if op == "AVERAGE" else 1)
    for r in ranks:
        np.testing.assert_allclose(r[f"{op}_{pre}_{post}"], want, rtol=TOL)


def test_allreduce_keeps_its_input(ranks):
    base = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["input_kept"], base * (i + 1))


def test_integer_average_scales_through_f32(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["int_sum"], [9, 15, 21])
        # 1/size in f32 then truncation back to int32, as the JAX _scale
        np.testing.assert_array_equal(r["int_average"], [4, 7, 10])
        assert r["int_average"].dtype == np.int32


def test_min_max_broadcast(ranks):
    base = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["min"], base)
        np.testing.assert_array_equal(r["max"], base * 2)
        np.testing.assert_array_equal(r["broadcast"], base * 2)


def test_grouped_allreduce_matches_per_tensor(ranks):
    for r in ranks:
        for g, s in zip(r["grouped"], r["single"]):
            np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(r["grouped"][1], np.arange(5) * 3.0)


def test_backward_passes_per_step(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["bpps"][0], [0.0, 0.0])
        # mean over the 2 passes, averaged over ranks: 1.5 * ([1,2]+[3,4]) / 2
        np.testing.assert_allclose(r["bpps"][1], [-3.0, -4.5], rtol=TOL)


def test_broadcast_parameters_from_root(ranks):
    w0, _, _ = workers.linreg_data(SIZE)
    for r in ranks:
        np.testing.assert_array_equal(r["broadcast_params"], w0)


def test_sgd_matches_jax_distributed_optimizer(ranks):
    w0, x, y = workers.linreg_data(SIZE)
    hvd_jax.shutdown()
    hvd_jax.init(devices=jax.devices()[:SIZE])
    try:
        tx = hvd_jax.DistributedOptimizer(optax.sgd(workers.LR))

        def step(w, s, xs, ys):
            grads = jax.grad(lambda w_: ((xs @ w_ - ys) ** 2).mean())(w)
            updates, s = tx.update(grads, s, w)
            return optax.apply_updates(w, updates), s

        run = shard_map(step, mesh=hvd_jax.mesh(),
                        in_specs=(P(), P(), P("hvd"), P("hvd")),
                        out_specs=(P(), P()))
        w, s = jax.numpy.asarray(w0), tx.init(jax.numpy.asarray(w0))
        for _ in range(workers.SGD_STEPS):
            w, s = run(w, s, x, y)
    finally:
        hvd_jax.shutdown()
    for r in ranks:
        np.testing.assert_allclose(r["sgd"], np.asarray(w), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ranks[0]["sgd"], ranks[1]["sgd"])
