"""The port's Adasum on 2 and 4 gloo ranks against ``adasum_numpy`` and the
JAX traced ``adasum_allreduce`` in ``shard_map`` on as many CPU devices.

Each rank's vector is drawn from numpy seed 11, rank 1's a near multiple of
rank 0's so the projection terms matter. Checked: ``hvd.allreduce(op=
Adasum)`` and ``hvd.adasum_allreduce``, every rank bitwise the same;
``DistributedOptimizer(op=Adasum)`` with SGD(1.0), whose step is minus
the combined gradient: one vector of the grouped buffer when ``fuse``, each
gradient apart otherwise and at the default, where it is also held
against the JAX ``DistributedOptimizer(op=Adasum)`` at its default in
``shard_map`` (ROADMAP C6: the port's default used to combine one vector,
9.5% away at 4 ranks). A world that is not a power of two raises.

Tolerances: tests/test_adasum.py's, rtol 1e-4 and atol 1e-5 against the f64
oracle and against JAX.
"""
import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_jax
from horovod_tpu.ops.adasum import adasum_allreduce as jax_adasum
from horovod_tpu.ops.adasum import adasum_numpy as jax_adasum_numpy
from horovod_tpu.utils.compat import shard_map

import _torch_port_workers as workers
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.ops.adasum import adasum_allreduce, adasum_numpy

SIZES = [2, 4]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", params=SIZES)
def world(request, tmp_path_factory):
    n = request.param
    return n, workers.spawn_world(n, tmp_path_factory.mktemp(f"adasum{n}"), "_run_adasum")


def _jax(vecs):
    n = vecs.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    f = shard_map(lambda v: jax_adasum(v[0], "x")[None], mesh=mesh,
                  in_specs=P("x"), out_specs=P("x"))
    return np.asarray(f(vecs))


def test_allreduce_adasum_matches_oracle_and_jax(world):
    n, port = world
    vecs, _ = workers.adasum_inputs(n)
    oracle = adasum_numpy(list(vecs))
    jax_out = _jax(vecs)
    for r in range(n):
        for key in ("allreduce", "adasum_allreduce"):
            np.testing.assert_allclose(port[r][key], oracle[r], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(port[r][key], jax_out[r], rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(port[r][key], port[0][key])
        assert port[r]["input_kept"]


def test_the_port_oracle_is_the_jax_oracle():
    vecs, _ = workers.adasum_inputs(4)
    for a, b in zip(adasum_numpy(list(vecs)), jax_adasum_numpy(list(vecs))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fuse", [True, False])
def test_distributed_optimizer_adasum(world, fuse):
    n, port = world
    _, grads = workers.adasum_inputs(n)
    keys = list(workers.ADASUM_SHAPES)
    if fuse:
        flat = [np.concatenate([g[k].ravel() for k in keys]) for g in grads]
        comb = adasum_numpy(flat)[0]
        sizes = np.cumsum([int(np.prod(s)) for s in workers.ADASUM_SHAPES.values()])[:-1]
        want = [p.reshape(s) for p, s in zip(np.split(comb, sizes),
                                             workers.ADASUM_SHAPES.values())]
    else:
        want = [adasum_numpy([g[k] for g in grads])[0] for k in keys]
    for r in range(n):
        for got, w in zip(port[r][f"opt_fuse{int(fuse)}"], want):
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)


def _jax_optimizer_default(grads):
    """The JAX ``DistributedOptimizer(sgd(1.0), op=Adasum)`` at its defaults
    in ``shard_map``, one rank's gradients a device: minus its update."""
    n = len(grads)
    keys = list(workers.ADASUM_SHAPES)
    hvd_jax.shutdown()
    hvd_jax.init(devices=jax.devices()[:n])
    try:
        tx = hvd_jax.DistributedOptimizer(optax.sgd(1.0), op=hvd_jax.Adasum)

        def step(g):
            g = {k: v[0] for k, v in g.items()}
            updates, _ = tx.update(g, tx.init(g), g)
            return {k: -v[None] for k, v in updates.items()}

        run = shard_map(step, mesh=hvd_jax.mesh(), in_specs=(P("hvd"),),
                        out_specs=P("hvd"))
        out = run({k: np.stack([g[k] for g in grads]) for k in keys})
    finally:
        hvd_jax.shutdown()
    return [[np.asarray(out[k])[r] for k in keys] for r in range(n)]


def test_distributed_optimizer_adasum_default_is_per_gradient_as_jax(world):
    n, port = world
    _, grads = workers.adasum_inputs(n)
    keys = list(workers.ADASUM_SHAPES)
    oracle = [adasum_numpy([g[k] for g in grads])[0] for k in keys]
    jax_out = _jax_optimizer_default(grads)
    for r in range(n):
        for got, w, j in zip(port[r]["opt_default"], oracle, jax_out[r]):
            np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got, j, rtol=RTOL, atol=ATOL)
        for got, ref in zip(port[r]["opt_default"], port[0]["opt_default"]):
            np.testing.assert_array_equal(got, ref)


def test_three_ranks_raise(monkeypatch):
    """The power-of-two check comes before any exchange, so a world of
    three is told so on every rank."""
    import horovod_tpu_torch as hvd

    monkeypatch.setattr(basics, "size", lambda: 3)
    monkeypatch.setattr(basics, "rank", lambda: 0)
    with pytest.raises(ValueError, match="power-of-2"):
        adasum_allreduce(torch.ones(4))
    w = torch.nn.Parameter(torch.zeros(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0), op=hvd.Adasum)
    w.grad = torch.ones(2)
    monkeypatch.setattr(hvd.ops, "_exchange_header", lambda *a, **k: [((2,), (2,))] * 3)
    with pytest.raises(ValueError, match="power-of-2"):
        opt.step()
    with pytest.raises(ValueError, match="power-of-2"):
        adasum_numpy([np.ones(2)] * 3)
