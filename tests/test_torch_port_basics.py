"""Single-process surface of the port on the CPU: init/shutdown, topology
from the launcher environment, the dp-only mesh, every other mesh axis at
one rank, and PRODUCT at one rank against the JAX traced op in
``shard_map`` on one CPU device (f32, rtol 1e-6)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.common.types import ReduceOp as JaxReduceOp
from horovod_tpu.ops import traced
from horovod_tpu.utils.compat import shard_map

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel.mesh import create_mesh


@pytest.fixture
def cpu_world(monkeypatch):
    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "RANK", "WORLD_SIZE",
                 "HOROVOD_INIT_METHOD", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_queries_before_init_raise():
    hvd.shutdown()
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
    with pytest.raises(hvd.NotInitializedError):
        create_mesh({"dp": 1})


def test_world_of_one_topology(cpu_world):
    assert hvd.is_initialized()
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert hvd.device() == torch.device("cpu")
    hvd.init(device="cpu")            # a second init is a no-op
    assert hvd.size() == 1


def test_reinit_after_shutdown(cpu_world):
    hvd.shutdown()
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    x = torch.arange(4.0)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)


@pytest.mark.parametrize("sizes", [{"dp": 1}, {"dp": -1}, None])
def test_dp_mesh(cpu_world, sizes):
    mesh = create_mesh(sizes)
    assert mesh.axis_names == ("dp",) and mesh.shape == {"dp": 1}
    assert mesh.coords == {"dp": 0} and mesh.size == 1


@pytest.mark.parametrize("axis", ["tp", "sp", "pp", "ep"])
def test_other_mesh_axes_are_not_ported(cpu_world, axis):
    """Every axis is ported now: tp (parallel/tensor.py), sp, ep
    (parallel/ring.py, parallel/ulysses.py, the Switch MoE) and pp
    (parallel/pipeline.py). Each builds at size 1, and size 2 on this world
    of one meets the factoring like any axis."""
    mesh = create_mesh({"dp": 1, axis: 1})
    assert mesh.axis_names == (("pp", "dp") if axis == "pp" else ("dp", axis))
    assert mesh.coords == {"dp": 0, axis: 0}
    assert mesh.comm(axis).size == 1
    with pytest.raises(ValueError, match="do not divide"):
        create_mesh({"dp": 1, axis: 2})


def test_mesh_must_cover_the_world(cpu_world):
    with pytest.raises(ValueError):
        create_mesh({"dp": 2})


def _jax_product(x: np.ndarray, pre: float = 1.0, post: float = 1.0) -> np.ndarray:
    """``traced.allreduce(op=PRODUCT)`` over a one-device mesh."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("hvd",))
    f = shard_map(lambda v: traced.allreduce(v, "hvd", JaxReduceOp.PRODUCT, pre, post),
                  mesh=mesh, in_specs=P(), out_specs=P())
    return np.asarray(f(x))


@pytest.mark.parametrize("kw", [{"zero": 1}, {"error_feedback": True},
                                {"op": hvd.Product}, {"op": hvd.Adasum}])
def test_distributed_optimizer_refuses_unported_modes(cpu_world, kw):
    """Every mode is ported now and builds: ZeRO, error feedback, Adasum
    (optim/zero.py, ops/adasum.py) and PRODUCT, whose SGD(1.0) step from
    zeros is minus the JAX traced product of the gradient."""
    w = torch.nn.Parameter(torch.zeros(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0), **kw)
    assert isinstance(opt, hvd.DistributedOptimizer)
    if kw.get("op") == hvd.Product:
        g = np.array([0.5, -2.0, 3.0], np.float32)
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(-w.detach().numpy(), _jax_product(g), rtol=1e-6)


def test_distributed_optimizer_shares_inner_state(cpu_world):
    w = torch.nn.Parameter(torch.ones(3))
    inner = torch.optim.AdamW([w], lr=0.1, weight_decay=1e-4)
    opt = hvd.DistributedOptimizer(inner)
    assert opt.param_groups is inner.param_groups
    w.grad = torch.ones(3)
    opt.step()
    assert opt.state is inner.state and len(opt.state_dict()["state"]) == 1
    hvd.broadcast_optimizer_state(opt, root_rank=0)   # AdamW's CPU `step` too
    opt.zero_grad()
    assert w.grad is None


def test_unported_reduce_ops_raise(cpu_world):
    """PRODUCT, the last reduce op to port, now runs: the all-reduce, its
    async form and the grouped all-reduce against the JAX traced op."""
    x = np.array([[1.5, -2.0], [0.25, 4.0]], np.float32)
    got = hvd.allreduce(torch.from_numpy(x), op=hvd.Product, prescale_factor=0.5,
                        postscale_factor=3.0)
    np.testing.assert_allclose(got.numpy(), _jax_product(x, 0.5, 3.0), rtol=1e-6)
    h = hvd.allreduce_async(torch.from_numpy(x), op=hvd.Product)
    np.testing.assert_allclose(hvd.synchronize(h).numpy(), _jax_product(x), rtol=1e-6)
    (grouped,) = hvd.grouped_allreduce([torch.from_numpy(x)], op=hvd.Product)
    np.testing.assert_allclose(grouped.numpy(), _jax_product(x), rtol=1e-6)
