"""Single-process surface of the port on the CPU: init/shutdown, topology
from the launcher environment, the dp-only mesh, and every other mesh axis
at one rank."""
import pytest
import torch

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


@pytest.mark.parametrize("kw", [{"zero": 1}, {"error_feedback": True},
                                {"op": hvd.Product}, {"op": hvd.Adasum}])
def test_distributed_optimizer_refuses_unported_modes(cpu_world, kw):
    """PRODUCT is still not ported; ZeRO, error feedback and Adasum are
    (optim/zero.py, ops/adasum.py) and build."""
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    if kw.get("op") == hvd.Product:
        with pytest.raises(NotImplementedError, match="PRODUCT"):
            hvd.DistributedOptimizer(opt, **kw)
    else:
        assert isinstance(hvd.DistributedOptimizer(opt, **kw), hvd.DistributedOptimizer)


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
    with pytest.raises(NotImplementedError):
        hvd.allreduce(torch.ones(2), op=hvd.Product)
