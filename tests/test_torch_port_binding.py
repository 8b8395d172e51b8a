"""The port's ``horovod.torch`` binding (``horovod_tpu_torch.torch``) on 2
gloo ranks against the JAX package's binding (``horovod_tpu.torch``).

The port's ranks are spawned processes (tests/_torch_port_workers.py
``_run_binding_world``). The JAX binding runs in this process, one thread
per rank, each over its own JAX engine on one ``ThreadedGroup``, with
``horovod_tpu.common.basics``' rank, size, mode and engine answered per
thread and the binding's handle table kept per thread (its handles are
engine-local integers). Both sides train the same ``nn.Module`` from the
same numpy-drawn weights on the same batches:

* the hook ``DistributedOptimizer`` over SGD and AdamW, with
  ``backward_passes_per_step=2`` (no 1/k rescaling), with
  ``gradient_predivide_factor=4`` and with ``op=Sum``: the parameters
  after 3 steps bitwise equal (two ranks: one addition a sum);
* ``skip_synchronize`` with gradient clipping between the reduction and
  the step: bitwise equal;
* the guards: ``gradient_predivide_factor`` with an op other than
  Average and duplicate ``named_parameters`` raise ``ValueError``;
* the Adasum delta optimizer: bitwise the JAX one, and within 1e-5 of the
  sequential oracle of tests/test_torch_adapter.py (the local Adam step's
  delta from each rank combined by ``adasum_numpy``, added to the start);
  its ``skip_synchronize`` raises;
* the in-place ``allreduce_`` and ``broadcast_``, and the differentiable
  ``allreduce`` (its backward all-reduces the cotangent);
* a dropped model and its hook optimizer are freed (the hooks hold the
  optimizer weakly).
"""
import threading

import numpy as np
import pytest
import torch

import horovod_tpu.common.basics as jax_basics
import horovod_tpu.torch as jax_torch
from horovod_tpu.backend.threaded import ThreadedGroup
from horovod_tpu.engine.engine import Engine
from horovod_tpu.ops.adasum import adasum_numpy

import _torch_port_workers as workers

SIZE = 2


class _PerRank(dict):
    """The JAX binding's module-level handle table, keyed per rank thread."""

    def __init__(self, local):
        super().__init__()
        self.local = local

    def __setitem__(self, h, v):
        super().__setitem__((self.local.rank, h), v)

    def __contains__(self, h):
        return super().__contains__((self.local.rank, h))

    def pop(self, h, *default):
        return super().pop((self.local.rank, h), *default)


def _jax_rank(r: int) -> dict:
    out = {case: workers.binding_train(jax_torch, torch, case, r)
           for case in workers.BINDING_CASES}
    out.update(workers.binding_extras(jax_torch, torch, r))
    return out


def _jax_binding() -> list:
    group = ThreadedGroup(SIZE)
    engines = [Engine(rank=r, size=SIZE, backend=group.backend(r)) for r in range(SIZE)]
    for e in engines:
        e.cycle_time_s = 0.001
        e.start()
    local = threading.local()
    results, errors = [None] * SIZE, [None] * SIZE

    def body(r):
        local.rank = r
        try:
            results[r] = _jax_rank(r)
        except BaseException as ex:  # noqa: BLE001 - re-raised below
            errors[r] = ex

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_basics, "rank", lambda: local.rank)
        patch.setattr(jax_basics, "size", lambda: SIZE)
        patch.setattr(jax_basics, "mode", lambda: "process")
        patch.setattr(jax_basics, "engine", lambda: engines[local.rank])
        patch.setattr(jax_torch, "_handles", _PerRank(local))
        threads = [threading.Thread(target=body, args=(r,)) for r in range(SIZE)]
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    port = workers.spawn_world(SIZE, tmp_path_factory.mktemp("binding"), "_run_binding_world",
                               env={"HOROVOD_CYCLE_TIME": "1"})
    return port, _jax_binding()


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("case", list(workers.BINDING_CASES))
def test_optimizer_matches_the_jax_binding(world, case):
    port, jax_res = world
    for r in range(SIZE):
        _equal(port[r][case], jax_res[r][case])
    _equal(port[0][case], port[1][case])     # replicas stay equal
    start = dict(workers.binding_net(torch).named_parameters())
    assert any(not np.array_equal(port[0][case][n], start[n].detach().numpy())
               for n in start)


def test_backward_passes_are_not_rescaled(world):
    """Two accumulated passes reduce their sum: under SGD the k=2 run's
    first update is not the k=1 run's update of the mean batch."""
    port, _ = world
    assert not all(np.array_equal(port[0]["bpps2"][n], port[0]["sgd"][n])
                   for n in port[0]["sgd"])


def test_skip_synchronize_matches_the_jax_binding(world):
    port, jax_res = world
    for r in range(SIZE):
        _equal(port[r]["skip_sync"], jax_res[r]["skip_sync"])
        assert port[r]["clip_norm"] == jax_res[r]["clip_norm"]


@pytest.mark.parametrize("key,text", [("predivide_sum", "op != Average"),
                                      ("duplicate", "unique")])
def test_guards_raise_value_error(world, key, text):
    port, jax_res = world
    for r in range(SIZE):
        assert port[r][key].startswith("ValueError"), port[r][key]
        assert text in port[r][key]
        assert port[r][key] == jax_res[r][key]


def test_adasum_delta_optimizer_matches_the_oracle(world):
    port, jax_res = world
    for r in range(SIZE):
        _equal(port[r]["adasum"], jax_res[r]["adasum"])
        assert port[r]["adasum_skip"].startswith("AssertionError")
    for name, start in port[0]["adasum_start"].items():
        deltas = [port[r]["adasum_local"][name].reshape(-1) - start.reshape(-1)
                  for r in range(SIZE)]
        want = start.reshape(-1) + adasum_numpy(deltas)[0]
        for r in range(SIZE):
            np.testing.assert_allclose(port[r]["adasum"][name].reshape(-1), want,
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_inplace_and_differentiable_collectives(world):
    port, _ = world
    for r in range(SIZE):
        np.testing.assert_array_equal(port[r]["inplace"], np.full(3, 1.5, np.float32))
        np.testing.assert_array_equal(port[r]["broadcast_"], np.full(2, 1.0, np.float32))
        # d(sum over ranks of w)/dw, all-reduced again in backward: SIZE.
        np.testing.assert_array_equal(port[r]["allreduce_grad"],
                                      np.full(2, float(SIZE), np.float32))


def test_a_dropped_optimizer_and_its_model_are_freed(world):
    port, _ = world
    assert all(res["dropped_optimizer_freed"] for res in port)
