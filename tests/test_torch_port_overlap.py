"""The gradient all-reduce overlapped with backward, the stateless wire
casts and the header checks, on 2 gloo ranks.

* Overlap: a small net with a parameter no rank uses and a layer only
  rank 0 uses (both registered first, so the last buckets can only launch
  in ``step()``) trained by AdamW under ``DistributedOptimizer`` with
  ``HOROVOD_FUSION_THRESHOLD=1024`` (several buckets), overlapped (the
  default), after backward in the same buckets and after backward in one
  grouped all-reduce, plain and with ``Compression.fp16`` and
  ``backward_passes_per_step=2``: the parameters and gradients bitwise
  equal on the three, every parameter's gradient reduced (zeros for the
  unused one, as Horovod gives it), and every parameter bitwise equal
  across the ranks; ZeRO-1 from the same start within rtol 1e-5, atol 1e-6
  of them (the same zero-gradient semantics).
* The gradient transforms exchange their header once, and again only when
  the gradients' signature changes.
* Wire casts: ``hvd.allreduce`` (SUM, AVERAGE) and ``grouped_allreduce``
  of seeded f32 tensors on each lane (none, bf16, fp16, int8) against the
  JAX traced ``allreduce`` in ``shard_map`` on 2 CPU devices under the
  same knobs: equal to 1e-6 (two ranks: one addition, the same rounding in
  both).
* Mismatches: shape, dtype, op, prescale, postscale, root, tensor sizes
  and the collective itself differing between the ranks raise
  ``HorovodInternalError`` on every rank, naming the tensor and both
  values (the engine coordinator's ERROR for world calls); so does a
  ``DistributedOptimizer`` whose gradients differ (its header check); the
  group works after.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.common.types import ReduceOp
from horovod_tpu.ops import traced
from horovod_tpu.utils.compat import shard_map

import _torch_port_workers as workers

SIZE = 2
TOL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return workers.spawn_world(SIZE, tmp_path_factory.mktemp("overlap"), "_run_overlap",
                               env={"HOROVOD_FUSION_THRESHOLD": "1024"})


def _params(run):
    return {k: v for k, v in run.items() if k not in ("buckets", "grads")}


@pytest.mark.parametrize("case", list(workers.OVERLAP_CASES))
def test_overlap_is_bitwise_the_after_backward_path(world, case):
    for res in world:
        after = res[f"{case}_grouped"]
        assert after["buckets"] == 0
        for run in ("hooks", "buckets"):
            over = res[f"{case}_{run}"]
            assert over["buckets"] > 2, over["buckets"]
            for name, val in _params(after).items():
                np.testing.assert_array_equal(over[name], val, err_msg=f"{run} {name}")
            for name, g in after["grads"].items():
                np.testing.assert_array_equal(over["grads"][name], g, err_msg=f"{run} {name}")
        np.testing.assert_array_equal(after["grads"]["unused"], np.zeros(5, np.float32))


# ZeRO takes no compression= (its wire cast is HOROVOD_WIRE_COMPRESSION).
UNEVEN = [(case, run) for case, (compression, _) in workers.OVERLAP_CASES.items()
          for run in workers.OVERLAP_RUNS if not (compression and run == "zero1")]


@pytest.mark.parametrize("case,run", UNEVEN)
def test_a_parameter_unused_on_one_rank_stays_equal_across_ranks(world, case, run):
    """``rank0_only`` gets a gradient on rank 0 only: every rank steps it
    with the same reduced gradient, so the replicas stay bitwise equal."""
    got = [res[f"{case}_{run}"] for res in world]
    for name, val in _params(got[0]).items():
        np.testing.assert_array_equal(got[1][name], val, err_msg=name)
    if run == "zero1":
        for name, val in _params(world[0][f"{case}_grouped"]).items():
            np.testing.assert_allclose(got[0][name], val, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        return
    for name, g in got[0]["grads"].items():
        assert g is not None, name
        np.testing.assert_array_equal(got[1]["grads"][name], g, err_msg=name)
    assert np.any(got[0]["grads"]["rank0_only.weight"])


def test_gradient_transforms_check_their_signature_once(world):
    for res in world:
        seen = res["transform_headers"]
        assert seen["steady"] == ["distributed_value_and_grad", "DistributedGradientTape"]
        assert seen["after_change"] == ["distributed_value_and_grad"]
        for g in seen["w_grad"]:   # the mean of x over the ranks: (1 + 2) / 2
            np.testing.assert_array_equal(g, np.full(3, 1.5, np.float32))


def _jax_allreduce(lane, big, small):
    with workers.lane_env(lane):
        mesh = Mesh(np.array(jax.devices()[:SIZE]), ("x",))

        def body(x, s):
            x, s = x[0], s[0]
            return (traced.allreduce(x, "x", ReduceOp.SUM)[None],
                    traced.allreduce(x, "x", ReduceOp.AVERAGE)[None],
                    traced.allreduce(s, "x", ReduceOp.AVERAGE)[None])

        f = shard_map(body, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P("x"),) * 3)
        return [np.asarray(a) for a in jax.jit(f)(big, small)]


@pytest.mark.parametrize("lane", list(workers.LANES))
def test_wire_cast_matches_the_jax_traced_allreduce(world, lane):
    """The world's grouped all-reduce goes through the engine, which fuses
    a group up to HOROVOD_FUSION_THRESHOLD (1024 bytes in this world): the
    1200-byte x and the 164-byte s are two responses, each cast on its own,
    as the JAX traced all-reduce casts each tensor."""
    big, small = workers.wire_inputs(SIZE)
    want_sum, want_avg, want_small = _jax_allreduce(lane, big, small)
    exact = big.sum(0)
    for r, res in enumerate(world):
        np.testing.assert_allclose(res[f"wire_{lane}_sum"], want_sum[r], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res[f"wire_{lane}_avg"], want_avg[r], rtol=TOL, atol=TOL)
        g0, g1 = res[f"wire_{lane}_grouped"]
        np.testing.assert_allclose(g0, want_avg[r], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g1, want_small[r], rtol=TOL, atol=TOL)
        # The cast really happened where the lane asks for one.
        if lane == "none":
            np.testing.assert_allclose(res[f"wire_{lane}_sum"], exact, rtol=TOL, atol=TOL)
        else:
            assert not np.array_equal(res[f"wire_{lane}_sum"], exact)


# case -> (what the message names, the two values). World calls are the
# engine's: the tensor's name and the coordinator's text (the JAX
# package's), AVERAGE lowered to SUM with postscale 1/size, reduce ops by
# their number (SUM 1, MAX 4), dtypes by the wire enum; the optimizer's
# signature check is still the header exchange's.
MISMATCH = {
    "shape": ("[allreduce.grads]", "[2]", "[3]"),
    "shape_async": ("Mismatched allreduce tensor shapes", "[2]", "[3]"),
    "dtype": ("Mismatched data types", "FLOAT32", "FLOAT64"),
    "op": ("Mismatched reduce ops", "op 1", "another 4"),
    "prescale": ("Mismatched prescale/postscale", "prescale 1.0", "prescale 2.0"),
    "postscale": ("Mismatched prescale/postscale", "postscale 0.25", "postscale 0.5"),
    "grouped": ("[allreduce.grouped.0]", "[2]", "[3]"),
    "grouped_shape": ("[allreduce.grouped.1]", "[3]", "[4]"),
    "root": ("Mismatched broadcast root ranks", "root 0", "another 1"),
    "root_async": ("Mismatched broadcast root ranks", "root 0", "another 1"),
    "broadcast_shape": ("Mismatched broadcast tensor shapes", "[2]", "[3]"),
    "collective": ("Mismatched collective operations", "ALLREDUCE", "BROADCAST"),
    "optimizer": ("DistributedOptimizer", "[3]", "[4]"),
}


@pytest.mark.parametrize("case", list(MISMATCH))
def test_a_mismatch_raises_on_every_rank_naming_both_values(world, case):
    what, first, second = MISMATCH[case]
    for res in world:
        msg = res[case]
        assert msg.startswith("HorovodInternalError"), msg
        assert what in msg and first in msg and second in msg, msg


def test_the_group_works_after_the_mismatches(world):
    for res in world:
        np.testing.assert_array_equal(res["after_errors"], [float(SIZE)])
