"""The port's ZeRO-1/2 and error feedback on 2 and 4 gloo ranks against the
JAX package's ``zero_optimizer(optax.adamw)``.

The JAX reference runs traced under ``shard_map`` on as many virtual CPU
devices: one step from ``zero_init`` gives the starting params and a
``ZeroState`` with nonzero moments (and, with error feedback on a lossy
lane, a nonzero residual); ``models.convert.zero_state_from_jax`` hands each
port rank its shard of that state, and both packages take 3 more steps on
the same per-rank gradients. Each wire lane (none, bf16, fp16, int8) runs
with and without error feedback, the port at zero=1 and zero=2 (one layout).
Also: ZeRO without a codec against the port's replicated optimizer, the
state bytes against their closed form, the world-stacked state re-cut
n -> 3 -> n bitwise, the knobs, and what raises.

Tolerances: params after 3 steps rtol 1e-5, atol 1e-6 against JAX and
against the replicated optimizer. On the lossy lanes at most MAX_OFF of
the 270 elements may miss that, and those by at most one codec quantum of
the largest update more (bf16: 2^-7 of it, int8: 1/127): the port's update
is the new shard minus the old (the torch optimizer steps the shard in
place), which carries the f32 rounding of the new shard at the
parameter's ulp (~3e-8 here) where JAX's update does not, and an update
that close to a rounding boundary of the codec rounds the other way, by
one quantum (3 elements on int8 at 4 ranks, none on bf16 and fp16). The
lossy lanes must also be closer to JAX's lossy run than the same steps at
full width from the same start are, by a factor of 1.5 in the mean error
(measured: 1.7 to 3 on fp16, 5 to 28 on bf16, 11 to 24 on int8), so a port
whose wire legs ran at full width fails. These AdamW cases' gradients are
multiples of 1/8 at 4 ranks (``workers.zero_grads``), whose bf16 sums are
exact in any order. The SGD case is not: gloo rounds every partial sum of
the bf16 scatter leg to bf16, where XLA's CPU psum adds in f32 and rounds
once, and the params must land within the bound that follows from that
(``sgd_bf16_bound``; measured: bitwise at 2 ranks, 0.17 of the bound at
4, where the difference, up to 1.2e-4 at lr 1e-2, is as large as the
cast's own). That error feedback carries the residual is held apart, as
tests/test_zero.py holds it: 150 SGD(1.0) steps of a constant gradient
that bf16 cannot represent drift by more than 0.1 without it and by ten
times less with it, with and without ZeRO.
"""
import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jax_hvd
from horovod_tpu.optim.zero import state_specs, zero_init
from horovod_tpu.parallel.mesh import create_mesh
from horovod_tpu.utils.compat import shard_map

import _torch_port_workers as workers
from horovod_tpu_torch.common import env
from horovod_tpu_torch.models.convert import zero_state_from_jax
from horovod_tpu_torch.optim import zero as port_zero

SIZES = [2, 4]
STEPS = 3
RTOL, ATOL = 1e-5, 1e-6
CASES = [(lane, ef) for ef in (False, True) for lane in workers.LANES]
QUANTUM = {"bf16": 2.0 ** -7, "int8": 1 / 127}   # of the largest update
MAX_OFF = 5                 # elements past rtol/atol on a lossy lane, of 270
LOSSY = [(lane, ef) for lane, ef in CASES if lane != "none"]
BF16_U = 2.0 ** -8          # bf16's unit roundoff


def _jax_case(n, lane, ef, params, grads, inner=None):
    """One JAX step from zero_init, then the rest: (params after the first
    step, the state after it as numpy, params after the rest, the largest
    change of a parameter in one of those steps). ``inner`` defaults to
    AdamW."""
    inner = inner or optax.adamw(workers.ZERO_LR, eps=workers.ZERO_EPS,
                                 weight_decay=workers.ZERO_WD)
    with workers.lane_env(lane):
        jax_hvd.shutdown()
        mesh = create_mesh({"hvd": n}, devices=jax.devices()[:n])
        tx = jax_hvd.DistributedOptimizer(inner, zero=1, error_feedback=ef)
        state = zero_init(tx, params, mesh, axis_name="hvd")

        def inner(p, g, s):
            g = jax.tree.map(lambda a: a[0], g)
            upd, s2 = tx.update(g, s, p)
            return optax.apply_updates(p, upd), s2

        step = jax.jit(shard_map(inner, mesh=mesh,
                                 in_specs=(P(), P("hvd"), state_specs("hvd")),
                                 out_specs=(P(), state_specs("hvd"))))
        p, s = step(params, grads[0], state)
        first_p = {k: np.asarray(v) for k, v in p.items()}
        first_s = jax.tree.map(np.asarray, s)
        largest = 0.0
        for g in grads[1:]:
            prev = p
            p, s = step(p, g, s)
            largest = max(largest, *(float(np.max(np.abs(np.asarray(p[k]) - np.asarray(prev[k]))))
                                     for k in p))
        return first_p, first_s, {k: np.asarray(v) for k, v in p.items()}, largest


def _case(n, lane, ef, first_p, first_s, grads, **kw):
    return {"lane": lane, "ef": ef, "params": first_p, "grads": grads,
            "shards": [zero_state_from_jax(first_s, r, n) for r in range(n)], **kw}


def run_world(n, tmp_dir):
    """The JAX references and the port's results on n gloo ranks."""
    params = workers.zero_params()
    grads = workers.zero_grads(n, STEPS + 1)
    cases, want = [], {}
    for lane, ef in CASES:
        first_p, first_s, last_p, largest = _jax_case(n, lane, ef, params, grads)
        cases.append(_case(n, lane, ef, first_p, first_s, grads[1:]))
        want[(lane, ef)] = last_p, largest
    # SGD on the bf16 lane, on gradients whose bf16 sums are not exact; a
    # first JAX step on zero gradients leaves the params as they are.
    sgd_grads = workers.zero_grads(n, STEPS, seed=3, exact_sums=False)
    zero = {k: np.zeros_like(v) for k, v in sgd_grads[0].items()}
    first_p, first_s, last_p, _ = _jax_case(n, "bf16", False, params, [zero] + sgd_grads,
                                            optax.sgd(workers.ZERO_SGD_LR))
    cases.append(_case(n, "bf16", False, first_p, first_s, sgd_grads, inner="sgd"))
    want["sgd"] = last_p, first_p, sgd_grads
    fresh = workers.zero_grads(n, STEPS, seed=2)
    port = workers.spawn_world(n, tmp_dir, "_run_zero", cases, fresh)
    return n, port, want


@pytest.fixture(scope="module", params=SIZES)
def world(request, tmp_path_factory):
    return run_world(request.param, tmp_path_factory.mktemp(f"zero{request.param}"))


def _mean_err(got, ref):
    return np.mean(np.concatenate([np.abs(g - ref[k]).ravel()
                                   for k, g in zip(workers.ZERO_KEYS, got)]))


def sgd_bf16_bound(n, p0, grads):
    """Per element, how far apart two ZeRO runs of SGD(lr) on the bf16 lane
    may land when their backends sum the bf16 scatter leg differently. Each
    side rounds at most n-1 partial sums to bf16, each by at most u times
    S = sum_r |bf16(g_r)|, and the mean divides by n; each side casts its
    update (lr times that mean) to bf16 once, by at most u of it; the f32
    arithmetic adds a few ulps of the parameter a step."""
    out = {}
    for k, p in p0.items():
        bound, mag = np.zeros(p.shape), np.abs(p).astype(np.float64)
        for g in grads:
            g = g[k].astype(np.float64)
            s = np.abs(g).sum(0) * (1 + BF16_U)
            step = workers.ZERO_SGD_LR * (np.abs(g.sum(0)) + n * BF16_U * s) / n
            bound += (workers.ZERO_SGD_LR * 2 * (n - 1) * BF16_U * s / n
                      + 2 * BF16_U * step + 4 * np.spacing((mag + step).astype(np.float32)))
            mag += step
        out[k] = bound
    return out


def _total():
    return sum(v.size for v in workers.zero_params().values())


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("lane,ef", CASES)
def test_zero_matches_jax_zero_optimizer(world, lane, ef, stage):
    n, port, want = world
    ref, largest = want[(lane, ef)]
    quantum = QUANTUM.get(lane, 0.0) * largest
    for r in range(n):
        got = port[r][f"adamw_{lane}_ef{int(ef)}_z{stage}"]
        off = 0
        for k, g in zip(workers.ZERO_KEYS, got):
            bad = ~np.isclose(g, ref[k], rtol=RTOL, atol=ATOL)
            off += int(bad.sum())
            np.testing.assert_allclose(g[bad], ref[k][bad], rtol=RTOL, atol=ATOL + quantum,
                                       err_msg=f"rank {r} leaf {k}")
        assert off <= (MAX_OFF if quantum else 0), f"rank {r}: {off} elements off"
        # Every rank applies the same decoded updates.
        for a, b in zip(got, port[0][f"adamw_{lane}_ef{int(ef)}_z{stage}"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lane,ef", LOSSY)
def test_a_lossy_lane_is_closer_to_jax_than_full_width(world, lane, ef):
    n, port, want = world
    ref = want[(lane, ef)][0]
    for r in range(n):
        lossy = _mean_err(port[r][f"adamw_{lane}_ef{int(ef)}_z1"], ref)
        full = _mean_err(port[r][f"adamw_{lane}_ef{int(ef)}_fullwidth"], ref)
        assert lossy * 1.5 < full, (lossy, full)


@pytest.mark.parametrize("stage", [1, 2])
def test_bf16_sums_within_the_rounding_bound(world, stage):
    n, port, want = world
    ref, p0, grads = want["sgd"]
    bound = sgd_bf16_bound(n, p0, grads)
    for r in range(n):
        for k, g in zip(workers.ZERO_KEYS, port[r][f"sgd_bf16_ef0_z{stage}"]):
            err = np.abs(g.astype(np.float64) - ref[k])
            assert (err <= bound[k]).all(), (r, k, float((err / bound[k]).max()))


def test_error_feedback_telescopes(world):
    n, port, _ = world
    for r in range(n):
        drift = port[r]["drift"]
        assert drift["stateless"] > 0.1, drift
        assert drift["ef0"] * 10 < drift["stateless"], drift
        assert drift["zero1_ef"] * 10 < drift["stateless"], drift


def test_zero_without_codec_matches_replicated(world):
    n, port, _ = world
    for r in range(n):
        for a, b in zip(port[r]["fresh_zero"], port[r]["fresh_replicated"]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_state_bytes_closed_form(world):
    """AdamW: 8 bytes a parameter replicated, 8 a shard element sharded,
    plus 4 a shard element for the error-feedback residual."""
    n, port, _ = world
    total = _total()
    k = -(-total // n)
    for r in range(n):
        assert port[r]["replicated_bytes"] == 8 * total
        assert port[r]["fresh_zero_bytes"] == 8 * k
        assert port[r]["fresh_zero_ef_bytes"] == 12 * k
        assert port[r]["adamw_none_ef1_z2_bytes"] == 12 * k
        status = port[r]["status"]
        assert status["enabled"] and status["world"] == n


def test_recut_preserves_content_bitwise(world):
    n, port, _ = world
    total = _total()
    for r in range(n):
        glob, back, other = port[r]["global"], port[r]["recut_back"], port[r]["recut_other"]
        assert sorted(glob) == ["exp_avg", "exp_avg_sq", "step"]
        for key in glob:
            np.testing.assert_array_equal(glob[key], back[key])
            if glob[key].ndim == 2:
                assert glob[key].shape == (n, -(-total // n))
                assert other[key].shape == (3, -(-total // 3))
                np.testing.assert_array_equal(glob[key].reshape(-1)[:total],
                                              other[key].reshape(-1)[:total])
                assert not other[key].reshape(-1)[total:].any()
            else:
                np.testing.assert_array_equal(other[key], np.full(3, glob[key][0]))
        assert port[r]["from_global_matches"]


def test_recut_rejects_an_unknown_layout():
    state = {"world": 2, "totals": [10],
             "groups": [{"exp_avg": torch.zeros(2, 4)}]}
    with pytest.raises(ValueError, match="unrecognized ZeRO state leaf"):
        port_zero.recut_state(state, 3)


def test_env_knob_parsing(monkeypatch):
    """As tests/test_zero.py::test_env_knob_parsing, and the wire knobs."""
    monkeypatch.setenv("HOROVOD_ZERO_SHARDING", "1")
    assert env.zero_sharding_default() == 1
    monkeypatch.setenv("HOROVOD_ZERO_SHARDING", "2")
    assert env.zero_sharding_default() == 2
    for bogus in ("banana", "3", "-1", ""):
        monkeypatch.setenv("HOROVOD_ZERO_SHARDING", bogus)
        assert env.zero_sharding_default() == 0
    for val, want in (("bf16", "bf16"), ("FP16", "fp16"), ("auto", "auto"),
                      ("int4", "none"), ("", "none")):
        monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION", val)
        assert env.wire_compression_mode() == want
    for val, want in (("0", 0), ("-5", 0), ("123", 123), ("x", 65536)):
        monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION_MIN_BYTES", val)
        assert env.wire_compression_min_bytes() == want
    for val, want in (("1", True), ("off", False), ("", False)):
        monkeypatch.setenv("HOROVOD_WIRE_COMPRESSION_INT8", val)
        assert env.wire_compression_int8() is want
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "nope")
    assert env.fusion_threshold_bytes() == 64 * 1024 * 1024


def test_non_elementwise_optimizer_and_stage_3_raise():
    import horovod_tpu_torch as hvd

    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="elementwise"):
        hvd.DistributedOptimizer(torch.optim.Adagrad([w]), zero=1)
    with pytest.raises(ValueError, match="elementwise"):
        hvd.DistributedOptimizer(torch.optim.LBFGS([w]), zero=2)
    with pytest.raises(ValueError, match="zero stage"):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1), zero=3)
