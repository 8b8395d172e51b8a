"""The port's SyncBatchNorm and sync_batch_stats on 2 gloo ranks.

Each rank normalises its half of a seeded (8, 3, 4, 4) batch with
``hvd.SyncBatchNorm`` and every rank also runs ``nn.BatchNorm2d`` over the
whole batch: two training iterations with a seeded cotangent, then eval.
Held: the output, the gradients of x, weight and bias (the latter summed
over the ranks, as the whole batch's are), the running mean and the
(unbiased) running variance, and the eval output. ``sync_batch_stats`` on
each rank's (N/2, 4, 4, 3) channels-last slice is held against the JAX
``sync_batch_stats`` under ``shard_map`` on 2 CPU devices. At world 1 the
module is ``nn.BatchNorm2d``.

Tolerances: rtol 1e-5, atol 1e-5 (f32; the port takes E[x²]−E[x]², torch
a Welford variance).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops.sync_batch_norm import sync_batch_stats as jax_sync_batch_stats
from horovod_tpu.utils.compat import shard_map

import _torch_port_workers as workers
from horovod_tpu_torch.ops.sync_batch_norm import SyncBatchNorm, sync_batch_stats

SIZE = 2
TOL = 1e-5
KEYS = ["y0", "y1", "dx0", "dx1", "dweight0", "dweight1", "dbias0", "dbias1",
        "running_mean", "running_var", "eval"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return workers.spawn_world(SIZE, tmp_path_factory.mktemp("sync_bn"), "_run_sync_bn")


@pytest.mark.parametrize("key", KEYS)
def test_sync_batch_norm_matches_batch_norm_over_the_whole_batch(world, key):
    for res in world:
        np.testing.assert_allclose(res[key], res[f"{key}_ref"], rtol=TOL, atol=TOL)


def test_sync_batch_stats_matches_jax(world):
    *_, nhwc = workers.sync_bn_inputs()
    mesh = Mesh(np.array(jax.devices()[:SIZE]), ("dp",))
    f = shard_map(lambda x: tuple(s[None] for s in jax_sync_batch_stats(x, "dp")),
                  mesh=mesh, in_specs=P("dp"), out_specs=(P("dp"), P("dp")))
    mean, var = (np.asarray(a) for a in f(nhwc))
    for r, res in enumerate(world):
        np.testing.assert_allclose(res["stats_mean"], mean[r], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res["stats_var"], var[r], rtol=TOL, atol=TOL)


def test_world_one_is_batch_norm():
    xs, coeff, weight, bias, nhwc = workers.sync_bn_inputs()
    sbn, ref = SyncBatchNorm(workers.SBN_C, momentum=None), torch.nn.BatchNorm2d(
        workers.SBN_C, momentum=None)
    for it in range(workers.SBN_ITERS):
        x = torch.from_numpy(xs[it])
        np.testing.assert_allclose(sbn(x).detach().numpy(), ref(x).detach().numpy(),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(sbn.running_var.numpy(), ref.running_var.numpy(),
                               rtol=TOL, atol=TOL)
    mean, var = sync_batch_stats(torch.from_numpy(nhwc))
    jmean, jvar = jax_sync_batch_stats(nhwc)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=TOL, atol=TOL)
