"""Rank bodies for tests/test_torch_port_distributed.py and
tests/test_torch_port_resnet.py, in a module of their own so spawned ranks
import torch and horovod_tpu_torch only (no jax, no test module). Each rank
returns a dict of numpy arrays through a queue."""
from __future__ import annotations

import os
import traceback

import numpy as np

SCALES = [(1.0, 1.0), (0.5, 1.0), (1.0, 3.0), (2.0, 0.25)]
LR = 0.1
SGD_STEPS = 3


def linreg_data(size: int):
    """w0, and per-rank (x, y) slices of one seeded regression problem."""
    rng = np.random.RandomState(7)
    w0 = rng.randn(4).astype(np.float32)
    x = rng.randn(4 * size, 4).astype(np.float32)
    y = rng.randn(4 * size).astype(np.float32)
    return w0, x, y


def _run(rank: int, size: int) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    out = {"rank": np.array(hvd.rank()), "size": np.array(hvd.size())}
    base = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    x = torch.from_numpy(base * (rank + 1))
    for op in (hvd.Average, hvd.Sum):
        for pre, post in SCALES:
            out[f"{op.name}_{pre}_{post}"] = hvd.allreduce(
                x, op=op, prescale_factor=pre, postscale_factor=post).numpy()
    out["input_kept"] = x.numpy()
    ints = torch.tensor([3, 5, 7], dtype=torch.int32) * (rank + 1)
    out["int_average"] = hvd.allreduce(ints, op=hvd.Average).numpy()
    out["int_sum"] = hvd.allreduce(ints, op=hvd.Sum).numpy()
    out["min"] = hvd.allreduce(x, op=hvd.Min).numpy()
    out["max"] = hvd.allreduce(x, op=hvd.Max).numpy()
    pair = [x, torch.arange(5, dtype=torch.float32) * (rank + 1)]
    out["grouped"] = [t.numpy() for t in hvd.grouped_allreduce(pair, op=hvd.Sum)]
    out["single"] = [hvd.allreduce(t, op=hvd.Sum).numpy() for t in pair]
    out["broadcast"] = hvd.broadcast(x, root_rank=1).numpy()

    # backward_passes_per_step=2: no step on the first call, then the mean
    # of the two gradients, averaged over ranks.
    w = torch.nn.Parameter(torch.zeros(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   backward_passes_per_step=2)
    for g in ([1.0, 2.0], [3.0, 4.0]):
        opt.zero_grad()
        w.grad = torch.tensor(g) * (rank + 1)
        opt.step()
        out.setdefault("bpps", []).append(w.detach().numpy().copy())

    # Parameters broadcast from rank 0, then 3 SGD steps on this rank's
    # slice of the regression data.
    w0, xs, ys = linreg_data(size)
    model = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0 if rank == 0 else -w0)[None])
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    out["broadcast_params"] = model.weight.detach().numpy().copy()[0]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=LR))
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    xr = torch.from_numpy(xs[rank * 4:(rank + 1) * 4])
    yr = torch.from_numpy(ys[rank * 4:(rank + 1) * 4])
    for _ in range(SGD_STEPS):
        opt.zero_grad()
        loss = ((model(xr)[:, 0] - yr) ** 2).mean()
        loss.backward()
        opt.step()
    out["sgd"] = model.weight.detach().numpy().copy()[0]
    hvd.barrier()
    return out


def worker(rank: int, size: int, init_file: str, queue) -> None:
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu", init_method=f"file://{init_file}")
        try:
            queue.put((rank, _run(rank, size)))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


RESNET_LR, RESNET_MOMENTUM = 0.01, 0.9


def _run_resnet(rank: int, size: int, flax_vars, images, labels, fuse) -> dict:
    """One SGD-momentum step of a small f32 ResNet-50 from the flax
    variables, this rank on its slice of the global batch."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import resnet_flax_to_torch
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import make_train_step, softmax_xent

    model = get_model("resnet50").make_model(
        device="cpu", num_filters=8, num_classes=10, dtype=torch.float32,
        fuse_bn_conv_stages=fuse)
    model.load_state_dict(resnet_flax_to_torch(*flax_vars, model))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=RESNET_LR, momentum=RESNET_MOMENTUM))
    init_fn, step_fn = make_train_step(model, opt, softmax_xent,
                                       mesh=create_mesh({"dp": size}))
    state = init_fn()
    state, loss = step_fn(state, torch.from_numpy(images), torch.from_numpy(labels))
    out = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    out["loss"] = loss.numpy().copy()
    hvd.barrier()
    return out


def resnet_worker(rank: int, size: int, init_file: str, queue, flax_vars, images,
                  labels, fuse) -> None:
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu", init_method=f"file://{init_file}")
        try:
            queue.put((rank, _run_resnet(rank, size, flax_vars, images, labels, fuse)))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))
