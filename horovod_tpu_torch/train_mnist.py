"""MNIST training, the framework's first-run example (counterpart of
``examples/jax_mnist.py``; BASELINE.json's 2-process MNIST allreduce).

    torchrun --nproc-per-node 2 -m horovod_tpu_torch.train_mnist
    torchrun --nproc-per-node 2 -m horovod_tpu_torch.train_mnist --device cpu

One process per card (``--device cpu``: gloo on the host). On a synthetic
MNIST-shaped set (``synthetic_mnist``, numpy seed 0: 8,192 images, a
brightened quadrant per class), each rank takes the shard ``[rank::size]``,
as the reference's ``DistributedSampler`` does. ``MnistCNN`` from torch
seed 0, its parameters broadcast from rank 0, then Adam at ``lr · size``
(the linear-scaling rule) under ``DistributedOptimizer``, which averages
the gradients over the ranks. Each epoch walks the shard in the order of
``RandomState(epoch).permutation`` in batches of ``--batch-size``
(``--steps`` cuts an epoch short). The model runs deterministic, as the
JAX example applies it. Rank 0 prints the last loss of each epoch and the
accuracy on the first 1,024 images of its shard.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch


def synthetic_mnist(n: int = 8192, seed: int = 0):
    """(n, 28, 28) float32 images and int32 labels (a copy of the JAX
    example's set)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    # Make it learnable: brighten a quadrant per class.
    for i in range(n):
        q = y[i] % 4
        r, c = divmod(q, 2)
        x[i, r * 14:(r + 1) * 14, c * 14:(c + 1) * 14] += y[i] / 10.0
    return x, y


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64, help="per rank")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--steps", type=int, default=None, help="steps an epoch (default: all)")
    p.add_argument("--device", default=None, help="cpu, or a card (default: the rank's)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """``hvd.init``, ``train`` and ``hvd.shutdown``; returns ``train``'s."""
    args = parse_args(argv)
    import horovod_tpu_torch as hvd

    hvd.init(device=args.device)
    try:
        return train(args)
    finally:
        hvd.shutdown()


def train(args: argparse.Namespace) -> dict:
    """Trains on the initialised world; returns this rank's step losses,
    the epochs' last losses, the accuracy (rank 0), the seconds the steps
    took (ending in a synchronisation), and the initial and final
    ``state_dict`` in host memory."""
    import horovod_tpu_torch as hvd
    from .models.mnist import MnistCNN
    from .parallel.train import softmax_xent

    dev = hvd.device()
    x, y = synthetic_mnist()
    x, y = x[hvd.rank()::hvd.size()], y[hvd.rank()::hvd.size()]
    model = MnistCNN(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    initial = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                    lr=args.lr * hvd.size()))
    xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    steps = len(x) // args.batch_size
    if args.steps is not None:
        steps = min(steps, args.steps)
    losses, epoch_losses = [], []
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        perm = torch.from_numpy(np.random.RandomState(epoch).permutation(len(x))).to(dev)
        for i in range(steps):
            idx = perm[i * args.batch_size:(i + 1) * args.batch_size]
            opt.zero_grad(set_to_none=True)
            loss = softmax_xent(model(xs[idx]), ys[idx])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        epoch_losses.append(float(losses[-1]))
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={epoch_losses[-1]:.4f}", flush=True)
    seconds = time.perf_counter() - t0
    accuracy = None
    if hvd.rank() == 0:
        with torch.no_grad():
            pred = model(xs[:1024]).argmax(-1)
        accuracy = float((pred == ys[:1024]).float().mean())
        print(f"train accuracy (first 1024): {accuracy:.3f}", flush=True)
    return {"losses": [float(v) for v in losses], "epoch_losses": epoch_losses,
            "accuracy": accuracy, "seconds": seconds, "initial": initial,
            "final": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}


if __name__ == "__main__":
    main()
