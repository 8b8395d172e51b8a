"""Synthetic image benchmark (counterpart of
``examples/jax_synthetic_benchmark.py``, the reference's headline tool;
the same flags, printing ``Img/sec per chip`` and ``Total img/sec``).

    torchrun --nproc-per-node 4 -m horovod_tpu_torch.train_synthetic --model vit-l16
    python -m horovod_tpu_torch.train_synthetic --model resnet50 --batch-size 64

Any image model of the registry (ResNets, ViTs, the MNIST nets), trained
over ``create_mesh({"dp": n})`` with one process per card: the model from
torch seed 0, ``make_train_step`` with SGD(0.01, momentum 0.9) and
``softmax_xent``, the gradients averaged over dp. The global batch is
``--batch-size`` (per card) times n: the registry's seeded images and
labels from ``RandomState(0)`` in [0, 1000), as the JAX script draws them,
taken modulo the model's classes where it has fewer (JAX's one-hot would
give a label past them no term of the loss; the port's loss refuses it).
After the warm-up batches, each of ``--num-iters`` iterations times
``--num-batches-per-iter`` steps on the host clock, ending in a
synchronisation. An entry point, not the port's benchmark. ``--device
cpu`` runs on gloo.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batch-size", type=int, default=32, help="per-card batch size")
    p.add_argument("--num-warmup-batches", type=int, default=3)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=3)
    p.add_argument("--device", default=None, help="cpu, or a card (default: the rank's)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Runs the benchmark; returns the iterations' images/s per card."""
    args = parse_args(argv)
    import horovod_tpu_torch as hvd
    from .models.registry import get_model
    from .parallel.train import make_train_step, softmax_xent

    hvd.init(device=args.device)
    try:
        n = hvd.size()
        mesh = hvd.create_mesh({"dp": n})
        spec = get_model(args.model)
        if spec.kind != "image":
            raise ValueError(f"--model {args.model}: an image model is needed")
        dev = hvd.device()
        model = spec.make_model(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        global_batch = args.batch_size * n
        images = torch.from_numpy(spec.make_batch(global_batch)[0]).to(dev)
        with torch.no_grad():
            classes = model.eval()(images[:1]).shape[-1]
        labels = torch.from_numpy(
            np.random.RandomState(0).randint(0, 1000, (global_batch,), dtype=np.int32)
            % classes).to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        init_fn, step_fn = make_train_step(model, opt, softmax_xent, mesh=mesh)
        state = init_fn()

        def run_batches(state, k):
            for _ in range(k):
                state, loss = step_fn(state, images, labels)
            float(loss)     # waits for the last step
            return state

        state = run_batches(state, args.num_warmup_batches)
        img_secs = []
        for i in range(args.num_iters):
            t0 = time.perf_counter()
            state = run_batches(state, args.num_batches_per_iter)
            ips = global_batch * args.num_batches_per_iter / (time.perf_counter() - t0)
            img_secs.append(ips / n)
            if hvd.rank() == 0:
                print(f"Iter #{i}: {ips:.1f} img/sec total", flush=True)
        if hvd.rank() == 0:
            mean, std = np.mean(img_secs), 1.96 * np.std(img_secs)
            print(f"Img/sec per chip: {mean:.1f} +-{std:.1f}")
            print(f"Total img/sec on {n} chip(s): {mean * n:.1f} +-{std * n:.1f}", flush=True)
        return img_secs
    finally:
        hvd.shutdown()


if __name__ == "__main__":
    main()
