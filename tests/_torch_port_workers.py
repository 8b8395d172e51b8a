"""Rank bodies for tests/test_torch_port_distributed.py,
tests/test_torch_port_resnet.py, tests/test_torch_port_collectives.py and
tests/test_torch_port_bert.py, in a module of their own so spawned ranks
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


REDUCE_OPS = ("SUM", "AVERAGE", "MIN", "MAX")


def collective_inputs(rank: int, size: int) -> dict:
    """Each rank's numpy inputs to the collectives, which the tests feed to
    the JAX package too. The allgather inputs have rank + 1 rows (the
    uint8 one 2 + rank elements), the alltoall input sends rank + 1 rows to
    each peer, the reducescatter input has one row past size * 2."""
    rng = np.random.RandomState(100 + rank)
    return {
        "ag_f32": (np.arange((rank + 1) * 2, dtype=np.float32).reshape(rank + 1, 2)
                   + 10 * rank),
        "ag_u8": np.full(2 + rank, rank, np.uint8),
        "ag_bool": (np.arange((rank + 1) * 3) % (rank + 2) == 0).reshape(rank + 1, 3),
        "a2a": (np.arange(size * (rank + 1) * 2, dtype=np.float32)
                .reshape(size * (rank + 1), 2) + 100 * rank),
        "a2a_even": (np.arange(size * 2 * 3, dtype=np.float32).reshape(size * 2, 3)
                     + 100 * rank),
        "even": rng.randn(size * 2, 3).astype(np.float32),
        "rs": rng.randn(size * 2 + 1, 3).astype(np.float32),
        "bcast": np.full(3, rank * 10, np.float32),
    }


def collective_object(rank: int) -> dict:
    return {"rank": rank, "items": list(range(rank + 1)), "name": f"r{rank}"}


def _error(fn) -> str:
    """The message of the exception ``fn`` raises, prefixed by its type."""
    try:
        fn()
    except Exception as e:  # the tests read which error it was
        return f"{type(e).__name__}: {e}"
    return "no error"


def _run_collectives(rank: int, size: int) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    inp = {k: torch.from_numpy(v) for k, v in collective_inputs(rank, size).items()}
    out = {}
    for key in ("ag_f32", "ag_u8", "ag_bool", "even"):
        out[key] = hvd.allgather(inp[key], name=key).numpy()
        h = hvd.allgather_async(inp[key], name=key)
        out[f"{key}_async"] = hvd.synchronize(h).numpy()
    out["ag_scalar"] = hvd.allgather(torch.tensor(float(rank))).numpy()
    got, splits = hvd.alltoall(inp["a2a"], splits=[rank + 1] * size)
    out["a2a"], out["a2a_splits"] = got.numpy(), splits
    got, splits = hvd.synchronize(hvd.alltoall_async(inp["a2a"], [rank + 1] * size))
    out["a2a_async"], out["a2a_async_splits"] = got.numpy(), splits
    got, splits = hvd.alltoall(inp["a2a_even"])
    out["a2a_even"], out["a2a_even_splits"] = got.numpy(), splits
    for root in range(size):
        out[f"bcast_{root}"] = hvd.broadcast(inp["bcast"], root_rank=root).numpy()
        h = hvd.broadcast_async(inp["bcast"], root_rank=root)
        out[f"bcast_{root}_async"] = hvd.synchronize(h).numpy()
        out[f"object_{root}"] = hvd.broadcast_object(
            collective_object(rank) if rank == root else None, root_rank=root)
    out["allgather_object"] = hvd.allgather_object(collective_object(rank))
    for op in REDUCE_OPS:
        rop = getattr(hvd.ReduceOp, op)
        out[f"rs_{op}"] = hvd.reducescatter(inp["rs"], op=rop).numpy()
        out[f"even_rs_{op}"] = hvd.reducescatter(inp["even"], op=rop).numpy()
    out["rs_default"] = hvd.reducescatter(inp["rs"]).numpy()
    h = hvd.allreduce_async(inp["even"], average=False, name="grads")
    while not hvd.poll(h):
        pass
    out["allreduce_async_sum"] = hvd.synchronize(h).numpy()
    out["allreduce_sum"] = hvd.allreduce(inp["even"], average=False).numpy()
    out["allreduce_avg"] = hvd.allreduce(inp["even"], average=True).numpy()
    out["conflict"] = _error(lambda: hvd.allreduce(inp["even"], average=True,
                                                   op=hvd.Sum))
    out["handle_twice"] = _error(lambda: hvd.synchronize(h))
    # Trailing dims, then dtypes, that differ between ranks: every rank
    # raises, none hangs, and the group stays usable.
    out["trailing_mismatch"] = _error(lambda: hvd.allgather(
        torch.zeros(2, 3 + rank), name="bad"))
    out["dtype_mismatch"] = _error(lambda: hvd.allgather(
        torch.zeros(2, 3, dtype=torch.float32 if rank == 0 else torch.float64)))
    out["after_errors"] = hvd.allreduce(torch.ones(1), average=False).numpy()
    hvd.barrier()
    return out


def collectives_worker(rank: int, size: int, init_file: str, queue) -> None:
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu", init_method=f"file://{init_file}")
        try:
            queue.put((rank, _run_collectives(rank, size)))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def bert_batch(batch: int, seq: int):
    """Seeded ids and a key padding mask: sequence b attends to its first
    L_b tokens, L_b uniform in [seq // 2, seq] from numpy seed 42."""
    rng = np.random.RandomState(42)
    lengths = rng.randint(seq // 2, seq + 1, size=batch)
    ids = np.random.RandomState(0).randint(0, 30522, size=(batch, seq)).astype(np.int32)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    return ids, mask


def _bert_value_and_grads(hvd, model, ids, mask, compression=None):
    """distributed_value_and_grad and DistributedGradientTape of the LM
    loss of ``model`` with respect to its parameters, as numpy."""
    import torch
    from torch.func import functional_call

    from horovod_tpu_torch.parallel.train import lm_loss

    def fun(p, x, m):
        return lm_loss(functional_call(model, p, (x, m)), x)

    params = dict(model.named_parameters())
    x, m = torch.from_numpy(ids), torch.from_numpy(mask)
    out = {}
    vag = hvd.distributed_value_and_grad(fun, compression=compression)
    tape = hvd.DistributedGradientTape(fun, compression=compression)
    for name, (val, grads) in (("vag", vag(params, x, m)),
                               ("tape", tape.gradient(params, x, m))):
        out[f"{name}_value"] = val.numpy().copy()
        out[f"{name}_grads"] = {k: g.numpy().copy() for k, g in grads.items()}
    return out


def make_bert_tiny(params, attn_impl: str):
    """The port's f32 bert-tiny carrying the flax ``params``."""
    import dataclasses

    import torch

    from horovod_tpu_torch.models.convert import bert_flax_to_torch
    from horovod_tpu_torch.models.transformer import BERT_CONFIGS, TransformerEncoder

    cfg = dataclasses.replace(BERT_CONFIGS["bert-tiny"], dtype=torch.float32,
                              attn_impl=attn_impl)
    model = TransformerEncoder(cfg, device="cpu")
    model.load_state_dict(bert_flax_to_torch(params, cfg))
    return model


def _run_bert(rank: int, size: int, params, ids, mask, attn_impl) -> dict:
    """This rank's slice of the batch through the gradient transforms, and
    one compressed DistributedOptimizer gradient sync on the regression
    problem."""
    import torch

    import horovod_tpu_torch as hvd

    per = ids.shape[0] // size
    rows = slice(rank * per, (rank + 1) * per)
    model = make_bert_tiny(params, attn_impl)
    out = _bert_value_and_grads(hvd, model, ids[rows], mask[rows])

    w0, xs, ys = linreg_data(size)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   compression=hvd.Compression.fp16)
    xr = torch.from_numpy(xs[rank * 4:(rank + 1) * 4])
    yr = torch.from_numpy(ys[rank * 4:(rank + 1) * 4])
    ((xr @ w - yr) ** 2).mean().backward()
    out["local_grad"] = w.grad.numpy().copy()
    opt.step()
    # step() leaves the all-reduced, decompressed gradient in .grad.
    out["reduced_grad"] = w.grad.numpy().copy()
    out["fp16_sgd"] = w.detach().numpy().copy()
    hvd.barrier()
    return out


def bert_worker(rank: int, size: int, init_file: str, queue, params, ids, mask,
                attn_impl) -> None:
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu", init_method=f"file://{init_file}")
        try:
            queue.put((rank, _run_bert(rank, size, params, ids, mask, attn_impl)))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))
