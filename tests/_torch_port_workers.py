"""Rank bodies for tests/test_torch_port_distributed.py,
tests/test_torch_port_resnet.py, tests/test_torch_port_collectives.py,
tests/test_torch_port_bert.py, tests/test_torch_port_{zero,adasum,
sync_bn,overlap}.py, tests/test_torch_port_{sp,moe,mesh,pipeline,tp,tp_sp}.py,
tests/test_torch_port_{zero_mesh,fsdp}.py, tests/test_torch_port_{vit,
mnist}.py, tests/test_torch_port_{pp_tp,pp_sp}.py and
tests/test_torch_port_{engine,binding}.py, in a
module of their own so spawned ranks import torch and horovod_tpu_torch
only (no jax, no test module). Each rank returns a dict of numpy arrays
through a queue; ``spawn_world`` runs a named body on a world of gloo
ranks."""
from __future__ import annotations

import contextlib
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
    out["rs_product"] = _error(lambda: hvd.reducescatter(inp["rs"], op=hvd.Product))
    _run_product(hvd, torch, inp["even"], out)
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


# PRODUCT's cases (key -> prescale, postscale), each held against the JAX
# traced all-reduce.
PRODUCT_SCALES = {"prod": (1.0, 1.0), "prod_scaled": (0.5, 3.0)}


def _run_product(hvd, torch, x, out: dict) -> None:
    """PRODUCT through the all-reduce, its async form, the grouped
    all-reduce and ``DistributedOptimizer`` (SGD(1.0) from zeros: the step
    is minus the reduced gradient)."""
    for key, (pre, post) in PRODUCT_SCALES.items():
        out[key] = hvd.allreduce(x, op=hvd.Product, prescale_factor=pre,
                                 postscale_factor=post).numpy()
    out["prod_async"] = hvd.synchronize(hvd.allreduce_async(
        x, op=hvd.Product, prescale_factor=2.0)).numpy()
    group = hvd.grouped_allreduce([x, 2 * x[:1]], op=hvd.Product)
    out["prod_grouped_0"], out["prod_grouped_1"] = (t.numpy() for t in group)
    w = torch.nn.Parameter(torch.zeros_like(x))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0), op=hvd.Product)
    w.grad = x.clone()
    opt.step()
    out["prod_opt"] = (-w.detach()).numpy()


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


# ---------------------------------------------------------------------------
# A world of gloo ranks running one named body.
def rank_main(rank: int, size: int, init_file: str, queue, body: str, args,
              env) -> None:
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    os.environ.update(env or {})
    try:
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu", init_method=f"file://{init_file}")
        try:
            queue.put((rank, globals()[body](rank, size, *args)))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def spawn_world(size: int, tmp_dir, body: str, *args, env=None, timeout=240) -> list:
    """Each rank's result of ``body(rank, size, *args)`` on ``size`` spawned
    gloo ranks that meet through a FileStore in ``tmp_dir``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, size, os.path.join(str(tmp_dir), "store"),
                                                 queue, body, args, env))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, res in results.items():
        assert isinstance(res, dict), f"rank {r} failed:\n{res}"
    return [results[r] for r in range(size)]


WIRE_KEYS = ("HOROVOD_WIRE_COMPRESSION", "HOROVOD_WIRE_COMPRESSION_MIN_BYTES",
             "HOROVOD_WIRE_COMPRESSION_INT8")
# The wire lanes: the knobs each sets (min bytes 0: every payload qualifies).
LANES = {
    "none": {},
    "bf16": {"HOROVOD_WIRE_COMPRESSION": "bf16", "HOROVOD_WIRE_COMPRESSION_MIN_BYTES": "0"},
    "fp16": {"HOROVOD_WIRE_COMPRESSION": "fp16", "HOROVOD_WIRE_COMPRESSION_MIN_BYTES": "0"},
    "int8": {"HOROVOD_WIRE_COMPRESSION": "bf16", "HOROVOD_WIRE_COMPRESSION_MIN_BYTES": "0",
             "HOROVOD_WIRE_COMPRESSION_INT8": "1"},
}


def set_lane(lane: str) -> None:
    for key in WIRE_KEYS:
        os.environ.pop(key, None)
    os.environ.update(LANES[lane])


@contextlib.contextmanager
def lane_env(lane: str):
    """The knobs of ``lane`` while the block runs; the caller's after."""
    saved = {k: os.environ.get(k) for k in WIRE_KEYS}
    set_lane(lane)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# ZeRO (tests/test_torch_port_zero.py)
ZERO_LR, ZERO_WD, ZERO_EPS = 1e-3, 1e-2, 1e-8
ZERO_SGD_LR = 1e-2
ZERO_KEYS = ("b", "w")     # the JAX params dict's leaf order


def zero_params() -> dict:
    rng = np.random.RandomState(0)
    return {"b": rng.randn(53).astype(np.float32), "w": rng.randn(31, 7).astype(np.float32)}


def zero_grads(size: int, steps: int, seed: int = 1, exact_sums: bool = True) -> list:
    """Per step, each leaf's gradients stacked over the ranks. Past two
    ranks, with ``exact_sums``, they are multiples of 1/8, whose bf16 sums
    are exact in any order: gloo rounds each partial sum to bf16, XLA's CPU
    psum adds in f32 and rounds once, and at two ranks the two agree (one
    addition)."""
    rng = np.random.RandomState(seed)
    out = [{k: rng.randn(size, *v.shape).astype(np.float32)
            for k, v in zero_params().items()} for _ in range(steps)]
    if size > 2 and exact_sums:
        out = [{k: np.round(v * 8) / 8 for k, v in g.items()} for g in out]
    return out


def _zero_steps(hvd, params_np, grads, rank, inner="adamw", **kw):
    """AdamW (or SGD) under DistributedOptimizer(**kw) from ``params_np``,
    stepped on this rank's slice of each step's gradients; (params,
    optimizer)."""
    import torch

    load = kw.pop("load", None)
    params = [torch.nn.Parameter(torch.from_numpy(params_np[k].copy())) for k in ZERO_KEYS]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=ZERO_SGD_LR) if inner == "sgd" else
        torch.optim.AdamW(params, lr=ZERO_LR, weight_decay=ZERO_WD, eps=ZERO_EPS), **kw)
    if load is not None:
        opt.load_shard_state(load)
    for g in grads:
        for p, k in zip(params, ZERO_KEYS):
            p.grad = torch.from_numpy(g[k][rank].copy())
        opt.step()
    return [p.detach().numpy().copy() for p in params], opt


def _ef_drift(hvd, steps: int = 150, d: int = 256, **kw) -> float:
    """Largest drift from the exact sum after ``steps`` SGD(1.0) steps of a
    constant gradient bf16 cannot represent, on the bf16 lane (as
    tests/test_zero.py::_accumulate)."""
    import torch

    set_lane("bf16")
    gval = 1.0 + 1.0 / 300.0
    w = torch.nn.Parameter(torch.zeros(d))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0), _schedule="grouped", **kw)
    for _ in range(steps):
        w.grad = torch.full((d,), gval)
        opt.step()
    set_lane("none")
    return float((w.detach() + steps * gval).abs().max())


def _run_zero(rank: int, size: int, cases, fresh_grads) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    out = {}
    for case in cases:
        inner = case.get("inner", "adamw")
        for lane in dict.fromkeys((case["lane"], "none")):
            # Each case on its lane; a lossy one also at full width from the
            # same start, which it must differ from.
            set_lane(lane)
            for stage in (1, 2) if lane == case["lane"] else (1,):
                tag = f"{case['lane']}_ef{int(case['ef'])}_z{stage}"
                if lane != case["lane"]:
                    tag = f"{case['lane']}_ef{int(case['ef'])}_fullwidth"
                params, opt = _zero_steps(hvd, case["params"], case["grads"], rank, inner,
                                          zero=stage, error_feedback=case["ef"],
                                          load=case["shards"][rank])
                out[f"{inner}_{tag}"] = params
                out[f"{inner}_{tag}_bytes"] = opt.state_bytes()
    set_lane("none")
    # ZeRO without a codec against the replicated optimizer, from fresh state.
    p0 = zero_params()
    out["fresh_zero"], opt = _zero_steps(hvd, p0, fresh_grads, rank, zero=1)
    out["fresh_zero_bytes"] = opt.state_bytes()
    out["fresh_replicated"], rep = _zero_steps(hvd, p0, fresh_grads, rank)
    out["replicated_bytes"] = rep.state_bytes()
    _, opt_ef = _zero_steps(hvd, p0, fresh_grads, rank, zero=2, error_feedback=True)
    out["fresh_zero_ef_bytes"] = opt_ef.state_bytes()
    out["drift"] = {name: _ef_drift(hvd, **kw) for name, kw in (
        ("stateless", {}), ("ef0", {"error_feedback": True}),
        ("zero1_ef", {"zero": 1, "error_feedback": True}))}
    # The stacked form, re-cut n -> m -> n, and one rank's shard out of it.
    glob = hvd.zero.state_to_global(opt)
    other = 3 if size != 3 else 2
    back = hvd.zero.recut_state(hvd.zero.recut_state(glob, other), size)
    out["global"] = {k: v.numpy() for k, v in glob["groups"][0].items()}
    out["recut_back"] = {k: v.numpy() for k, v in back["groups"][0].items()}
    out["recut_other"] = {k: v.numpy() for k, v in
                          hvd.zero.recut_state(glob, other)["groups"][0].items()}
    mine = hvd.zero.state_from_global(glob, rank)["groups"][0]
    own = opt.shard_state()["groups"][0]
    out["from_global_matches"] = sorted(mine) == sorted(own) and all(
        torch.equal(mine[k].cpu().reshape(-1), own[k].cpu().reshape(-1)) for k in own)
    out["status"] = hvd.zero.status_snapshot()
    hvd.barrier()
    return out


# ---------------------------------------------------------------------------
# Adasum (tests/test_torch_port_adasum.py)
ADASUM_SHAPES = {"a": (5, 3), "b": (7,)}


def adasum_inputs(size: int):
    """Per-rank vectors (one a scaled copy of another, so the projection
    terms matter) and per-rank gradient dicts."""
    rng = np.random.RandomState(11)
    vecs = rng.randn(size, 33).astype(np.float32)
    vecs[1] = 0.5 * vecs[0] + 0.1 * vecs[1]
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in ADASUM_SHAPES.items()}
             for _ in range(size)]
    return vecs, grads


def _run_adasum(rank: int, size: int) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    vecs, grads = adasum_inputs(size)
    x = torch.from_numpy(vecs[rank])
    out = {"allreduce": hvd.allreduce(x, op=hvd.Adasum).numpy(),
           "adasum_allreduce": hvd.adasum_allreduce(x).numpy(),
           "input_kept": torch.equal(x, torch.from_numpy(vecs[rank]))}
    for fuse in (True, False, None):     # None: the default
        params = [torch.nn.Parameter(torch.zeros(s)) for s in ADASUM_SHAPES.values()]
        kw = {} if fuse is None else {"fuse": fuse}
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=1.0), op=hvd.Adasum, **kw)
        for p, k in zip(params, ADASUM_SHAPES):
            p.grad = torch.from_numpy(grads[rank][k].copy())
        opt.step()
        key = "opt_default" if fuse is None else f"opt_fuse{int(fuse)}"
        out[key] = [(-p.detach()).numpy() for p in params]
    hvd.barrier()
    return out


# ---------------------------------------------------------------------------
# SyncBatchNorm (tests/test_torch_port_sync_bn.py)
SBN_N, SBN_C, SBN_HW, SBN_ITERS = 8, 3, 4, 2


def sync_bn_inputs():
    rng = np.random.RandomState(21)
    xs = (rng.randn(SBN_ITERS, SBN_N, SBN_C, SBN_HW, SBN_HW) * 2 + 0.5).astype(np.float32)
    coeff = rng.randn(SBN_ITERS, SBN_N, SBN_C, SBN_HW, SBN_HW).astype(np.float32)
    weight = (1 + 0.1 * rng.randn(SBN_C)).astype(np.float32)
    bias = (0.1 * rng.randn(SBN_C)).astype(np.float32)
    nhwc = rng.randn(SBN_N, SBN_HW, SBN_HW, SBN_C).astype(np.float32)
    return xs, coeff, weight, bias, nhwc


def _run_sync_bn(rank: int, size: int) -> dict:
    """SyncBatchNorm on this rank's slice against nn.BatchNorm2d over the
    whole batch, which each rank computes itself."""
    import torch

    import horovod_tpu_torch as hvd

    xs, coeff, weight, bias, nhwc = sync_bn_inputs()
    per = SBN_N // size
    rows = slice(rank * per, (rank + 1) * per)
    sbn, ref = hvd.SyncBatchNorm(SBN_C), torch.nn.BatchNorm2d(SBN_C)
    for m in (sbn, ref):
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(weight))
            m.bias.copy_(torch.from_numpy(bias))
    out = {}
    for it in range(SBN_ITERS):
        for m in (sbn, ref):
            m.zero_grad()
        x = torch.from_numpy(xs[it][rows].copy()).requires_grad_(True)
        y = sbn(x)
        (y * torch.from_numpy(coeff[it][rows])).sum().backward()
        xf = torch.from_numpy(xs[it].copy()).requires_grad_(True)
        yf = ref(xf)
        (yf * torch.from_numpy(coeff[it])).sum().backward()
        out[f"y{it}"], out[f"y{it}_ref"] = y.detach().numpy(), yf.detach()[rows].numpy()
        out[f"dx{it}"], out[f"dx{it}_ref"] = x.grad.numpy(), xf.grad[rows].numpy()
        for name in ("weight", "bias"):
            g = hvd.allreduce(getattr(sbn, name).grad, op=hvd.Sum)
            out[f"d{name}{it}"] = g.numpy()
            out[f"d{name}{it}_ref"] = getattr(ref, name).grad.numpy()
    for name in ("running_mean", "running_var"):
        out[name], out[f"{name}_ref"] = (getattr(sbn, name).numpy(),
                                         getattr(ref, name).numpy())
    sbn.eval()
    ref.eval()
    x = torch.from_numpy(xs[0][rows].copy())
    out["eval"], out["eval_ref"] = sbn(x).detach().numpy(), ref(x).detach().numpy()
    mean, var = hvd.sync_batch_stats(torch.from_numpy(nhwc[rows].copy()))
    out["stats_mean"], out["stats_var"] = mean.numpy(), var.numpy()
    hvd.barrier()
    return out


# ---------------------------------------------------------------------------
# The overlapped all-reduce, the wire casts, the header checks
# (tests/test_torch_port_overlap.py)
OVERLAP_CASES = {"plain": (None, 1), "fp16_bpps2": ("fp16", 2)}
OVERLAP_STEPS = 3
# How DistributedOptimizer reduces: overlapped (hooks), after backward in
# the same buckets, after backward in one grouped all-reduce; and ZeRO-1.
OVERLAP_RUNS = {"hooks": {"_schedule": "hooks"}, "buckets": {"_schedule": "buckets"},
                "grouped": {"_schedule": "grouped"}, "zero1": {"zero": 1}}


def wire_inputs(size: int):
    rng = np.random.RandomState(31)
    return rng.randn(size, 300).astype(np.float32), rng.randn(size, 41).astype(np.float32)


def _overlap_net(torch):
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            # Registered first, so the last buckets wait for step(): one
            # parameter no rank uses, and a layer only rank 0 uses (an MoE
            # expert that gets no tokens on rank 1).
            self.unused = torch.nn.Parameter(torch.ones(5))
            self.rank0_only = torch.nn.Linear(8, 4)
            self.fc1 = torch.nn.Linear(8, 32)
            self.fc2 = torch.nn.Linear(32, 32)
            self.fc3 = torch.nn.Linear(32, 4)

        def forward(self, x, rank):
            y = self.fc3(torch.relu(self.fc2(torch.relu(self.fc1(x)))))
            return y + self.rank0_only(x) if rank == 0 else y

    torch.manual_seed(0)
    return Net()


def _train_overlap(hvd, rank, compression, k, run):
    import torch

    net = _overlap_net(torch)
    if compression and run == "zero1":   # ZeRO's wire cast is the env knob's
        return None
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(net.parameters(), lr=1e-2),
        compression=getattr(hvd.Compression, compression) if compression else None,
        backward_passes_per_step=k, **OVERLAP_RUNS[run])
    rng = np.random.RandomState(41 + rank)
    for _ in range(OVERLAP_STEPS * k):
        x = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
        y = torch.from_numpy(rng.randn(6, 4).astype(np.float32))
        opt.zero_grad()
        ((net(x, rank) - y) ** 2).mean().backward()
        opt.step()
    out = {name: p.detach().numpy().copy() for name, p in net.named_parameters()}
    out["grads"] = {name: None if p.grad is None else p.grad.numpy().copy()
                    for name, p in net.named_parameters()}
    out["buckets"] = len(opt._buckets) if opt._buckets is not None else 0
    return out


def _mismatches(hvd, rank: int) -> dict:
    import torch

    z = torch.zeros
    cases = {
        "shape": lambda: hvd.allreduce(z(2 + rank), name="grads"),
        "shape_async": lambda: hvd.synchronize(hvd.allreduce_async(z(2 + rank))),
        "dtype": lambda: hvd.allreduce(z(2, dtype=torch.float32 if rank == 0
                                         else torch.float64)),
        "op": lambda: hvd.allreduce(z(2), op=hvd.Sum if rank == 0 else hvd.Max),
        "prescale": lambda: hvd.allreduce(z(2), prescale_factor=1.0 + rank),
        "postscale": lambda: hvd.allreduce(z(2), postscale_factor=0.5 * (1 + rank)),
        "grouped": lambda: hvd.grouped_allreduce([z(2 + rank), z(3 - rank)]),
        "grouped_shape": lambda: hvd.grouped_allreduce([z(2), z(3 + rank)]),
        "root": lambda: hvd.broadcast(z(2), root_rank=rank),
        "root_async": lambda: hvd.synchronize(hvd.broadcast_async(z(2), root_rank=rank)),
        "broadcast_shape": lambda: hvd.ops.broadcast_(z(2 + rank), root_rank=0),
        "collective": lambda: (hvd.allreduce(z(2)) if rank == 0
                               else hvd.broadcast(z(2), root_rank=0)),
    }
    out = {name: _error(fn) for name, fn in cases.items()}
    w = torch.nn.Parameter(z(3 + rank))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0))
    w.grad = z(3 + rank)
    out["optimizer"] = _error(opt.step)
    out["after_errors"] = hvd.allreduce(torch.ones(1), op=hvd.Sum).numpy()
    return out


def _transform_headers(hvd, rank: int) -> dict:
    """How many header exchanges the gradient transforms make: once on
    their first call, again only when the gradients' signature changes."""
    import torch

    calls = []
    exchange = hvd.ops._exchange_header

    def counted(*args, **kw):
        calls.append(args[0])
        return exchange(*args, **kw)

    def loss(params, x):
        return (params["w"] * x).sum() + params["b"].sum()

    params = {"w": torch.ones(3), "b": torch.zeros(2)}
    x = torch.full((3,), float(rank + 1))
    hvd.ops._exchange_header = counted
    try:
        vg = hvd.distributed_value_and_grad(loss)
        tape = hvd.DistributedGradientTape(loss)
        grads = [vg(params, x)[1] for _ in range(3)]
        grads += [tape.gradient(params, x)[1] for _ in range(3)]
        steady = list(calls)
        vg({"w": torch.ones(4), "b": torch.zeros(2)}, torch.ones(4))
    finally:
        hvd.ops._exchange_header = exchange
    return {"steady": steady, "after_change": calls[len(steady):],
            "w_grad": [g["w"].numpy() for g in grads]}


def _run_overlap(rank: int, size: int) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    out = {}
    for case, (compression, k) in OVERLAP_CASES.items():
        for run in OVERLAP_RUNS:
            out[f"{case}_{run}"] = _train_overlap(hvd, rank, compression, k, run)
    out["transform_headers"] = _transform_headers(hvd, rank)
    big, small = wire_inputs(size)
    for lane in LANES:
        set_lane(lane)
        x, s = torch.from_numpy(big[rank]), torch.from_numpy(small[rank])
        out[f"wire_{lane}_sum"] = hvd.allreduce(x, op=hvd.Sum).numpy()
        out[f"wire_{lane}_avg"] = hvd.allreduce(x).numpy()
        # Named by lane: a cached response replays the codec it was
        # negotiated with (the engine's response cache).
        out[f"wire_{lane}_grouped"] = [t.numpy() for t in hvd.grouped_allreduce(
            [x, s], name=f"wire_{lane}")]
    set_lane("none")
    out.update(_mismatches(hvd, rank))
    hvd.barrier()
    return out


# ---------------------------------------------------------------------------
# Sequence and expert parallelism, the mesh and wrap_step
# (tests/test_torch_port_{sp,moe,mesh}.py)
SP_B, SP_S, SP_H, SP_D = 2, 32, 4, 8
SP_IMPLS = ("ring", "ulysses", "ulysses_flash")


def sp_inputs():
    """q, k, v, the output cotangent (B, S, H, D) and a padding mask with
    ragged lengths S-2 and S/2: at sp=4 the second row's last two blocks
    are all padding."""
    rng = np.random.RandomState(0)
    q, k, v, cot = (rng.randn(SP_B, SP_S, SP_H, SP_D).astype(np.float32) for _ in range(4))
    mask = np.zeros((SP_B, SP_S), np.float32)
    for b, length in enumerate([SP_S - 2, SP_S // 2]):
        mask[b, :length] = 1.0
    return q, k, v, cot, mask


def _block(a, rank: int, n: int, dim: int = 1):
    per = a.shape[dim] // n
    return np.take(a, np.arange(rank * per, (rank + 1) * per), axis=dim)


def _run_sp_attention(rank: int, size: int, cases, bf16_cases=()) -> dict:
    """o and dq, dk, dv of each (impl, causal, masked) case on this rank's
    sequence block, at sp=size; then each ``bf16_cases`` case of the ring
    on the same draws rounded to bf16 (key ``ring-bf16-<causal>``)."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd

    hvd.create_mesh({"sp": size})
    q, k, v, cot, mask = (torch.from_numpy(_block(a, rank, size)) for a in sp_inputs())
    out = {}
    for impl, causal, masked in cases:
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        m = mask if masked else None
        if impl == "ring":
            o = hvd.ring_attention(*qkv, "sp", causal=causal, mask=m)
        else:
            o = hvd.ulysses_attention(*qkv, "sp", causal=causal, mask=m,
                                      use_flash=impl == "ulysses_flash")
        (o * cot).sum().backward()
        out[f"{impl}-{causal}-{masked}"] = [o.detach().numpy()] + [
            t.grad.numpy() for t in qkv]
    for causal in bf16_cases:
        qkv = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
        o = hvd.ring_attention(*qkv, "sp", causal=causal)
        o.backward(cot.to(torch.bfloat16))
        out[f"ring-bf16-{causal}"] = [o.detach().float().numpy()] + [
            t.grad.float().numpy() for t in qkv]
    return out


SP_MODEL_B, SP_MODEL_S = 4, 64          # bert-tiny under Ulysses-flash
SP_TRAIN_B, SP_TRAIN_S = 4, 32          # gpt2-tiny trained under sp
SP_LR, SP_WD, SP_EPS, SP_STEPS = 1e-4, 1e-4, 1e-8, 3


def sp_bert_batch():
    ids = np.random.RandomState(0).randint(0, 1000, (SP_MODEL_B, SP_MODEL_S)).astype(np.int32)
    mask = np.ones((SP_MODEL_B, SP_MODEL_S), np.float32)
    mask[0, 40:] = 0.0
    return ids, mask


def sp_train_ids():
    return np.random.RandomState(1).randint(0, 1024, (SP_TRAIN_B, SP_TRAIN_S)).astype(np.int32)


def axis_value(rank: int) -> np.ndarray:
    return np.arange(6, dtype=np.float32).reshape(2, 3) * (rank + 1)


def _axis_collectives(hvd, torch, rank: int) -> dict:
    """The collectives over "sp", "dp" and ("dp", "sp") of a dp=2 x sp=2
    mesh on this rank's ``axis_value``."""
    x = torch.from_numpy(axis_value(rank))
    out = {}
    for axes in ("sp", "dp", ("dp", "sp")):
        key = axes if isinstance(axes, str) else "+".join(axes)
        out[f"sum_{key}"] = hvd.allreduce(x, op=hvd.Sum, axis_name=axes).numpy()
        out[f"avg_{key}"] = hvd.allreduce(x, axis_name=axes).numpy()
        out[f"grouped_{key}"] = [t.numpy() for t in hvd.grouped_allreduce(
            [x, x[0] * 2], op=hvd.Sum, axis_name=axes)]
        out[f"gather_{key}"] = hvd.allgather(x[: 1 + rank % 2], axis_name=axes).numpy()
        out[f"bcast_{key}"] = hvd.broadcast(x, root_rank=1, axis_name=axes).numpy()
        n = 2 if isinstance(axes, str) else 4
        rows = torch.arange(n * 2, dtype=torch.float32) + 10 * rank
        out[f"alltoall_{key}"] = hvd.alltoall(rows, axis_name=axes)[0].numpy()
        out[f"rs_{key}"] = hvd.reducescatter(rows, axis_name=axes).numpy()
    return out


def _run_sp_world(rank: int, size: int, bert_params, gpt_params, attns) -> dict:
    """On dp=2 x sp=2: bert-tiny under Ulysses-flash (this rank's logits
    block), gpt2-tiny trained 3 steps under each of ``attns`` with
    shard_seq (losses, parameters), and the axis collectives."""
    import dataclasses

    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import bert_flax_to_torch, flax_to_torch
    from horovod_tpu_torch.models.transformer import (BERT_CONFIGS, GPT2_CONFIGS,
                                                      TransformerEncoder, TransformerLM)
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    mesh = hvd.create_mesh({"dp": 2, "sp": 2})
    out = {"coords": np.array([mesh.coords["dp"], mesh.coords["sp"]])}

    def cut(a):
        return torch.from_numpy(_block(_block(a, mesh.coords["dp"], 2, 0),
                                       mesh.coords["sp"], 2, 1))

    cfg = dataclasses.replace(BERT_CONFIGS["bert-tiny"], max_len=64, n_layers=1,
                              n_heads=4, dtype=torch.float32, attn_impl="ulysses",
                              sp_use_flash=True)
    model = TransformerEncoder(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(bert_flax_to_torch(bert_params, cfg))
    ids, mask = sp_bert_batch()
    with torch.no_grad():
        out["bert_logits"] = model(cut(ids), cut(mask)).numpy()

    ids = torch.from_numpy(sp_train_ids())
    for attn in attns:
        cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32,
                                  attn_impl=attn)
        model = TransformerLM(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(flax_to_torch(gpt_params, cfg))
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=SP_LR, weight_decay=SP_WD, eps=SP_EPS),
            axis_name=("dp", "sp"))
        init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh, shard_seq=True)
        state = init_fn()
        losses = []
        for _ in range(SP_STEPS):
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
        out[f"train_{attn}"] = {"losses": np.array(losses),
                                **{k: v.detach().numpy().copy()
                                   for k, v in model.state_dict().items()}}
    out.update(_axis_collectives(hvd, torch, rank))
    return out


MOE_B, MOE_S, MOE_E, MOE_AUX = 4, 32, 4, 0.01
# (name, mesh, capacity_factor, attn_impl, shard_seq)
MOE_CASES = [("dp2_ep2", {"dp": 2, "ep": 2}, 1.25, "dense", False),
             ("ep2_sp2", {"ep": 2, "sp": 2}, 0.5, "ulysses", True)]


def moe_ids():
    return np.random.RandomState(2).randint(0, 1024, (MOE_B, MOE_S)).astype(np.int32)


def _run_moe_world(rank: int, size: int, params_by_case) -> dict:
    """Each MOE_CASES case on its mesh: gpt2-tiny (f32) with a Switch FFN of
    MOE_E experts in block 1, 3 AdamW steps through make_train_step with
    moe_aux_weight; the losses, the dropped tokens of each step, the
    parameters (this rank's experts) and the mesh coordinates. Also what
    n_experts % ep raises."""
    import dataclasses

    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS, SwitchMoE, TransformerLM
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    ids = torch.from_numpy(moe_ids())
    out = {}
    for (name, shape, cf, attn, shard_seq), params in zip(MOE_CASES, params_by_case):
        mesh = hvd.create_mesh(shape)
        cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32,
                                  n_experts=MOE_E, capacity_factor=cf, attn_impl=attn)
        model = TransformerLM(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(flax_to_torch(params, cfg, ep=mesh.shape["ep"],
                                            ep_rank=mesh.coords["ep"]))
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=SP_LR, weight_decay=SP_WD, eps=SP_EPS),
            axis_name=tuple(a for a in ("dp", "sp") if a in shape))
        init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh,
                                           shard_seq=shard_seq, moe_aux_weight=MOE_AUX)
        state = init_fn()
        losses, dropped = [], []
        for _ in range(SP_STEPS):
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
            dropped.append([int(d) for d in model.moe_dropped()])
        out[name] = {"losses": np.array(losses), "dropped": np.array(dropped),
                     "coords": dict(mesh.coords),
                     "params": {k: v.detach().numpy().copy()
                                for k, v in model.state_dict().items()}}
        if name == "dp2_ep2":
            try:
                SwitchMoE(dataclasses.replace(cfg, n_experts=3), device="cpu", mesh=mesh)
            except ValueError as e:
                out["indivisible"] = str(e)
    return out


WRAP_STEPS, WRAP_LR = 30, 0.3


def wrap_data():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    return x, x @ np.array([1.0, -2.0, 3.0, 0.5], np.float32)


def _run_wrap_step(rank: int, size: int) -> dict:
    """tests/test_parallel.py:174-232 on the port: the gradient semantics
    inside wrap_step, a DistributedOptimizer converging through it, and
    out_replicated=False gathering the ranks' outputs."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd

    out = {}
    X = torch.arange(32, dtype=torch.float32).reshape(32, 1)

    @hvd.wrap_step
    def grad_step(w, xb):
        w = w.clone().requires_grad_(True)
        (xb[:, 0] * w[0]).mean().backward()
        out["local_grad"] = w.grad.numpy().copy()
        return hvd.allreduce(w.grad, op=hvd.Average)

    out["grad"] = grad_step(torch.ones(1), X).numpy()
    x, y = wrap_data()
    w = torch.nn.Parameter(torch.zeros(4))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=WRAP_LR))

    @hvd.wrap_step
    def train_step(w, xb, yb):
        opt.zero_grad()
        ((xb @ w - yb) ** 2).mean().backward()
        opt.step()
        return w

    for _ in range(WRAP_STEPS):
        train_step(w, torch.from_numpy(x), torch.from_numpy(y))
    out["w"] = w.detach().numpy().copy()
    gathered = hvd.wrap_step(lambda xb: xb * 2, replicated_argnums=(),
                             out_replicated=False)(torch.from_numpy(x))
    out["gathered"] = gathered.numpy()
    return out


# ---------------------------------------------------------------------------
# Pipeline parallelism (tests/test_torch_port_pipeline.py).
GPIPE_S, GPIPE_D, GPIPE_DH, GPIPE_B, GPIPE_M = 4, 8, 16, 8, 4     # test_parallel.py:81-104
GRAD_S, GRAD_D, GRAD_DH, GRAD_B, GRAD_M = 2, 4, 8, 8, 4           # test_parallel.py:106-133
GRAD_LR, GRAD_STEPS = 0.1, 10
PLM_B, PLM_S, PLM_M = 8, 16, 4                                      # test_parallel.py:135-172
PLM_LR, PLM_STEPS = 1e-3, 4


def mlp_stage(torch, params, x):
    """tests/test_parallel.py's ``_mlp_stage``: one residual tanh MLP."""
    return x + torch.tanh(x @ params["w1"]) @ params["w2"]


def stage_params(seed: int, n_stages: int, d: int, dh: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(n_stages, d, dh).astype(np.float32) * 0.1,
            "w2": rng.randn(n_stages, dh, d).astype(np.float32) * 0.1}


def gpipe_inputs():
    """test_gpipe_matches_sequential's draws: the stage parameters, then x."""
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(GPIPE_S, GPIPE_D, GPIPE_DH).astype(np.float32) * 0.1,
              "w2": rng.randn(GPIPE_S, GPIPE_DH, GPIPE_D).astype(np.float32) * 0.1}
    return params, rng.randn(GPIPE_B, GPIPE_D).astype(np.float32)


def grad_inputs():
    """test_gpipe_differentiable_and_trains's draws: parameters, x, y."""
    rng = np.random.RandomState(1)
    params = {"w1": rng.randn(GRAD_S, GRAD_D, GRAD_DH).astype(np.float32) * 0.1,
              "w2": rng.randn(GRAD_S, GRAD_DH, GRAD_D).astype(np.float32) * 0.1}
    return (params, rng.randn(GRAD_B, GRAD_D).astype(np.float32),
            rng.randn(GRAD_B, GRAD_D).astype(np.float32))


def plm_ids():
    return np.random.RandomState(0).randint(0, 128, (PLM_B, PLM_S), dtype=np.int32)


def _stage_fn(torch):
    # One layer per stage: the stage's slice keeps a layer dim of 1.
    return lambda p, act: mlp_stage(torch, {k: v[0] for k, v in p.items()}, act)


def _run_gpipe_pp4(rank: int, size: int) -> dict:
    """gpipe on pp=4 with 4 microbatches: this rank's output."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.pipeline import gpipe, stack_stage_params

    mesh = hvd.create_mesh({"pp": size})
    params, x = gpipe_inputs()
    stacked = stack_stage_params({k: torch.from_numpy(v) for k, v in params.items()}, size)
    mine = {k: v[mesh.coords["pp"]] for k, v in stacked.items()}   # this rank's stage
    out = gpipe(_stage_fn(torch), mine, torch.from_numpy(x), mesh=mesh,
                num_microbatches=GPIPE_M)
    return {"out": out.numpy(), "stage": mesh.coords["pp"]}


def _run_gpipe_grads(rank: int, size: int, with_train_gpt2: bool) -> dict:
    """On pp=2: the gradients of the mean-squared loss through gpipe (4
    microbatches) against the same stack run unpipelined on this rank; 10
    SGD steps through gpipe (the losses); then, with ``with_train_gpt2``,
    ``train_gpt2 --pp 2 --remat`` on this world."""
    import torch

    torch.set_num_threads(2)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.pipeline import gpipe

    mesh = hvd.create_mesh({"pp": size})
    params, x, y = grad_inputs()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    stage = mesh.coords["pp"]
    mine = {k: torch.nn.Parameter(v[stage:stage + 1].clone()) for k, v in full.items()}
    fn = _stage_fn(torch)

    def loss_of(p):
        return torch.mean((gpipe(fn, p, x, mesh=mesh, num_microbatches=GRAD_M) - y) ** 2)

    loss = loss_of(mine)
    loss.backward()
    ref = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    act = x
    for s in range(size):    # the stack unpipelined
        act = mlp_stage(torch, {k: v[s] for k, v in ref.items()}, act)
    ref_loss = torch.mean((act - y) ** 2)
    ref_loss.backward()
    out = {"loss": float(loss), "ref_loss": float(ref_loss),
           "grads": {k: v.grad.numpy().copy() for k, v in mine.items()},
           "ref_grads": {k: v.grad[stage:stage + 1].numpy().copy() for k, v in ref.items()},
           "stage": stage}
    losses = []
    for _ in range(GRAD_STEPS):
        for p in mine.values():
            p.grad = None
        loss = loss_of(mine)
        loss.backward()
        with torch.no_grad():
            for p in mine.values():
                p -= GRAD_LR * p.grad
        losses.append(float(loss))
    out["losses"] = np.array(losses)
    if with_train_gpt2:
        from horovod_tpu_torch import train_gpt2

        # Last: train_gpt2 shuts the world down when it returns.
        out["train_gpt2"] = np.array(train_gpt2.main(
            ["--model", "gpt2-tiny", "--batch-size", "4", "--seq-len", "32", "--steps", "2",
             "--pp", str(size), "--remat", "--device", "cpu"]))
    return out


def _run_pipelined_lm(rank: int, size: int, params_by_dtype) -> dict:
    """On pp=2 x dp=2: PipelinedLM (4 microbatches) from the JAX scanned
    TransformerLM's weights, in bf16 and f32: the logits of the whole batch;
    in f32 this rank's gradients of lm_loss on its dp rows against the
    port's TransformerLM on the same rows; then 4 Adam steps through
    make_train_step in bf16 (the losses, the parameters)."""
    import torch

    torch.set_num_threads(2)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.pipelined import PipelinedLM
    from horovod_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    mesh = hvd.create_mesh({"pp": 2, "dp": 2})
    stage, dpi = mesh.coords["pp"], mesh.coords["dp"]
    ids = torch.from_numpy(plm_ids())
    rows = ids[dpi * PLM_B // 2:(dpi + 1) * PLM_B // 2]
    out = {"coords": np.array([stage, dpi])}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cfg = TransformerConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                                max_len=64, scan_layers=True, dtype=dtype)
        params = params_by_dtype[name]
        model = PipelinedLM(cfg, mesh, num_microbatches=PLM_M, device="cpu")
        model.load_state_dict(flax_to_torch(params, cfg, stages=2, stage=stage))
        with torch.no_grad():
            out[f"logits_{name}"] = model(ids).float().numpy()
        if name == "f32":
            full = TransformerLM(cfg, device="cpu")
            full.load_state_dict(flax_to_torch(params, cfg))
            # A stage loads from the unpipelined model's state_dict.
            mine = model.state_dict()
            model.load_state_dict({k: v for k, v in full.state_dict().items() if k in mine})
            lm_loss(model(rows), rows).backward()
            lm_loss(full(rows), rows).backward()
            ref = dict(full.named_parameters())
            out["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
            out["ref_grads"] = {k: ref[k].grad.numpy().copy() for k in out["grads"]}
    cfg = TransformerConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                            max_len=64, scan_layers=True)
    model = PipelinedLM(cfg, mesh, num_microbatches=PLM_M, device="cpu")
    model.load_state_dict(flax_to_torch(params_by_dtype["bf16"], cfg, stages=2, stage=stage))
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(), lr=PLM_LR),
                                   axis_name="dp")
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh)
    state = init_fn()
    losses = []
    for _ in range(PLM_STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    out["losses"] = np.array(losses)
    out["params"] = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism (tests/test_torch_port_tp.py).
TP_VOCAB = 131                      # divisible by neither 2 nor 4
TP_B, TP_S = 4, 16
TP_TRAIN_VOCAB = 128                # the dp x tp train step, as JAX needs
TP_LR, TP_WD, TP_EPS, TP_STEPS = 1e-4, 1e-4, 1e-8, 3
# name -> (model, dtype, attn_impl, gradients too)
TP_CASES = {
    "gpt2_f32_dense": ("gpt2", "float32", "dense", True),
    "gpt2_bf16_dense": ("gpt2", "bfloat16", "dense", False),
    "gpt2_f32_flash": ("gpt2", "float32", "flash", True),
    "bert_f32_dense": ("bert", "float32", "dense", True),
}
TP_WORLDS = {2: tuple(TP_CASES), 4: ("gpt2_f32_dense", "gpt2_bf16_dense")}
# Combinations that ran into NotImplementedError before tp composed with
# sp, with the Switch FFN and with pp -> (mesh, config overrides): ring and
# Ulysses with no sp line fall back to dense; experts run with each one's
# d_ff cut over tp, an ep axis beside tp holds its replicas of the dense
# model, a pp axis beside tp pipelines the tp stages of ``PipelinedLM``
# (the scan-stacked layout); sp trains.
TP_RUNS = {
    "ring": ({"tp": 2}, {"attn_impl": "ring"}),
    "ulysses": ({"tp": 2}, {"attn_impl": "ulysses"}),
    "moe": ({"tp": 2}, {"n_experts": 2}),
    "ep": ({"ep": 2, "tp": 2}, {}),
    "pp": ({"pp": 2, "tp": 2}, {"scan_layers": True}),
    "sp": ({"sp": 2, "tp": 2}, {}),
}
TP_RUN_STEPS = 2


def tp_batch(vocab: int = TP_VOCAB, seed: int = 5):
    """Ids (B, S) and a padding mask whose second row keeps 9 tokens."""
    ids = np.random.RandomState(seed).randint(0, vocab, (TP_B, TP_S)).astype(np.int32)
    mask = np.ones((TP_B, TP_S), np.int32)
    mask[1, 9:] = 0
    return ids, mask


def tp_config(torch, name: str, vocab: int = TP_VOCAB):
    """The port's config of a TP_CASES case: gpt2-tiny (4 heads, 2 layers)
    or bert-tiny (2 heads) at ``vocab``."""
    import dataclasses

    from horovod_tpu_torch.models.transformer import BERT_CONFIGS, GPT2_CONFIGS

    model, dtype, attn, _ = TP_CASES[name]
    base = GPT2_CONFIGS["gpt2-tiny"] if model == "gpt2" else BERT_CONFIGS["bert-tiny"]
    return dataclasses.replace(base, vocab_size=vocab, max_len=64, attn_impl=attn,
                               dtype=getattr(torch, dtype))


def _tp_model_case(hvd, torch, mesh, name: str, params) -> dict:
    """One TP_CASES case on ``mesh``'s tp line: this rank's logits shard and,
    where asked, its gradients of the vocab-parallel loss by name."""
    from horovod_tpu_torch.models.convert import bert_flax_to_torch, flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerEncoder, TransformerLM
    from horovod_tpu_torch.parallel.tensor import vocab_parallel_lm_loss, vocab_parallel_xent

    kind, _, _, with_grads = TP_CASES[name]
    cfg = tp_config(torch, name)
    tp, r = mesh.shape["tp"], mesh.coords["tp"]
    ids, mask = (torch.from_numpy(a) for a in tp_batch())
    if kind == "gpt2":
        model = TransformerLM(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(flax_to_torch(params, cfg, tp=tp, tp_rank=r))
        logits = model(ids)
        loss = vocab_parallel_lm_loss(logits, ids, mesh.comm("tp"), cfg.vocab_size)
    else:
        model = TransformerEncoder(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(bert_flax_to_torch(params, cfg, tp=tp, tp_rank=r))
        logits = model(ids, mask)
        loss = vocab_parallel_xent(logits, ids, mesh.comm("tp"), cfg.vocab_size)
    out = {"logits": logits.detach().float().numpy(), "loss": float(loss)}
    if with_grads:
        loss.backward()
        out["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    return out


def _tp_init(hvd, torch, mesh) -> dict:
    """gpt2-tiny at vocab TP_VOCAB built on ``mesh`` from torch seed 0: this
    rank's state_dict (every tp layout of one seed holds world-1's
    weights)."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    cfg = tp_config(torch, "gpt2_f32_dense")
    model = TransformerLM(cfg, device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(0))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _tp_runs(hvd, torch, combos, params_by_combo) -> dict:
    """Each combination of ``combos`` (TP_RUNS) from its weights (those of
    the gpt2_f32_dense case, with experts where it has them, scan-stacked
    under pp): with no sp line, this rank's logits shard of the whole
    sequence and its mesh coordinates; sp, TP_RUN_STEPS steps of
    make_train_step(shard_seq=True) from those weights (the losses)."""
    import dataclasses

    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.pipelined import PipelinedLM
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    out = {}
    ids = torch.from_numpy(tp_batch()[0])
    for name in combos:
        shape, overrides = TP_RUNS[name]
        mesh = hvd.create_mesh(shape)
        cfg = dataclasses.replace(tp_config(torch, "gpt2_f32_dense"), **overrides)
        pp = mesh.shape.get("pp", 1)
        if pp > 1:
            model = PipelinedLM(cfg, mesh, device="cpu")
        else:
            model = TransformerLM(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(flax_to_torch(
            params_by_combo[name], cfg, ep=mesh.shape.get("ep", 1),
            ep_rank=mesh.coords.get("ep", 0), stages=pp, stage=mesh.coords.get("pp", 0),
            tp=2, tp_rank=mesh.coords["tp"]))
        if "sp" not in shape:
            with torch.no_grad():
                out[name] = {"logits": model(ids).numpy(), "coords": dict(mesh.coords)}
            continue
        opt = torch.optim.AdamW(model.parameters(), lr=TP_LR, weight_decay=TP_WD, eps=TP_EPS)
        init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh, shard_seq=True)
        state = init_fn()
        losses = []
        for _ in range(TP_RUN_STEPS):
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
        out[name] = {"losses": np.array(losses)}
    return out


def _run_tp_world(rank: int, size: int, params_by_case, train_params, run_params) -> dict:
    """On tp=size: each TP_WORLDS[size] case (logits, gradients), the tp
    initialisation and the combinations of TP_RUNS that run on this world
    (from ``run_params``, by combination); on four
    ranks also 3 AdamW steps of gpt2-tiny (vocab TP_TRAIN_VOCAB, f32)
    through make_train_step on dp=2 x tp=2 from ``train_params`` (the
    losses, the parameters); on two ranks, last, ``train_gpt2 --tp 2``."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd

    mesh = hvd.create_mesh({"tp": size})
    out = {name: _tp_model_case(hvd, torch, mesh, name, params_by_case[name])
           for name in TP_WORLDS[size]}
    out["init"] = _tp_init(hvd, torch, mesh)
    out["runs"] = _tp_runs(hvd, torch, [n for n, (shape, _) in TP_RUNS.items()
                                        if np.prod(list(shape.values())) == size],
                           run_params)
    if size == 4:
        out["train"] = _tp_train(hvd, torch, train_params)
    if size == 2:
        from horovod_tpu_torch import train_gpt2

        # Last: train_gpt2 shuts the world down when it returns.
        out["train_gpt2"] = np.array(train_gpt2.main(
            ["--model", "gpt2-tiny", "--batch-size", "4", "--seq-len", "32", "--steps", "2",
             "--tp", str(size), "--attn", "flash", "--remat", "--device", "cpu"]))
    return out


def _tp_train(hvd, torch, params) -> dict:
    """3 AdamW steps through make_train_step on dp=2 x tp=2."""
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    mesh = hvd.create_mesh({"dp": 2, "tp": 2})
    cfg = tp_config(torch, "gpt2_f32_dense", vocab=TP_TRAIN_VOCAB)
    model = TransformerLM(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(flax_to_torch(params, cfg, tp=2, tp_rank=mesh.coords["tp"]))
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=TP_LR, weight_decay=TP_WD, eps=TP_EPS), axis_name="dp")
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh)
    state = init_fn()
    ids = torch.from_numpy(tp_batch(TP_TRAIN_VOCAB, seed=6)[0])
    losses = []
    for _ in range(TP_STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    return {"coords": np.array([mesh.coords["dp"], mesh.coords["tp"]]),
            "losses": np.array(losses),
            "params": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


# ---------------------------------------------------------------------------
# tp composed with sp (tests/test_torch_port_tp_sp.py): gpt2-tiny (4 heads,
# 2 layers) and bert-tiny at 4 heads, at vocabulary TP_VOCAB (TP_TRAIN_VOCAB
# for the train step), on sp=2 x tp=2: rank 2·s + t holds sp index s and
# tp index t, the JAX device of that index in the {"sp": 2, "tp": 2} mesh.
TPSP_MESH = {"sp": 2, "tp": 2}
TPSP_ATTNS = ("dense", "flash", "ring", "ulysses", "ulysses_flash")
TPSP_BERT_ATTNS = ("dense", "ring", "ulysses_flash")
TPSP_TRAIN_ATTNS = ("dense", "flash", "ring", "ulysses")
TPSP_STEPS = 3


def tpsp_config(torch, kind: str, attn: str, vocab: int = TP_VOCAB, **overrides):
    """The port's config of a tp x sp case: gpt2-tiny or bert-tiny at 4
    heads, f32, ``attn`` one of TPSP_ATTNS (``ulysses_flash``: Ulysses
    through flash)."""
    import dataclasses

    from horovod_tpu_torch.models.transformer import BERT_CONFIGS, GPT2_CONFIGS

    base = GPT2_CONFIGS["gpt2-tiny"] if kind == "gpt2" else BERT_CONFIGS["bert-tiny"]
    impl = "ulysses" if attn == "ulysses_flash" else attn
    return dataclasses.replace(base, **{
        "n_heads": 4, "vocab_size": vocab, "max_len": 64, "attn_impl": impl,
        "sp_use_flash": attn == "ulysses_flash", "dtype": torch.float32, **overrides})


def tpsp_logits(seed: int = 11) -> np.ndarray:
    """(TP_B, TP_S, TP_VOCAB) logits for the loss case."""
    return np.random.RandomState(seed).randn(TP_B, TP_S, TP_VOCAB).astype(np.float32)


def _tpsp_block(a, mesh, vocab_dim: bool = False):
    """This rank's sequence block of ``a`` (dim 1 over sp) and, with
    ``vocab_dim``, its vocabulary shard of the last dim (over tp)."""
    from horovod_tpu_torch.parallel.tensor import shard_range

    a = _block(a, mesh.coords["sp"], mesh.shape["sp"])
    if vocab_dim:
        cols = shard_range(a.shape[-1], mesh.shape["tp"], mesh.coords["tp"])
        a = a[..., cols.start: cols.stop]
    return np.ascontiguousarray(a)


def _tpsp_model_case(hvd, torch, mesh, kind: str, attn: str, params, remat=False) -> dict:
    """One model on sp x tp with the JAX weights cut to this rank's tp
    shard: its logits (this rank's sequence block and vocabulary shard) and
    the gradients of the loss, averaged over the sp line (the whole batch's
    gradient of this rank's tp shard): gpt2 the sequence-sharded
    vocab-parallel ``lm_loss`` of ``make_train_step``, bert
    ``vocab_parallel_xent`` of this rank's labels under the padding mask."""
    from horovod_tpu_torch.models.convert import bert_flax_to_torch, flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerEncoder, TransformerLM
    from horovod_tpu_torch.parallel.tensor import vocab_parallel_xent
    from horovod_tpu_torch.parallel.train import _lm_loss_sharded

    cfg = tpsp_config(torch, kind, attn, remat=remat)
    tp, t = mesh.comm("tp"), mesh.coords["tp"]
    ids, mask = tp_batch()
    ids_blk, mask_blk = (torch.from_numpy(_tpsp_block(a, mesh)) for a in (ids, mask))
    out = {}
    if kind == "gpt2":
        model = TransformerLM(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(flax_to_torch(params, cfg, tp=2, tp_rank=t))
        model.train()
        logits = model(ids_blk)
        loss = _lm_loss_sharded(logits, torch.from_numpy(ids), mesh, mesh.shape["sp"],
                                (tp, cfg.vocab_size))
        with torch.no_grad():
            offset = model.seq_offset(ids_blk.shape[1])
            out["embed"] = model.embed(ids_blk, offset).numpy()
            out["seq_offset"] = np.array(offset)
    else:
        model = TransformerEncoder(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(bert_flax_to_torch(params, cfg, tp=2, tp_rank=t))
        logits = model(ids_blk, mask_blk)
        loss = vocab_parallel_xent(logits, ids_blk, tp, cfg.vocab_size)
    loss.backward()
    out.update(logits=logits.detach().numpy(),
               loss=float(hvd.allreduce(loss.detach(), axis_name="sp")),
               grads={k: hvd.allreduce(p.grad, axis_name="sp").numpy().copy()
                      for k, p in model.named_parameters()})
    return out


def _tpsp_loss(hvd, torch, mesh) -> dict:
    """The sequence-sharded vocab-parallel ``lm_loss`` on ``tpsp_logits``:
    this rank's share (every tp rank alike), the sp line's average of the
    shares (the global loss) and the gradient of its share over the line's
    size (the global loss's gradient of this rank's block)."""
    from horovod_tpu_torch.parallel.train import _lm_loss_sharded

    z = torch.from_numpy(_tpsp_block(tpsp_logits(), mesh, vocab_dim=True)).requires_grad_(True)
    n = mesh.shape["sp"]
    share = _lm_loss_sharded(z, torch.from_numpy(tp_batch()[0]), mesh, n,
                             (mesh.comm("tp"), TP_VOCAB))
    (share / n).backward()
    return {"share": float(share.detach()), "loss": float(hvd.allreduce(share.detach(), axis_name="sp")),
            "grad": z.grad.numpy()}


def _tpsp_ring_bf16(hvd, torch, mesh) -> dict:
    """``ring_attention`` over the sp line in bf16 on this rank's sequence
    block and tp head shard of ``sp_inputs`` (rounded to bf16): o and the
    gradients of q, k, v, causal and not."""
    def blk(a):
        a = _block(a, mesh.coords["sp"], mesh.shape["sp"], 1)
        return torch.from_numpy(_block(a, mesh.coords["tp"], mesh.shape["tp"], 2))

    q, k, v, cot, _ = sp_inputs()
    out = {}
    for causal in (True, False):
        qkv = [blk(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
        o = hvd.ring_attention(*qkv, "sp", causal=causal)
        o.backward(blk(cot).to(torch.bfloat16))
        out[causal] = [o.detach().float().numpy()] + [t.grad.float().numpy() for t in qkv]
    return out


def _tpsp_perturb(sd: dict, mesh, cfg) -> dict:
    """``sd`` with every tensor that ``make_train_step``'s init broadcasts
    onto this rank moved off: the tp-cut ones where this rank is not its
    (dp, sp) line's first member, the replicated ones off world rank 0."""
    from horovod_tpu_torch.parallel.tensor import tp_cut

    rank = mesh.coords["sp"] * mesh.shape["tp"] + mesh.coords["tp"]
    out = {}
    for k, v in sd.items():
        cut = tp_cut(k, cfg, mesh.shape["tp"], mesh.coords["tp"]) is not None
        moved = mesh.coords["sp"] > 0 if cut else rank > 0
        out[k] = v + 0.01 * (rank + 1) if moved else v
    return out


def _tpsp_train(hvd, torch, mesh, attn: str, params) -> dict:
    """TPSP_STEPS AdamW steps of gpt2-tiny (vocab TP_TRAIN_VOCAB) through
    ``make_train_step(shard_seq=True)`` with the plain optimizer, from the
    JAX weights, each rank loaded with them moved off where init's
    broadcasts must restore them (``_tpsp_perturb``): whether init restored
    them bitwise, each tensor's line of copies, the step-1 gradients
    AdamW steps on, the losses and the parameters."""
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.sharding import replica_comm
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    cfg = tpsp_config(torch, "gpt2", attn, vocab=TP_TRAIN_VOCAB)
    model = TransformerLM(cfg, device="cpu", mesh=mesh)
    sd = flax_to_torch(params, cfg, tp=2, tp_rank=mesh.coords["tp"])
    model.load_state_dict(_tpsp_perturb(sd, mesh, cfg))
    inner = torch.optim.AdamW(model.parameters(), lr=TP_LR, weight_decay=TP_WD, eps=TP_EPS)
    init_fn, step_fn = make_train_step(model, inner, lm_loss, mesh=mesh, shard_seq=True)
    got = {}
    inner_step = inner.step

    def step(*a, **kw):     # the reduced step-1 gradients, as AdamW gets them
        got.setdefault("grads", {n: p.grad.numpy().copy()
                                 for n, p in model.named_parameters()})
        return inner_step(*a, **kw)

    inner.step = step
    state = init_fn()
    restored = all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    ids = torch.from_numpy(tp_batch(TP_TRAIN_VOCAB, seed=6)[0])
    losses = []
    for _ in range(TPSP_STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    return {"init_restored": np.array(restored), "losses": np.array(losses),
            "lines": {n: np.array(replica_comm(n, p, model.rules, mesh).ranks)
                      for n, p in model.named_parameters()},
            "grads": got["grads"],
            "params": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


def _tpsp_raises(torch, mesh) -> str:
    """The message Ulysses raises with when the local heads do not split
    over sp: 2 heads at tp=2 leave 1 a rank, over sp=2."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    return _raises(lambda: TransformerLM(tpsp_config(torch, "gpt2", "ulysses", n_heads=2),
                                         device="cpu", mesh=mesh))


def _run_tp_sp_world(rank: int, size: int, gpt_params, bert_params, train_params) -> dict:
    """On sp=2 x tp=2: gpt2-tiny under each of TPSP_ATTNS and bert-tiny
    under each of TPSP_BERT_ATTNS (``_tpsp_model_case``), gpt2 with the
    ring under remat; the tp initialisation; the sequence-sharded
    vocab-parallel loss; the ring in bf16; the Ulysses head count that does
    not split; 3 steps of make_train_step under each of TPSP_TRAIN_ATTNS;
    last, ``train_gpt2 --tp 2 --sp 2 --attn ring --remat``."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd

    mesh = hvd.create_mesh(TPSP_MESH)
    out = {"coords": np.array([mesh.coords["sp"], mesh.coords["tp"]])}
    for attn in TPSP_ATTNS:
        out[f"gpt2_{attn}"] = _tpsp_model_case(hvd, torch, mesh, "gpt2", attn, gpt_params)
    out["gpt2_ring_remat"] = _tpsp_model_case(hvd, torch, mesh, "gpt2", "ring", gpt_params,
                                              remat=True)
    for attn in TPSP_BERT_ATTNS:
        out[f"bert_{attn}"] = _tpsp_model_case(hvd, torch, mesh, "bert", attn, bert_params)
    out["init"] = _tp_init(hvd, torch, mesh)
    out["loss"] = _tpsp_loss(hvd, torch, mesh)
    out["ring_bf16"] = _tpsp_ring_bf16(hvd, torch, mesh)
    out["raises"] = _tpsp_raises(torch, mesh)
    for attn in TPSP_TRAIN_ATTNS:
        out[f"train_{attn}"] = _tpsp_train(hvd, torch, mesh, attn, train_params)
    from horovod_tpu_torch import train_gpt2

    # Last: train_gpt2 shuts the world down when it returns.
    out["train_gpt2"] = np.array(train_gpt2.main(
        ["--model", "gpt2-tiny", "--batch-size", "4", "--seq-len", "32", "--steps", "2",
         "--tp", "2", "--sp", "2", "--attn", "ring", "--remat", "--device", "cpu"]))
    return out


# ---------------------------------------------------------------------------
# MoE under tensor parallelism (tests/test_torch_port_tp_moe.py): gpt2-tiny
# (4 heads, 2 layers, f32) with TPMOE_E Switch experts in block 1, each
# expert's d_ff cut over tp, at vocabulary TP_VOCAB (TP_TRAIN_VOCAB for the
# train step), on four gloo ranks. Every mesh names dp, ep, sp and tp (size
# 1 where a case has none); a rank's results carry its coordinates.
TPMOE_E, TPMOE_AUX, TPMOE_STEPS = 4, 0.01, 3
# name -> (mesh, capacity factor, attention as in TPSP_ATTNS)
TPMOE_CASES = {
    "ep2_tp2": ({"ep": 2, "tp": 2}, 1.25, "dense"),
    "dp2_tp2": ({"dp": 2, "tp": 2}, 0.5, "dense"),
    "tp4": ({"tp": 4}, 1.25, "dense"),
    "sp2_tp2": ({"sp": 2, "tp": 2}, 1.25, "ulysses_flash"),
}


def tpmoe_config(torch, name: str, vocab: int = TP_VOCAB):
    _, cf, attn = TPMOE_CASES[name]
    return tpsp_config(torch, "gpt2", attn, vocab=vocab, n_experts=TPMOE_E,
                       capacity_factor=cf)


def tpmoe_mesh(hvd, name: str):
    shape = TPMOE_CASES[name][0]
    return hvd.create_mesh({a: shape.get(a, 1) for a in ("dp", "ep", "sp", "tp")})


def _tpmoe_model(torch, mesh, cfg, params):
    """gpt2 of ``cfg`` on ``mesh`` with its ep slice and tp shard of the
    numpy JAX weights ``params``."""
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(cfg, device="cpu", mesh=mesh)
    model.load_state_dict(flax_to_torch(
        params, cfg, ep=mesh.shape["ep"], ep_rank=mesh.coords["ep"], tp=mesh.shape["tp"],
        tp_rank=mesh.coords["tp"]))
    return model


def _routes(model) -> list:
    return [b.expert_idx.numpy().copy() for b in model.moe_blocks()]


def _tpmoe_model_case(hvd, torch, mesh, name: str, params) -> dict:
    """One case's model from the JAX weights on ``tp_batch``: this rank's
    logits (its dp rows, sp block and vocabulary shard), and the gradients
    of the global objective (``lm_loss`` over the global shifted sequence
    plus TPMOE_AUX times the auxiliary loss, this rank's share as
    ``make_train_step`` takes it), averaged over the (dp, sp) line; the
    global objective, the dropped tokens and the routes."""
    from horovod_tpu_torch.parallel.train import _cut, _lm_loss_sharded

    cfg = tpmoe_config(torch, name)
    model = _tpmoe_model(torch, mesh, cfg, params)
    ids = torch.from_numpy(tp_batch()[0])
    model.train()
    logits = model(_cut(ids, mesh, True))
    data = mesh.comm(("dp", "sp"))
    loss = (_lm_loss_sharded(logits, ids, mesh, data.size, (mesh.comm("tp"), cfg.vocab_size))
            + TPMOE_AUX * model.moe_aux_loss())
    loss.backward()
    return {"logits": logits.detach().numpy(),
            "loss": float(hvd.allreduce(loss.detach(), axis_name=("dp", "sp"))),
            "grads": {k: hvd.allreduce(p.grad, axis_name=("dp", "sp")).numpy().copy()
                      for k, p in model.named_parameters()},
            "dropped": np.array([int(d) for d in model.moe_dropped()]),
            "routes": _routes(model)}


def _tpmoe_train(hvd, torch, mesh, name: str, params) -> dict:
    """TPMOE_STEPS AdamW steps of ``make_train_step(moe_aux_weight=
    TPMOE_AUX)`` with the plain optimizer from the JAX weights (vocab
    TP_TRAIN_VOCAB): the losses, the reduced step-1 gradients AdamW steps
    on, each step's dropped tokens and routes, the final parameters."""
    from horovod_tpu_torch.parallel.sharding import replica_comm
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    cfg = tpmoe_config(torch, name, vocab=TP_TRAIN_VOCAB)
    model = _tpmoe_model(torch, mesh, cfg, params)
    inner = torch.optim.AdamW(model.parameters(), lr=TP_LR, weight_decay=TP_WD, eps=TP_EPS)
    init_fn, step_fn = make_train_step(model, inner, lm_loss, mesh=mesh,
                                       shard_seq=mesh.shape["sp"] > 1,
                                       moe_aux_weight=TPMOE_AUX)
    got = {}
    inner_step = inner.step

    def step(*a, **kw):     # the reduced step-1 gradients, as AdamW gets them
        got.setdefault("grads", {n: p.grad.numpy().copy()
                                 for n, p in model.named_parameters()})
        return inner_step(*a, **kw)

    inner.step = step
    state = init_fn()
    ids = torch.from_numpy(tp_batch(TP_TRAIN_VOCAB, seed=6)[0])
    losses, dropped, routes = [], [], []
    for _ in range(TPMOE_STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
        dropped.append([int(d) for d in model.moe_dropped()])
        routes.append(_routes(model))
    return {"losses": np.array(losses), "dropped": np.array(dropped), "routes": routes,
            "grads": got["grads"],
            "params": {k: v.numpy().copy() for k, v in model.state_dict().items()},
            "lines": {n: np.array(replica_comm(n, p, model.rules, mesh).ranks)
                      for n, p in model.named_parameters()},
            "data_line": np.array(mesh.comm(("dp", "sp")).ranks)}


def _tpmoe_init(torch, mesh) -> dict:
    """The MoE gpt2 built on ``mesh`` from torch seed 0: this rank's
    state_dict."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(tpmoe_config(torch, "ep2_tp2"), device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(0))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _run_tp_moe_world(rank: int, size: int, params, train_params) -> dict:
    """Each TPMOE_CASES case on its mesh: the model case, the train step and
    the seeded initialisation (``_tpmoe_*``), with the rank's coordinates;
    last, ``train_gpt2 --tp 2 --ep 2 --n-experts 4 --remat``."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd

    out = {}
    for name in TPMOE_CASES:
        mesh = tpmoe_mesh(hvd, name)
        out[name] = {"coords": dict(mesh.coords),
                     "model": _tpmoe_model_case(hvd, torch, mesh, name, params),
                     "train": _tpmoe_train(hvd, torch, mesh, name, train_params),
                     "init": _tpmoe_init(torch, mesh)}
    from horovod_tpu_torch import train_gpt2

    # Last: train_gpt2 shuts the world down when it returns.
    out["train_gpt2"] = np.array(train_gpt2.main(
        ["--model", "gpt2-tiny", "--batch-size", "4", "--seq-len", "32", "--steps", "2",
         "--tp", "2", "--ep", "2", "--n-experts", "4", "--remat", "--device", "cpu"]))
    return out


def _run_tp_moe_one(rank: int, size: int) -> dict:
    """On a world of one: the MoE gpt2 (vocab TP_TRAIN_VOCAB, capacity 0.5)
    from torch seed 0 built on a dp=1 x ep=1 x sp=1 x tp=1 mesh and with
    no mesh, TPMOE_STEPS AdamW steps of each through make_train_step: the
    losses, the step-1 gradients and the dropped tokens of each."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    cfg = tpmoe_config(torch, "dp2_tp2", vocab=TP_TRAIN_VOCAB)
    mesh = hvd.create_mesh({"dp": 1, "ep": 1, "sp": 1, "tp": 1})
    ids = torch.from_numpy(tp_batch(TP_TRAIN_VOCAB, seed=6)[0])
    out = {}
    for kind, on in (("mesh", mesh), ("bare", None)):
        model = TransformerLM(cfg, device="cpu", mesh=on,
                              generator=torch.Generator().manual_seed(0))
        opt = torch.optim.AdamW(model.parameters(), lr=TP_LR, weight_decay=TP_WD, eps=TP_EPS)
        init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh,
                                           moe_aux_weight=TPMOE_AUX)
        state = init_fn()
        losses, dropped = [], []
        for i in range(TPMOE_STEPS):
            state, loss = step_fn(state, ids, ids)
            losses.append(float(loss))
            dropped.append([int(d) for d in model.moe_dropped()])
            if i == 0:
                grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
        out[kind] = {"losses": np.array(losses), "dropped": np.array(dropped),
                     "grads": grads}
    return out


# ---------------------------------------------------------------------------
# Sharded training state on the mesh (tests/test_torch_port_{zero_mesh,
# fsdp}.py): gpt2-tiny cut to vocab 128, d_model 32 (4 heads of 8), d_ff 64,
# 2 layers, S=16, B=4.
ZM_VOCAB, ZM_B, ZM_S = 128, 4, 16
ZM_LR, ZM_WD, ZM_EPS, ZM_STEPS = 1e-4, 1e-4, 1e-8, 3
ZM_SHAPES = {"dp2": {"dp": 2}, "dp2_tp2": {"dp": 2, "tp": 2}}


def zm_config(torch, dtype: str = "float32", **overrides):
    import dataclasses

    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS

    fields = dict(vocab_size=ZM_VOCAB, d_model=32, n_heads=4, d_ff=64, max_len=ZM_S,
                  dtype=getattr(torch, dtype))
    return dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], **{**fields, **overrides})


def zm_ids(seed: int = 7) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, ZM_VOCAB, (ZM_B, ZM_S)).astype(np.int32)


def _zm_train(hvd, torch, shape: dict, params=None, dtype: str = "float32", *,
              zero: bool = False, fsdp: bool = False, plain: bool = True,
              shard_seq: bool = False, moe_aux_weight: float = 0.0, opt_kw=None,
              per_step: bool = False, **overrides) -> dict:
    """ZM_STEPS AdamW steps of the zm model on a mesh of ``shape`` through
    ``make_train_step`` (``zero=``; ``rules=FSDP_RULES`` with ``fsdp``),
    from the numpy weights ``params`` (each rank loading its cut), or from
    torch seed 0 without them; the optimizer passed plain, or with
    ``plain=False`` as ``DistributedOptimizer`` over the mesh's dp and sp
    axes (with ``opt_kw``). Returns
    the losses, this rank's coordinates, its state_dict (with ``per_step``
    after every step too), its optimizer's state bytes and the rank's
    step-1 gradients by name; with Switch experts each step's dropped
    tokens and this rank's routes."""
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    mesh = hvd.create_mesh(shape)
    cfg = zm_config(torch, dtype, **overrides)
    c = {a: (mesh.shape.get(a, 1), mesh.coords.get(a, 0)) for a in ("dp", "tp", "ep")}
    # The FSDP and ZeRO keywords only where they are used, so that the
    # plain-optimizer case runs on a tree without them.
    rules = {}
    if fsdp:
        from horovod_tpu_torch.parallel.sharding import FSDP_RULES

        rules = {"rules": FSDP_RULES}
    model = TransformerLM(cfg, device="cpu", mesh=mesh,
                          generator=torch.Generator().manual_seed(0), **rules)
    if params is not None:
        cut = {"dp": c["dp"][0], "dp_rank": c["dp"][1]} if fsdp else {}
        model.load_state_dict(flax_to_torch(params, cfg, ep=c["ep"][0], ep_rank=c["ep"][1],
                                            tp=c["tp"][0], tp_rank=c["tp"][1], **cut))
    opt = torch.optim.AdamW(model.parameters(), lr=ZM_LR, weight_decay=ZM_WD, eps=ZM_EPS)
    if not plain:
        line = tuple(a for a in ("dp", "sp") if a in mesh.axis_names)
        opt = hvd.DistributedOptimizer(opt, zero=int(zero), axis_name=line, **(opt_kw or {}))
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh, shard_seq=shard_seq,
                                       moe_aux_weight=moe_aux_weight,
                                       **({"zero": True} if zero else {}), **rules)
    state = init_fn()
    ids = torch.from_numpy(zm_ids())
    losses, grads, by_step, dropped, routes = [], None, [], [], []
    for _ in range(ZM_STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
        if model.moe_blocks():
            dropped.append([int(d) for d in model.moe_dropped()])
            routes.append(_routes(model))
        if grads is None:
            grads = {k: p.grad.detach().float().numpy().copy()
                     for k, p in model.named_parameters()}
        if per_step:
            by_step.append({k: v.detach().float().numpy().copy()
                            for k, v in model.state_dict().items()})
    return {"losses": np.array(losses), "coords": dict(mesh.coords), "by_step": by_step,
            "dropped": np.array(dropped), "routes": routes,
            "params": {k: v.detach().float().numpy().copy()
                       for k, v in model.state_dict().items()},
            "grads": grads,
            "state_bytes": getattr(state.optimizer, "state_bytes", lambda: None)(),
            "optimizer": type(state.optimizer).__name__}


def _raises(fn, kinds=(ValueError, NotImplementedError)) -> str:
    """What ``fn()`` raises, as "Kind: message", or "no error"."""
    try:
        fn()
    except kinds as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _zero_mesh_raises(hvd, torch) -> dict:
    """The combinations make_train_step(zero=...) and ZeRO refuse, on a
    world of four."""
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.sharding import DEFAULT_RULES, FSDP_RULES
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    def step(shape, zero, rules=FSDP_RULES, model_rules=None, opt_kw=None):
        def run():
            mesh = hvd.create_mesh(shape)
            model = TransformerLM(zm_config(torch), device="cpu", mesh=mesh,
                                  rules=model_rules or rules)
            opt = torch.optim.AdamW(model.parameters())
            if opt_kw is not None:
                opt = hvd.DistributedOptimizer(opt, axis_name="dp", **opt_kw)
            make_train_step(model, opt, lm_loss, mesh=mesh, zero=zero, rules=rules)
        return run

    return {
        "zero_without_dp": _raises(step({"tp": 4}, True, DEFAULT_RULES)),
        "zero_with_fsdp": _raises(step({"dp": 4}, True)),
        "zero_with_replicated_optimizer": _raises(
            step({"dp": 4}, True, DEFAULT_RULES, opt_kw={"zero": 0})),
        "rules_not_the_models": _raises(step({"dp": 4}, False, FSDP_RULES, DEFAULT_RULES)),
        "zero_optimizer_on_fsdp_params": _raises(
            step({"dp": 4}, False, FSDP_RULES, opt_kw={"zero": 1})),
        "error_feedback_on_fsdp_params": _raises(
            step({"dp": 4}, False, FSDP_RULES, opt_kw={"error_feedback": True})),
    }


def _zero_on_line(hvd, torch, rank: int) -> dict:
    """On a dp=2 x tp=2 mesh, the optimizer over the dp line (ranks {0, 2}
    and {1, 3}), each rank stepping its own gradients: ZeRO-1 and the
    replicated optimizer, their state bytes, ZeRO-1, ZeRO-2 and the
    replicated optimizer with SGD, the line-stacked state re-cut
    2 -> 3 -> 2, one member's shard out of it, the HOROVOD_ZERO_SHARDING
    default on the line, and the drift of error feedback on the bf16
    lane."""
    mesh = hvd.create_mesh({"dp": 2, "tp": 2})
    line = mesh.comm("dp")
    p0, grads = zero_params(), zero_grads(4, 3)
    out = {"line": np.array(line.ranks), "line_rank": line.rank}
    out["zero"], opt = _zero_steps(hvd, p0, grads, rank, zero=1, axis_name="dp")
    out["zero_bytes"] = opt.state_bytes()
    out["replicated"], rep = _zero_steps(hvd, p0, grads, rank, axis_name="dp")
    out["replicated_bytes"] = rep.state_bytes()
    # SGD steps by the reduced gradient itself, so a wrong divisor shows.
    for stage in (1, 2):
        out[f"sgd_zero{stage}"] = _zero_steps(hvd, p0, grads, rank, "sgd", zero=stage,
                                              axis_name="dp")[0]
    out["sgd_replicated"] = _zero_steps(hvd, p0, grads, rank, "sgd", axis_name="dp")[0]
    glob = hvd.zero.state_to_global(opt)
    back = hvd.zero.recut_state(hvd.zero.recut_state(glob, 3), 2)
    out["global_world"] = glob["world"]
    out["global"] = {k: v.numpy() for k, v in glob["groups"][0].items()}
    out["recut_back"] = {k: v.numpy() for k, v in back["groups"][0].items()}
    mine = hvd.zero.state_from_global(glob, line.rank)["groups"][0]
    own = opt.shard_state()["groups"][0]
    out["from_global_matches"] = sorted(mine) == sorted(own) and all(
        torch.equal(mine[k].reshape(-1), own[k].reshape(-1)) for k in own)
    out["status_world"] = hvd.zero.status_snapshot()["world"]
    os.environ["HOROVOD_ZERO_SHARDING"] = "2"     # the default stage, on the line
    try:
        env_opt = hvd.DistributedOptimizer(torch.optim.SGD(
            [torch.nn.Parameter(torch.zeros(5))], lr=0.1), axis_name="dp")
    finally:
        del os.environ["HOROVOD_ZERO_SHARDING"]
    out["env_default"] = (env_opt._zero.stage, env_opt._zero.comm.ranks)
    out["drift"] = {name: _ef_drift(hvd, axis_name="dp", **kw) for name, kw in (
        ("stateless", {}), ("ef0", {"error_feedback": True}),
        ("zero1_ef", {"zero": 1, "error_feedback": True}))}
    return out


def _run_plain_step_world(rank: int, size: int, params_f32) -> dict:
    """A plain AdamW through ``make_train_step`` on dp=2, with none of the
    ZeRO or FSDP keywords."""
    import torch

    torch.set_num_threads(2)

    import horovod_tpu_torch as hvd

    return _zm_train(hvd, torch, ZM_SHAPES["dp2"], params_f32)


def _run_zero_mesh_world(rank: int, size: int, params_f32, params_bf16) -> dict:
    """On two ranks: ZeRO on dp=2. On
    four: ZeRO on dp=2 x tp=2 (f32 and bf16), ZeRO over ("dp", "sp") with
    shard_seq and over dp with ep=2 and a Switch FFN, each beside zero=False
    on the same mesh, the optimizer over a line, and what raises."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd

    out = {}
    if size == 2:
        out["zero_dp2"] = _zm_train(hvd, torch, ZM_SHAPES["dp2"], params_f32, zero=True)
        out["zero_dp2_passed"] = _zm_train(hvd, torch, ZM_SHAPES["dp2"], params_f32,
                                           zero=True, plain=False)
        return out
    out["zero_dp2_tp2"] = _zm_train(hvd, torch, ZM_SHAPES["dp2_tp2"], params_f32, zero=True)
    out["replicated_dp2_tp2"] = _zm_train(hvd, torch, ZM_SHAPES["dp2_tp2"], params_f32)
    out["zero_dp2_tp2_bf16"] = _zm_train(hvd, torch, ZM_SHAPES["dp2_tp2"], params_bf16,
                                         "bfloat16", zero=True)
    for zero in (True, False):
        out[f"sp_zero{int(zero)}"] = _zm_train(hvd, torch, {"dp": 2, "sp": 2}, zero=zero,
                                               shard_seq=True)
        out[f"moe_zero{int(zero)}"] = _zm_train(
            hvd, torch, {"dp": 2, "ep": 2}, zero=zero, moe_aux_weight=0.01, n_experts=4,
            moe_every=2)
    out["line"] = _zero_on_line(hvd, torch, rank)
    out["raises"] = _zero_mesh_raises(hvd, torch)
    return out


def _fsdp_raises(hvd, torch) -> dict:
    """The combinations FSDP_RULES does not run (Switch experts under tp,
    pp, the optimizer's gradient accumulation on FSDP-cut parameters, and
    the BERT encoder), on a world of four; dp x sp x tp on a mesh of eight
    named without its communicators (the refusal comes before any
    collective)."""
    import dataclasses

    from horovod_tpu_torch.models.transformer import TransformerEncoder, TransformerLM
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    def build(shape, **overrides):
        def run():
            mesh = hvd.create_mesh(shape)
            cfg = dataclasses.replace(zm_config(torch), **overrides)
            TransformerLM(cfg, device="cpu", mesh=mesh, rules=FSDP_RULES)
        return run

    def accumulate():
        mesh = hvd.create_mesh({"dp": 4})
        model = TransformerLM(zm_config(torch), device="cpu", mesh=mesh, rules=FSDP_RULES)
        hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()), axis_name="dp",
                                 backward_passes_per_step=2)

    def dp_sp_tp():    # eight ranks: named on a mesh without communicators
        cfg = zm_config(torch)
        TransformerLM(cfg, device="cpu", rules=FSDP_RULES,
                      mesh=paper_mesh(torch, {"dp": 2, "sp": 2, "tp": 2}))

    return {"dp_sp_tp": _raises(dp_sp_tp),
            "moe_tp": _raises(build({"dp": 2, "tp": 2}, n_experts=4)),
            "pp": _raises(build({"dp": 2, "pp": 2})),
            "accumulation": _raises(accumulate),
            "bert": _raises(lambda: TransformerEncoder(
                zm_config(torch), device="cpu", mesh=hvd.create_mesh({"dp": 4}),
                rules=FSDP_RULES))}


def _run_fsdp_world(rank: int, size: int, params_f32, params_bf16) -> dict:
    """On two ranks: FSDP_RULES on dp=2 (the plain optimizer and a
    DistributedOptimizer passed in), the initialisation from torch seed 0.
    On four: FSDP_RULES on dp=2 x tp=2, f32 and bf16, the initialisation,
    and what raises."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    name = "dp2" if size == 2 else "dp2_tp2"
    shape = ZM_SHAPES[name]
    out = {f"fsdp_{name}": _zm_train(hvd, torch, shape, params_f32, fsdp=True)}
    mesh = hvd.create_mesh(shape)
    model = TransformerLM(zm_config(torch), device="cpu", mesh=mesh, rules=FSDP_RULES,
                          generator=torch.Generator().manual_seed(0))
    out["init"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    out["marked"] = sorted(n for n, p in model.named_parameters() if hasattr(p, "fsdp"))
    if size == 2:
        out["fsdp_dp2_passed"] = _zm_train(hvd, torch, shape, params_f32, fsdp=True,
                                           plain=False)
        return out
    out[f"fsdp_{name}_bf16"] = _zm_train(hvd, torch, shape, params_bf16, "bfloat16",
                                         fsdp=True)
    out["raises"] = _fsdp_raises(hvd, torch)
    return out


# ---------------------------------------------------------------------------
# ViT over dp and dropout under tp (tests/test_torch_port_vit.py)
VIT_B, VIT_STEPS, VIT_LR = 4, 3, 0.01
DROP_RATE, DROP_SEED, DROP_STEPS = 0.25, 7, 2


def vit_batch(seed: int = 3):
    """vit-tiny's registry images (numpy seed ``seed``) and labels in [0, 10)."""
    rng = np.random.RandomState(seed)
    images = rng.rand(VIT_B, 32, 32, 3).astype(np.float32)
    return images, rng.randint(0, 10, VIT_B).astype(np.int32)


def vit_train(hvd, torch, state_dict, mesh, steps: int = VIT_STEPS) -> dict:
    """vit-tiny in f32 from ``state_dict``, ``steps`` SGD(0.01, momentum
    0.9) steps through make_train_step on ``mesh`` on the global batch."""
    import dataclasses

    from horovod_tpu_torch.models.vit import VIT_CONFIGS, ViT
    from horovod_tpu_torch.parallel.train import make_train_step, softmax_xent

    model = ViT(dataclasses.replace(VIT_CONFIGS["vit-tiny"], dtype=torch.float32),
                device="cpu", mesh=mesh)
    model.load_state_dict(state_dict)
    opt = torch.optim.SGD(model.parameters(), lr=VIT_LR, momentum=0.9)
    init_fn, step_fn = make_train_step(model, opt, softmax_xent, mesh=mesh)
    state = init_fn()
    images, labels = (torch.from_numpy(a) for a in vit_batch())
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, images, labels)
        losses.append(float(loss))
    return {"losses": np.array(losses),
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def dropout_gpt(torch, mesh, rate: float = DROP_RATE):
    """gpt2-tiny at vocab 128 in f32 with FFN dropout, torch seed 0, on
    ``mesh`` (None: no mesh)."""
    import dataclasses

    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS, TransformerLM

    cfg = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], vocab_size=128, max_len=16,
                              dtype=torch.float32, dropout_rate=rate)
    return TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                         mesh=mesh)


def dropout_train(hvd, torch, mesh, steps: int = DROP_STEPS) -> dict:
    """``steps`` SGD(0.1) steps of ``dropout_gpt`` with make_train_step(dropout=
    True, dropout_seed=DROP_SEED); the losses and the tp-joined parameters."""
    from horovod_tpu_torch.models.convert import tp_join
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    model = dropout_gpt(torch, mesh)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh, dropout=True,
                                       dropout_seed=DROP_SEED)
    state = init_fn()
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 128, (4, 16)).astype(np.int32))
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    out = {"losses": np.array(losses)}
    tp = mesh.shape.get("tp", 1) if mesh is not None else 1
    if tp > 1:
        # The replicated tensors, bitwise on the tp line (the same masks).
        out["replicas_bitwise"] = all(
            torch.equal(p.detach(), hvd.broadcast(p.detach(), root_rank=0, axis_name="tp"))
            for p in model.parameters() if not hasattr(p, "tensor_parallel"))
        sd = tp_join([{k: hvd.broadcast(v, root_rank=r, axis_name="tp") for k, v in sd.items()}
                      for r in range(tp)], model.cfg)
    out["params"] = {k: v.numpy().copy() for k, v in sd.items()}
    return out


def _run_vit_world(rank: int, size: int, state_dict) -> dict:
    """vit-tiny over dp=2; then gpt2-tiny with dropout over tp=2, whose
    replicated parameters must stay bitwise on the tp line."""
    import torch

    import horovod_tpu_torch as hvd

    out = {"vit": vit_train(hvd, torch, state_dict, hvd.create_mesh({"dp": size})),
           "dropout_tp": dropout_train(hvd, torch, hvd.create_mesh({"tp": size}))}
    hvd.barrier()
    return out


# ---------------------------------------------------------------------------
# train_mnist on 2 ranks (tests/test_torch_port_mnist.py)
MNIST_ARGS = ["--epochs", "1", "--steps", "3", "--batch-size", "16"]


def _run_mnist_world(rank: int, size: int) -> dict:
    from horovod_tpu_torch import train_mnist

    # train_mnist shuts the world down when it returns.
    out = train_mnist.main(MNIST_ARGS + ["--device", "cpu"])
    for key in ("initial", "final"):
        out[key] = {k: v.numpy() for k, v in out[key].items()}
    return out


# ---------------------------------------------------------------------------
# tp under pp (tests/test_torch_port_pp_tp.py): PipelinedLM at the
# reference's configuration (PLM_*, tests/test_parallel.py:135-172) on pp=2
# x tp=2 (rank 2·p + t holds stage p and tp index t) and on the reference's
# pp=2 x dp=2 x tp=2 (rank 4·p + 2·d + t).
PPTP_MESH = {"pp": 2, "tp": 2}
PPDPTP_MESH = {"pp": 2, "dp": 2, "tp": 2}
# The refusals that stay (ROADMAP A3) -> (mesh, config overrides). A mesh
# larger than the four-rank world is named without groups (``paper_mesh``):
# the refusal comes before any collective.
PPTP_RAISES = {
    "sp_tp": ({"pp": 2, "sp": 2, "tp": 2}, {}),
    "sp_tp_ring": ({"pp": 2, "sp": 2, "tp": 2}, {"attn_impl": "ring"}),
    "tied_head": (PPTP_MESH, {"logits_via_embedding": True}),
}
# The combinations that raised before pp ran under sp and ep -> (mesh,
# config overrides): each now runs, and its logits are the rank's part of
# the JAX PipelinedLM's (ring and Ulysses without an sp line fall back to
# dense attention, as in JAX).
PPTP_RUNS = {
    "sp": ({"pp": 2, "sp": 2}, {}),
    "ep": ({"pp": 2, "ep": 2}, {}),
    "ring": (PPTP_MESH, {"attn_impl": "ring"}),
    "ulysses": (PPTP_MESH, {"attn_impl": "ulysses"}),
}
PPTP_REMAT_DTYPES = ("float32", "bfloat16")


def plm_config(torch, dtype: str = "float32", **overrides):
    """The port's config of the reference's PipelinedLM (vocab 128, d_model
    32, 4 heads, 4 layers, d_ff 64, scan-stacked)."""
    from horovod_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=128, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                             max_len=64, scan_layers=True, dtype=getattr(torch, dtype),
                             **overrides)


def _pptp_model(torch, mesh, params, dtype: str = "float32", generator=None, **overrides):
    """PipelinedLM (PLM_M microbatches) on ``mesh``, loaded with this
    rank's stage and tp shard of the JAX tree ``params`` where given."""
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.pipelined import PipelinedLM

    cfg = plm_config(torch, dtype, **overrides)
    model = PipelinedLM(cfg, mesh, num_microbatches=PLM_M, device="cpu", generator=generator)
    if params is not None:
        model.load_state_dict(flax_to_torch(
            params, cfg, stages=mesh.shape["pp"], stage=mesh.coords["pp"],
            tp=mesh.shape.get("tp", 1), tp_rank=mesh.coords.get("tp", 0)))
    return model


def paper_mesh(torch, shape: dict):
    """A mesh of ``shape`` that names this rank's coordinates (its rank
    modulo the mesh's size) and holds no communicator: enough for a model
    that refuses the mesh before its first collective."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import Mesh, axis_names_in_order, coords_of

    names = axis_names_in_order(shape)
    n = int(np.prod([shape[a] for a in names]))
    return Mesh(axis_names=names, shape=dict(shape),
                coords=coords_of(hvd.rank() % n, names, shape),
                device=torch.device("cpu"), _comms={})


def _pptp_runs(hvd, torch, params) -> dict:
    """Each PPTP_RUNS case's f32 logits of the whole batch from the JAX
    tree ``params``, with this rank's coordinates on its mesh."""
    out = {}
    for name, (shape, overrides) in PPTP_RUNS.items():
        mesh = hvd.create_mesh(shape)
        model = _pptp_model(torch, mesh, params, **overrides)
        ids = torch.from_numpy(plm_ids())
        sp, j = mesh.shape.get("sp", 1), mesh.coords.get("sp", 0)
        with torch.no_grad():
            logits = model(ids.chunk(sp, dim=1)[j])
        out[name] = {"coords": dict(mesh.coords), "logits": logits.float().numpy()}
    return out


def _pptp_grads(torch, model, mesh):
    """One forward and backward of the vocab-parallel lm_loss on the whole
    batch: the loss and the gradients by name."""
    from horovod_tpu_torch.parallel.tensor import vocab_parallel_lm_loss

    ids = torch.from_numpy(plm_ids())
    loss = vocab_parallel_lm_loss(model(ids), ids, mesh.comm("tp"), model.cfg.vocab_size)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _pptp_train(hvd, torch, mesh, params, **overrides) -> dict:
    """PLM_STEPS Adam(PLM_LR) steps through make_train_step (the plain
    optimizer, which the step wraps over the ("dp", "sp") line;
    ``shard_seq``) from the JAX tree ``params``, the config's ``overrides``
    applied: the losses, the parameters and this rank's coordinates."""
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    model = _pptp_model(torch, mesh, params, **overrides)
    opt = torch.optim.Adam(model.parameters(), lr=PLM_LR)
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh, shard_seq=True)
    state = init_fn()
    ids = torch.from_numpy(plm_ids())
    losses = []
    for _ in range(PLM_STEPS):
        state, loss = step_fn(state, ids, ids)
        losses.append(float(loss))
    return {"coords": dict(mesh.coords), "losses": np.array(losses),
            "params": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


def _pptp_remat(torch, mesh, params) -> dict:
    """By dtype: the loss and the gradients' names where remat differs from
    no remat (one forward and backward each, from the same weights)."""
    out = {}
    for dtype in PPTP_REMAT_DTYPES:
        (l0, g0), (l1, g1) = (_pptp_grads(torch, _pptp_model(torch, mesh, params, dtype,
                                                             remat=remat), mesh)
                              for remat in (False, True))
        out[dtype] = {"losses": [float(l0), float(l1)], "loss_bitwise": bool(torch.equal(l0, l1)),
                      "differ": sorted(k for k in g0 if not torch.equal(g0[k], g1[k]))}
    return out


def _pptp_raises(hvd, torch) -> dict:
    """The message each PPTP_RAISES case raises with (or "no error")."""
    from horovod_tpu_torch.models.pipelined import PipelinedLM

    out = {}
    for name, (shape, overrides) in PPTP_RAISES.items():
        size = int(np.prod(list(shape.values())))
        mesh = hvd.create_mesh(shape) if size == hvd.size() else paper_mesh(torch, shape)
        out[name] = _raises(lambda: PipelinedLM(plm_config(torch, **overrides), mesh,
                                                device="cpu"), (NotImplementedError,))
    return out


def _run_pp_tp_world(rank: int, size: int, params_by_dtype, train_params) -> dict:
    """On pp=2 x tp=2: PipelinedLM from the JAX TransformerLM's weights in
    bf16 and f32, this rank's logits shard of the whole batch; in f32 its
    gradients of the vocab-parallel lm_loss; the model from torch seed 0
    (its state_dict); PLM_STEPS Adam steps from ``train_params``; remat
    against no remat; the refusals that stay; the combinations that now
    run (PPTP_RUNS); last, ``train_gpt2 --pp 2 --tp 2``."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd

    mesh = hvd.create_mesh(PPTP_MESH)
    out = {"coords": dict(mesh.coords)}
    for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        model = _pptp_model(torch, mesh, params_by_dtype[name], dtype)
        with torch.no_grad():
            out[f"logits_{name}"] = model(torch.from_numpy(plm_ids())).float().numpy()
    loss, grads = _pptp_grads(torch, _pptp_model(torch, mesh, params_by_dtype["f32"]), mesh)
    out["loss"] = float(loss)
    out["grads"] = {k: g.numpy() for k, g in grads.items()}
    init = _pptp_model(torch, mesh, None, generator=torch.Generator().manual_seed(0))
    out["init"] = {k: v.numpy().copy() for k, v in init.state_dict().items()}
    out["train"] = _pptp_train(hvd, torch, mesh, train_params)
    out["remat"] = _pptp_remat(torch, mesh, params_by_dtype["f32"])
    out["raises"] = _pptp_raises(hvd, torch)
    out["runs"] = _pptp_runs(hvd, torch, params_by_dtype["f32"])
    from horovod_tpu_torch import train_gpt2

    # Last: train_gpt2 shuts the world down when it returns.
    out["train_gpt2"] = np.array(train_gpt2.main(
        ["--model", "gpt2-tiny", "--batch-size", "4", "--seq-len", "32", "--steps", "2",
         "--pp", "2", "--tp", "2", "--attn", "flash", "--remat", "--device", "cpu"]))
    return out


def _run_pp_dp_tp_world(rank: int, size: int, train_params) -> dict:
    """On pp=2 x dp=2 x tp=2: PLM_STEPS Adam steps from ``train_params``."""
    import torch

    torch.set_num_threads(1)    # eight ranks share the host's cores

    import horovod_tpu_torch as hvd

    return _pptp_train(hvd, torch, hvd.create_mesh(PPDPTP_MESH), train_params)


# ---------------------------------------------------------------------------
# pp under sp and ep (tests/test_torch_port_pp_sp.py): PipelinedLM at the
# reference's configuration (PLM_*) on pp=2 x sp=2 (rank 2·p + s holds
# stage p and sp index s), on pp=2 x ep=2 and on pp=2 x dp=2 x sp=2 (rank
# 4·p + 2·d + s).
PPSP_MESH = {"pp": 2, "sp": 2}
PPDPSP_MESH = {"pp": 2, "dp": 2, "sp": 2}
PPEP_MESH = {"pp": 2, "ep": 2}
PPSP_ATTNS = ("dense", "flash", "ring", "ulysses", "ulysses_flash")
PPSP_REMAT = (("ring", "float32"), ("ring", "bfloat16"), ("ulysses_flash", "float32"),
              ("ulysses_flash", "bfloat16"))


def ppsp_overrides(attn: str) -> dict:
    """The config fields of an attention route ("ulysses_flash": Ulysses
    through the flash kernels' plain version on the CPU)."""
    if attn == "ulysses_flash":
        return {"attn_impl": "ulysses", "sp_use_flash": True}
    return {"attn_impl": attn}


def _ppsp_grads(torch, model, mesh):
    """One forward and backward of this rank's share of the
    sequence-sharded lm_loss (``make_train_step``'s, group = the sp line):
    the loss share and this rank's gradients by name, not yet averaged
    over sp."""
    from horovod_tpu_torch.parallel.train import _cut, _lm_loss_sharded

    ids = torch.from_numpy(plm_ids())
    loss = _lm_loss_sharded(model(_cut(ids, mesh, True)), ids, mesh, mesh.shape["sp"])
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _ppsp_remat(torch, mesh, params) -> dict:
    """By (attention, dtype) of PPSP_REMAT: whether the loss share is
    bitwise, and the gradients' names where remat differs from no remat."""
    out = {}
    for attn, dtype in PPSP_REMAT:
        (l0, g0), (l1, g1) = (_ppsp_grads(torch, _pptp_model(
            torch, mesh, params, dtype, remat=remat, **ppsp_overrides(attn)), mesh)
            for remat in (False, True))
        out[f"{attn}-{dtype}"] = {"loss_bitwise": bool(torch.equal(l0, l1)),
                                  "differ": sorted(k for k in g0 if not torch.equal(g0[k],
                                                                                     g1[k]))}
    return out


def _run_pp_sp_world(rank: int, size: int, params, train_params) -> dict:
    """On pp=2 x sp=2: PipelinedLM from the JAX TransformerLM's weights
    ``params`` under every PPSP_ATTNS route, in bf16 and f32, this rank's
    logits block; in f32 its gradients of its share of the sequence-sharded
    lm_loss; the f32 model's loaded state_dict; the model from torch seed 0;
    PLM_STEPS Adam steps from ``train_params`` under every route; remat
    against no remat; then on pp=2 x ep=2 the same steps with dense
    attention; last, ``train_gpt2 --pp 2 --sp 2 --attn ulysses
    --sp-use-flash --remat``."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.train import _cut

    mesh = hvd.create_mesh(PPSP_MESH)
    ids = _cut(torch.from_numpy(plm_ids()), mesh, True)     # this rank's sp block
    out = {"coords": dict(mesh.coords), "logits": {}, "grads": {}, "loss": {}, "train": {}}
    for attn in PPSP_ATTNS:
        for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
            model = _pptp_model(torch, mesh, params, dtype, **ppsp_overrides(attn))
            with torch.no_grad():
                out["logits"][f"{attn}-{name}"] = model(ids).float().numpy()
        loss, grads = _ppsp_grads(torch, _pptp_model(torch, mesh, params,
                                                     **ppsp_overrides(attn)), mesh)
        out["loss"][attn] = float(loss)
        out["grads"][attn] = {k: g.numpy() for k, g in grads.items()}
    out["loaded"] = {k: v.numpy().copy()
                     for k, v in _pptp_model(torch, mesh, params).state_dict().items()}
    init = _pptp_model(torch, mesh, None, generator=torch.Generator().manual_seed(0))
    out["init"] = {k: v.numpy().copy() for k, v in init.state_dict().items()}
    for attn in PPSP_ATTNS:
        out["train"][attn] = _pptp_train(hvd, torch, mesh, train_params,
                                         **ppsp_overrides(attn))
    out["remat"] = _ppsp_remat(torch, mesh, params)
    out["train_ep"] = _pptp_train(hvd, torch, hvd.create_mesh(PPEP_MESH), train_params)
    from horovod_tpu_torch import train_gpt2

    # Last: train_gpt2 shuts the world down when it returns.
    out["train_gpt2"] = np.array(train_gpt2.main(
        ["--model", "gpt2-tiny", "--batch-size", "4", "--seq-len", "32", "--steps", "2",
         "--pp", "2", "--sp", "2", "--attn", "ulysses", "--sp-use-flash", "--remat",
         "--device", "cpu"]))
    return out


def _run_pp_dp_sp_world(rank: int, size: int, train_params) -> dict:
    """On pp=2 x dp=2 x sp=2: PLM_STEPS Adam steps from ``train_params``."""
    import torch

    torch.set_num_threads(1)    # eight ranks share the host's cores

    import horovod_tpu_torch as hvd

    return _pptp_train(hvd, torch, hvd.create_mesh(PPDPSP_MESH), train_params)


# ---------------------------------------------------------------------------
# The eager engine and the binding (tests/test_torch_port_{engine,binding}.py)
ENGINE_ROUNDS = 3          # all-reduces of the uneven-join case (the last rank: 1)
ENGINE_MANY = 6            # tensors of the fused grouped all-reduce
ENGINE_STEADY = 12         # passes of the steady-state tensor
STALL_DELAY = 2.5          # seconds rank 1 holds back the stalled tensor
TIMELINE_TENSORS = ("allreduce.tl0", "allreduce.tl1", "allgather.tlg", "broadcast.tlb")


def engine_inputs(rank: int, size: int) -> dict:
    """Each rank's numpy inputs to the engine's collectives (seeded), which
    the tests feed to the JAX engine too."""
    rng = np.random.RandomState(200 + rank)
    return {
        "f32": rng.randn(5, 3).astype(np.float32),
        "many": [rng.randn(2 + i).astype(np.float32) for i in range(ENGINE_MANY)],
        "int": np.array([2, 4, 6], np.int64) * (rank + 1),
        "ag": np.arange((rank + 1) * 2, dtype=np.float32).reshape(rank + 1, 2) + 10 * rank,
        "a2a": (np.arange(size * (rank + 1) * 2, dtype=np.float32)
                .reshape(size * (rank + 1), 2) + 100 * rank),
        "bcast": np.full(3, rank * 10, np.float32),
        "join": np.full(2, float(rank + 1), np.float32),
        "perm": [rng.randn(4).astype(np.float32) for _ in range(4)],
    }


def _stall_messages(hvd, rank: int) -> list:
    """Rank 1 holds back tensor ``late`` for STALL_DELAY seconds; rank 0's
    coordinator warns (HOROVOD_STALL_CHECK_TIME_SECONDS=1). The warnings the
    engine's logger emitted on this rank."""
    import logging
    import time

    import torch

    from horovod_tpu_torch.utils.logging import get_logger

    got = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    handler = Keep(level=logging.WARNING)
    get_logger().addHandler(handler)
    try:
        if rank == 1:
            time.sleep(STALL_DELAY)
        hvd.allreduce(torch.ones(2), name="late", op=hvd.Sum)
    finally:
        get_logger().removeHandler(handler)
    return got


def _run_engine_world(rank: int, size: int, timeline: str) -> dict:
    """The world collectives through the engine on ``engine_inputs``: SUM,
    AVERAGE, MIN, MAX, PRODUCT, a fused group, integer AVERAGE, ragged
    allgather, uneven alltoall, broadcast from each root, permuted
    asynchronous submission, an uneven join, a stall and the timeline
    (rank 0 writes it at shutdown, which this body calls itself)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import chrome_trace

    inp = engine_inputs(rank, size)
    t = {k: torch.from_numpy(v) for k, v in inp.items() if isinstance(v, np.ndarray)}
    out = {"sum": hvd.allreduce(t["f32"], name="f32", op=hvd.Sum).numpy(),
           "avg": hvd.allreduce(t["f32"], name="f32avg").numpy()}
    for op in ("MIN", "MAX", "PRODUCT"):
        out[op] = hvd.allreduce(t["f32"], name=op, op=getattr(hvd.ReduceOp, op)).numpy()
    out["many"] = [g.numpy() for g in hvd.grouped_allreduce(
        [torch.from_numpy(m) for m in inp["many"]], name="many", op=hvd.Sum)]
    out["iavg"] = hvd.allreduce(t["int"], name="iavg").numpy()
    out["ag"] = hvd.allgather(t["ag"], name="ag").numpy()
    got, recv = hvd.alltoall(t["a2a"], splits=[rank + 1] * size, name="a2a")
    out["a2a"], out["a2a_splits"] = got.numpy(), recv
    for root in range(size):
        out[f"bcast_{root}"] = hvd.broadcast(t["bcast"], root, name=f"b{root}").numpy()
    order = [(i + rank) % 4 for i in range(4)]   # each rank submits in its own order
    handles = {i: hvd.allreduce_async(torch.from_numpy(inp["perm"][i]), name=f"perm{i}",
                                      op=hvd.Sum) for i in order}
    out["perm"] = [hvd.synchronize(handles[i]).numpy() for i in range(4)]
    steady = [hvd.allreduce(torch.ones(3) * (rank + 1), name="steady", op=hvd.Sum).numpy()
              for _ in range(ENGINE_STEADY)]
    out["steady"] = steady
    out["counters"] = hvd.common.basics.engine().counters()
    joins = []
    for i in range(ENGINE_ROUNDS if rank != size - 1 else 1):
        joins.append(hvd.allreduce(t["join"], name=f"j{i}").numpy())
    out["join"] = joins
    out["last_joined"] = hvd.join()
    out["stall"] = _stall_messages(hvd, rank)
    for name in ("tl0", "tl1"):
        hvd.allreduce(torch.ones(4) * rank, name=name)
    hvd.allgather(t["ag"], name="tlg")
    hvd.broadcast(t["bcast"], 0, name="tlb")
    hvd.barrier()
    eng = hvd.common.basics.engine()
    tids = dict(eng.timeline._tids)
    hvd.shutdown()
    if rank == 0:
        out["timeline"] = chrome_trace.trace_events(chrome_trace.read_trace_file(timeline))
        out["tids"] = tids
    return out


def _run_transport_world(rank: int, size: int) -> dict:
    """The engine's control plane alone, on a gloo group of its own: bytes
    gathered and broadcast, 64-bit words and-ed and or-ed, a barrier."""
    import torch.distributed as dist

    from horovod_tpu_torch.engine.transport import GlooTransport

    tr = GlooTransport(dist.new_group(backend="gloo"), rank, size)
    words = [(1 << 63) | (1 << rank), 0xFFFF_FFFF_FFFF_FFFF ^ (1 << rank)]
    tr.barrier()
    return {"gathered": tr.gather_bytes(bytes([rank]) * (rank + 1)),
            "bcast": tr.bcast_bytes(b"coordinator" if rank == 0 else None),
            "empty": tr.bcast_bytes(b"" if rank == 0 else None),
            "and": tr.allreduce_words(words, "and"),
            "or": tr.allreduce_words(words, "or")}


# The binding's optimizer cases: name -> (inner, DistributedOptimizer kwargs).
BINDING_CASES = {
    "sgd": ("sgd", {}),
    "adamw": ("adamw", {}),
    "bpps2": ("sgd", {"backward_passes_per_step": 2}),
    "predivide": ("sgd", {"gradient_predivide_factor": 4.0}),
    "sum": ("adamw", {"op": "Sum"}),
}
BINDING_STEPS = 3


def seeded_params_(module, seed: int):
    """Every parameter of ``module`` drawn from numpy ``seed`` (the torch
    generator is process-wide, and the JAX binding's ranks are threads)."""
    import torch

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy((0.4 * rng.randn(*p.shape)).astype(np.float32)))
    return module


def binding_net(torch):
    return seeded_params_(torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                              torch.nn.Linear(8, 3)), 0)


def binding_batch(rank: int, step: int):
    rng = np.random.RandomState(300 + 10 * rank + step)
    return rng.randn(5, 6).astype(np.float32), rng.randn(5, 3).astype(np.float32)


def binding_train(hvd_torch, torch, case: str, rank: int) -> dict:
    """BINDING_STEPS steps (twice as many backward passes under
    ``backward_passes_per_step=2``) of the binding's ``DistributedOptimizer``
    on ``binding_net`` and ``binding_batch``; the parameters after."""
    inner, kw = BINDING_CASES[case]
    kw = dict(kw)
    if "op" in kw:
        kw["op"] = getattr(hvd_torch, kw["op"])
    net = binding_net(torch)
    base = (torch.optim.SGD(net.parameters(), lr=0.1) if inner == "sgd"
            else torch.optim.AdamW(net.parameters(), lr=1e-2))
    opt = hvd_torch.DistributedOptimizer(base, named_parameters=net.named_parameters(), **kw)
    passes = kw.get("backward_passes_per_step", 1)
    for step in range(BINDING_STEPS * passes):
        x, y = (torch.from_numpy(a) for a in binding_batch(rank, step))
        if step % passes == 0:
            opt.zero_grad()
        torch.nn.functional.mse_loss(net(x), y).backward()
        opt.step()
    return {n: p.detach().numpy().copy() for n, p in net.named_parameters()}


def binding_extras(hvd_torch, torch, rank: int) -> dict:
    """The guards, ``skip_synchronize`` with clipping between the
    reduction and the step, and the Adasum delta optimizer's first step
    with its oracle inputs (the start weights and the local Adam step's)."""
    import copy

    out = {}
    net = binding_net(torch)

    def error(fn):
        try:
            fn()
        except Exception as e:   # the tests read which error it was
            return f"{type(e).__name__}: {e}"
        return "no error"

    out["predivide_sum"] = error(lambda: hvd_torch.DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=0.1), op=hvd_torch.Sum,
        gradient_predivide_factor=2.0))
    dup = [("w", p) for p in net.parameters()]
    out["duplicate"] = error(lambda: hvd_torch.DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=0.1), named_parameters=dup))
    opt = hvd_torch.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.1),
                                         named_parameters=net.named_parameters())
    x, y = (torch.from_numpy(a) for a in binding_batch(rank, 0))
    opt.zero_grad()
    torch.nn.functional.mse_loss(net(x), y).backward()
    opt.synchronize()
    out["clip_norm"] = float(torch.nn.utils.clip_grad_norm_(net.parameters(), 0.05))
    with opt.skip_synchronize():
        opt.step()
    out["skip_sync"] = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}

    model = seeded_params_(torch.nn.Linear(4, 2), 1)
    start = copy.deepcopy(model)
    ref = copy.deepcopy(model)
    ada = hvd_torch.DistributedOptimizer(torch.optim.Adam(model.parameters(), lr=0.05),
                                         named_parameters=model.named_parameters(),
                                         op=hvd_torch.Adasum)
    ada.synchronize()
    out["adasum_skip"] = error(lambda: ada.skip_synchronize().__enter__())
    rng = np.random.RandomState(rank + 1)
    X = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    Y = torch.from_numpy(rng.randn(8, 2).astype(np.float32))
    ada.zero_grad()
    torch.nn.functional.mse_loss(model(X), Y).backward()
    ada.step()
    ref_opt = torch.optim.Adam(ref.parameters(), lr=0.05)
    torch.nn.functional.mse_loss(ref(X), Y).backward()
    ref_opt.step()
    out["adasum"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    out["adasum_start"] = {n: p.detach().numpy().copy() for n, p in start.named_parameters()}
    out["adasum_local"] = {n: p.detach().numpy().copy() for n, p in ref.named_parameters()}
    return out


def _run_binding_world(rank: int, size: int) -> dict:
    import torch

    import horovod_tpu_torch.torch as hvd_torch

    out = {case: binding_train(hvd_torch, torch, case, rank) for case in BINDING_CASES}
    out.update(binding_extras(hvd_torch, torch, rank))
    t = torch.ones(3) * (rank + 1)
    out["inplace"] = hvd_torch.allreduce_(t).numpy().copy()
    w = torch.full((2,), float(rank + 1), requires_grad=True)
    hvd_torch.allreduce(w, name="w", op=hvd_torch.Sum).sum().backward()
    out["allreduce_grad"] = w.grad.numpy().copy()
    b = torch.full((2,), float(rank))
    hvd_torch.broadcast_(b, 1)
    out["broadcast_"] = b.numpy().copy()
    out["dropped_optimizer_freed"] = _dropped_optimizer_freed(hvd_torch, torch)
    return out


def _dropped_optimizer_freed(hvd_torch, torch) -> bool:
    """A model and its hook optimizer, trained a step and dropped, are
    collected (the hooks must not hold the optimizer)."""
    import gc
    import weakref

    net = binding_net(torch)
    opt = hvd_torch.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.1),
                                         named_parameters=net.named_parameters(),
                                         backward_passes_per_step=1)
    x, y = (torch.from_numpy(a) for a in binding_batch(0, 0))
    torch.nn.functional.mse_loss(net(x), y).backward()
    opt.step()
    refs = [weakref.ref(opt), weakref.ref(next(net.parameters()))]
    del net, opt
    gc.collect()
    return all(r() is None for r in refs)


# ---------------------------------------------------------------------------
# The metrics plane (tests/test_torch_port_telemetry.py)

def telemetry_ops(eng, rank: int, size: int, as_tensor) -> None:
    """One sequence of named collectives through either package's engine
    API (``as_tensor`` makes its tensor from a numpy array): all-reduces one
    at a time and three in flight together, ragged all-gathers, a broadcast
    from every root and an all-to-all."""
    rng = np.random.RandomState(7)
    for i in range(4):
        x = rng.randn(3, 4).astype(np.float32) * (rank + 1)
        eng.synchronize(eng.enqueue_allreduce(as_tensor(x), name=f"ar{i}"))
    hs = [eng.enqueue_allreduce(as_tensor(np.full(5 + i, rank, np.float32)), name=f"many{i}")
          for i in range(3)]
    for h in hs:
        eng.synchronize(h)
    for i in range(2):
        eng.synchronize(eng.enqueue_allgather(
            as_tensor(np.ones((rank + 1 + i, 3), np.float32)), name=f"ag{i}"))
    for root in range(size):
        eng.synchronize(eng.enqueue_broadcast(
            as_tensor(np.arange(6, dtype=np.int64) * rank), root, name=f"bc{root}"))
    eng.synchronize(eng.enqueue_alltoall(as_tensor(np.ones((2 * size, 2), np.float32)),
                                         [2] * size, name="a2a"))


def _run_telemetry_world(rank: int, size: int) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    eng = hvd.common.basics.engine()
    before = eng.registry.snapshot()
    telemetry_ops(eng, rank, size, torch.from_numpy)
    return {"before": before, "after": eng.registry.snapshot()}


def _run_fleet_world(rank: int, size: int, wait_s: float) -> dict:
    """Rank r all-gathers (r + 1) * 4 floats three times; once every rank
    is past them, each reads its own series, and after ``wait_s`` of idle
    cycles (each pushing its snapshot) rank 0 reads the fleet view."""
    import time

    import torch

    import horovod_tpu_torch as hvd

    eng = hvd.common.basics.engine()
    for i in range(3):
        eng.synchronize(eng.enqueue_allgather(torch.ones((rank + 1) * 4), name=f"fl{i}"))
    eng.synchronize(eng.enqueue_allreduce(torch.zeros(1), name="past"))
    own = hvd.metrics()
    time.sleep(wait_s)
    fleet = hvd.metrics().get("fleet")
    eng.synchronize(eng.enqueue_allreduce(torch.zeros(1), name="read"))
    return {"own": own["metrics"], "mode": own["mode"], "status": own.get("status"),
            "fleet": fleet}


# ---------------------------------------------------------------------------
# FSDP under sp (tests/test_torch_port_fsdp_sp.py)
FSDPSP_MESH = {"dp": 2, "sp": 2}
FSDPSP_ATTNS = PPSP_ATTNS
# The bf16 route, and the route run on the after-backward (grouped) path.
FSDPSP_BF16 = "ulysses_flash"
FSDPSP_GROUPED = "ring"


def _run_fsdp_sp_world(rank: int, size: int, params_f32, params_bf16) -> dict:
    """On dp=2 x sp=2 under FSDP_RULES, with shard_seq, from the numpy
    weights (each rank loading its dp cut): every route in f32 with the
    plain AdamW (the parameters after every step) and with a
    DistributedOptimizer over ("dp", "sp") passed in, FSDPSP_BF16 in bf16,
    FSDPSP_GROUPED on the after-backward grouped reduction; the model from
    torch seed 0; the model loaded with this rank's cut of ``params_f32``
    by ``flax_to_torch(..., dp=, dp_rank=)``."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    runs = {}
    for attn in FSDPSP_ATTNS:
        kw = dict(fsdp=True, shard_seq=True, **ppsp_overrides(attn))
        runs[attn] = _zm_train(hvd, torch, FSDPSP_MESH, params_f32, per_step=True, **kw)
        runs[f"{attn}_passed"] = _zm_train(hvd, torch, FSDPSP_MESH, params_f32, plain=False,
                                           **kw)
    runs[f"{FSDPSP_BF16}_bf16"] = _zm_train(hvd, torch, FSDPSP_MESH, params_bf16, "bfloat16",
                                            fsdp=True, shard_seq=True,
                                            **ppsp_overrides(FSDPSP_BF16))
    runs[f"{FSDPSP_GROUPED}_grouped"] = _zm_train(
        hvd, torch, FSDPSP_MESH, params_f32, plain=False, opt_kw={"_schedule": "grouped"},
        fsdp=True, shard_seq=True, **ppsp_overrides(FSDPSP_GROUPED))
    mesh = hvd.create_mesh(FSDPSP_MESH)
    cfg = zm_config(torch)
    model = TransformerLM(cfg, device="cpu", mesh=mesh, rules=FSDP_RULES,
                          generator=torch.Generator().manual_seed(0))
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    model.load_state_dict(flax_to_torch(params_f32, cfg, dp=mesh.shape["dp"],
                                        dp_rank=mesh.coords["dp"]))
    # An optimizer whose line does not hold the cut's dp line cannot finish
    # the cut gradients' sum.
    off_line = _raises(lambda: hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters()), axis_name="sp"))
    return {"runs": runs, "coords": dict(mesh.coords), "init": init, "off_line": off_line,
            "loaded": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


# ---------------------------------------------------------------------------
# FSDP with Switch experts and ep (tests/test_torch_port_fsdp_moe.py): the
# zm model with FSDPMOE_E experts in block 1 (capacity 1.25, aux 0.01).
FSDPMOE_E, FSDPMOE_AUX = 4, 0.01
# name -> (mesh, attention route, Switch experts)
FSDPMOE_CASES = {
    "dp2_ep2": ({"dp": 2, "ep": 2}, "dense", True),
    "dp4": ({"dp": 4}, "dense", True),
    "dp2_sp2": ({"dp": 2, "sp": 2}, "ulysses", True),
    "dp2_ep2_dense": ({"dp": 2, "ep": 2}, "dense", False),
}
# The bf16 case, the case passed a DistributedOptimizer, the case on the
# after-backward grouped reduction.
FSDPMOE_BF16, FSDPMOE_PASSED, FSDPMOE_GROUPED = "dp2_ep2", "dp2_ep2", "dp2_sp2"


def fsdpmoe_overrides(name: str) -> dict:
    """A case's config fields beside ``zm_config``'s."""
    _, attn, moe = FSDPMOE_CASES[name]
    return {"attn_impl": attn, **({"n_experts": FSDPMOE_E} if moe else {})}


def _fsdpmoe_train(hvd, torch, name: str, params, dtype: str = "float32", **kw) -> dict:
    shape, _, moe = FSDPMOE_CASES[name]
    return _zm_train(hvd, torch, shape, params, dtype, fsdp=True,
                     shard_seq=shape.get("sp", 1) > 1,
                     moe_aux_weight=FSDPMOE_AUX if moe else 0.0, **kw,
                     **fsdpmoe_overrides(name))


def _run_fsdp_moe_world(rank: int, size: int, params_f32, params_bf16, params_dense) -> dict:
    """Each FSDPMOE_CASES case under FSDP_RULES from the numpy weights
    (each rank loading its ep slice and dp cut) with the plain AdamW (the
    parameters after every step); FSDPMOE_PASSED with a DistributedOptimizer
    over the ("dp", "sp") line passed in, FSDPMOE_GROUPED on the grouped
    after-backward reduction, FSDPMOE_BF16 in bf16; on {"dp": 2, "ep": 2}
    the model from torch seed 0, the model loaded by ``flax_to_torch(...,
    ep=, ep_rank=, dp=, dp_rank=)``, and the optimizers off the cut's line
    (over ep, and over ("dp", "ep"), which would sum the experts over ep)."""
    import torch

    torch.set_num_threads(2)    # four ranks share the host's cores

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    runs = {}
    for name, (_, _, moe) in FSDPMOE_CASES.items():
        runs[name] = _fsdpmoe_train(hvd, torch, name, params_f32 if moe else params_dense,
                                    per_step=True)
    runs["passed"] = _fsdpmoe_train(hvd, torch, FSDPMOE_PASSED, params_f32, plain=False)
    runs["grouped"] = _fsdpmoe_train(hvd, torch, FSDPMOE_GROUPED, params_f32, plain=False,
                                     opt_kw={"_schedule": "grouped"})
    runs["bf16"] = _fsdpmoe_train(hvd, torch, FSDPMOE_BF16, params_bf16, "bfloat16")
    mesh = hvd.create_mesh(FSDPMOE_CASES["dp2_ep2"][0])
    cfg = zm_config(torch, **fsdpmoe_overrides("dp2_ep2"))
    model = TransformerLM(cfg, device="cpu", mesh=mesh, rules=FSDP_RULES,
                          generator=torch.Generator().manual_seed(0))
    init = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    model.load_state_dict(flax_to_torch(params_f32, cfg, ep=2, ep_rank=mesh.coords["ep"],
                                        dp=2, dp_rank=mesh.coords["dp"]))

    def off_line(axes):
        return _raises(lambda: hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters()), axis_name=axes))

    return {"runs": runs, "coords": dict(mesh.coords), "init": init,
            "loaded": {k: v.numpy().copy() for k, v in model.state_dict().items()},
            "off_line": {"ep": off_line("ep"), "dp_ep": off_line(("dp", "ep"))}}
