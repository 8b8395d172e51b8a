"""Rank bodies and the worker script of tests/test_torch_port_elastic.py,
in a module of their own so spawned ranks import torch and
horovod_tpu_torch only (no jax, no test module). ``spawn`` runs a body on
gloo ranks that meet through a FileStore; a rank may die on purpose, so
the results come back through files, one a rank."""
from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

TOY = {"n_layers": 2, "max_len": 32}     # gpt2-tiny (d_model 128, 4 heads) cut to 2 layers


def toy_model(seed: int = 0):
    import torch

    from horovod_tpu_torch.models.registry import get_model

    gen = torch.Generator().manual_seed(seed)
    return get_model("gpt2-tiny").make_model(device="cpu", generator=gen, **TOY)


def toy_batch(batch: int, rank: int, vocab: int = 1024):
    """The ids of step ``batch`` on ``rank``: the same for a replayed step."""
    import torch

    gen = torch.Generator().manual_seed(1000 * batch + rank)
    return torch.randint(0, vocab, (2, 16), generator=gen)


def toy_step(model, opt, batch: int, rank: int) -> float:
    from horovod_tpu_torch.parallel.train import lm_loss

    ids = toy_batch(batch, rank)
    opt.zero_grad()
    loss = lm_loss(model(ids), ids)
    loss.backward()
    opt.step()
    return float(loss.detach())


def flat_state(model, opt) -> np.ndarray:
    """Every parameter and optimizer-state tensor, as one byte string."""
    import torch

    parts = [t.detach().reshape(-1).view(torch.uint8) for _, t in
             sorted(model.state_dict().items())]
    state = opt.state_dict()["state"]
    for pid in sorted(state):
        for key in sorted(state[pid]):
            v = state[pid][key]
            if isinstance(v, torch.Tensor):
                parts.append(v.detach().reshape(-1).contiguous().view(torch.uint8))
    return torch.cat(parts).numpy().copy()


def _init(rank: int, size: int, store: str):
    import horovod_tpu_torch as hvd

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    hvd.init(device="cpu", init_method=f"file://{store}")


def rank_main(rank: int, size: int, tmp: str, body: str, args) -> None:
    import torch

    torch.set_num_threads(1)
    os.environ["HOROVOD_CYCLE_TIME"] = "1"
    try:
        out = globals()[body](rank, size, tmp, *args)
    except BaseException:
        out = traceback.format_exc()
    with open(os.path.join(tmp, f"result.{rank}"), "wb") as f:
        pickle.dump(out, f)


def spawn(size: int, tmp: str, body: str, *args, timeout: float = 90) -> dict:
    """Each rank's result of ``body(rank, size, tmp, *args)``, by rank; a
    rank that died leaves no result. Ranks still alive at ``timeout`` are
    killed and the call fails."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, size, tmp, body, args))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"ranks {hung} of {body} still running after {timeout}s"
    results = {}
    for r in range(size):
        path = os.path.join(tmp, f"result.{r}")
        if os.path.exists(path):
            with open(path, "rb") as f:
                results[r] = pickle.load(f)
    for r, res in results.items():
        assert not isinstance(res, str), f"rank {r} of {body} failed:\n{res}"
    return results


def _run_dead_peer(rank: int, size: int, tmp: str, path: str) -> dict:
    """World of ``size``; the last rank dies while the others are in a
    collective (the engine's, or a direct one); the survivors report what
    they raised and how long shutdown took, then form a world of the
    survivors in the same process and all-reduce in it."""
    import torch

    import horovod_tpu_torch as hvd

    _init(rank, size, os.path.join(tmp, "store_a"))
    for i in range(3):
        hvd.allreduce(torch.ones(4), name=f"warm{i}")
    hvd.barrier()
    if rank == size - 1:
        time.sleep(0.3)
        os._exit(1)
    out = {}
    t0 = time.perf_counter()
    try:
        if path == "engine":
            hvd.allreduce(torch.ones(1 << 16), name="doomed", op=hvd.Sum)
        else:
            hvd.reducescatter(torch.ones(size * 4))    # direct, no engine
        out["raised"] = "nothing"
    except hvd.HorovodInternalError as e:
        out["raised"] = "HorovodInternalError"
        out["message"] = str(e)
    except Exception as e:  # noqa: BLE001 - reported to the test
        out["raised"] = type(e).__name__
        out["message"] = str(e)
    out["detect_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hvd.shutdown()
    out["shutdown_s"] = time.perf_counter() - t0
    _init(rank, size - 1, os.path.join(tmp, "store_b"))
    out["new_world"] = (hvd.rank(), hvd.size())
    out["sum"] = hvd.allreduce(torch.full((3,), float(rank + 1)), op=hvd.Sum,
                               name="after").numpy()
    out["direct_sum"] = hvd.reducescatter(torch.ones(2 * (size - 1)), op=hvd.Sum).numpy()
    hvd.shutdown()
    return out


def _run_sync(rank: int, size: int, tmp: str) -> dict:
    """TorchState.sync from rank 0 to a rank whose model differs and whose
    optimizer has no state yet (a worker that joined), both through the
    binding's hook optimizer; then a step of each stays bitwise equal."""
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch

    _init(rank, size, os.path.join(tmp, "store"))
    model = toy_model(seed=rank)                # rank 1 starts elsewhere
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.1),
        named_parameters=model.named_parameters())
    if rank == 0:
        # Two local steps of the wrapped AdamW: rank 0 has trained alone.
        from horovod_tpu_torch.parallel.train import lm_loss

        for b in range(2):
            ids = toy_batch(b, 0)
            opt.zero_grad()
            lm_loss(model(ids), ids).backward()
            opt._hvd_opt_cls.step(opt)
    state = hvd.elastic.TorchState(model, opt, batch=7 if rank == 0 else 0, tag=f"r{rank}")
    state.sync()
    out = {"batch": state.batch, "tag": state.tag, "synced": flat_state(model, opt),
           "n_state": len(opt.state)}
    out["loss"] = toy_step(model, opt, 9, rank)
    out["stepped"] = flat_state(model, opt)
    hvd.shutdown()
    return out


def _run_world_change(rank: int, size: int, tmp: str) -> dict:
    """The binding's hook optimizer built once, in a world of 2, then used
    in a world of 1 (rank 0 alone) and in a world of 2 again: each step's
    reduced gradients, with the average and Adasum."""
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch

    _init(rank, 2, os.path.join(tmp, "store_a"))
    out = {}
    w = torch.nn.Parameter(torch.zeros(3))
    v = torch.nn.Parameter(torch.zeros(3))
    avg = hvd_torch.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                         named_parameters=[("w", w)])
    ada = hvd_torch.DistributedOptimizer(torch.optim.SGD([v], lr=1.0),
                                         named_parameters=[("v", v)], op=hvd.Adasum)

    def step(tag: str):
        for p, opt in ((w, avg), (v, ada)):
            # Before backward: Adasum's hook takes the local step in it.
            before = p.detach().clone()
            opt.zero_grad()
            g = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
            (p * g).sum().backward()
            opt.step()
            out[f"{tag}_{'avg' if opt is avg else 'ada'}"] = (before - p.detach()).numpy()

    step("w2a")
    hvd.shutdown()
    if rank == 0:
        _init(0, 1, os.path.join(tmp, "store_b"))
        step("w1")
        hvd.shutdown()
        open(os.path.join(tmp, "alone_done"), "w").close()
    else:
        while not os.path.exists(os.path.join(tmp, "alone_done")):
            time.sleep(0.05)
    _init(rank, 2, os.path.join(tmp, "store_c"))
    step("w2b")
    hvd.shutdown()
    return out


# The worker of the launcher's integration cases: the JAX package's
# tests/test_elastic_integration.py worker on the port, training a toy
# GPT-2 under TorchState.
WORKER = '''
import os, pickle, sys, time
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["TEST_WORKERS_DIR"])
import _torch_port_elastic_workers as w
import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as hvd_torch
from horovod_tpu_torch.backend.elastic_env import spawn_identity

TOTAL = int(os.environ["TEST_TOTAL_BATCHES"])
FAIL_KEY = os.environ.get("TEST_FAIL_KEY")
FAIL_SENTINEL = os.environ.get("TEST_FAIL_SENTINEL")
PHASE2 = os.environ.get("TEST_PHASE2")

hvd.init(device="cpu")
model = w.toy_model()
opt = hvd_torch.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-3),
                                     named_parameters=model.named_parameters())
state = hvd.elastic.TorchState(model, opt, batch=0, history=[])

@hvd.elastic.run
def train(state):
    while state.batch < TOTAL:
        if (FAIL_KEY and spawn_identity() == FAIL_KEY
                and not os.path.exists(FAIL_SENTINEL) and state.batch >= 3):
            open(FAIL_SENTINEL, "w").close()
            os._exit(1)
        if PHASE2 and hvd.size() == 1 and state.batch == 2 and not os.path.exists(PHASE2):
            # The second host appears; wait for the driver's notification,
            # so the next commit resets the world.
            open(PHASE2, "w").close()
            t0 = time.time()
            while not state._host_messages and time.time() - t0 < 60:
                time.sleep(0.05)
        w.toy_step(model, opt, state.batch, hvd.rank())
        state.history.append((hvd.rank(), hvd.size()))
        state.batch += 1
        state.commit()
        time.sleep(0.02)
    return list(state.history)

hist = train(state)
with open(os.path.join(os.environ["TEST_OUT"], spawn_identity()), "wb") as f:
    pickle.dump((hvd.rank(), hist, w.flat_state(model, opt)), f)
'''


def leaves_digest(trees: dict) -> str:
    """sha256 over checkpoint leaves in the checkpoint's order (attrs
    sorted), each as a shard holds it: equal for bitwise-equal states."""
    import hashlib

    from horovod_tpu_torch.common.checkpoint import host_leaf

    h = hashlib.sha256()
    for attr in sorted(trees):
        for leaf in trees[attr]:
            a = np.asarray(host_leaf(leaf))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _run_batched_broadcast(rank: int, size: int, tmp: str, runs: int) -> dict:
    """The binding's hook optimizer on a toy GPT-2, ``runs`` times a step
    and then the batched broadcast of the model's and AdamW's state (every
    tensor enqueued before any is waited on); the engine's launch order,
    the channels it used, and the state."""
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.common import basics

    _init(rank, size, os.path.join(tmp, "store"))
    model = toy_model(seed=rank)
    opt = hvd_torch.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-3),
                                         named_parameters=model.named_parameters())
    for i in range(runs):
        toy_step(model, opt, i, rank)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
    out = {"log": basics.engine().launch_log(), "state": flat_state(model, opt),
           "tensors": len(model.state_dict())}
    hvd.shutdown()
    return out


# The worker of the durability cases: WORKER's toy GPT-2 under TorchState
# with the durability plane (HOROVOD_CHECKPOINT_DIR) and the drain plane;
# it records what it restored, each commit's drain evidence, and its end.
DURABLE_WORKER = '''
import atexit, json, os, pickle, sys, time
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.environ["TEST_WORKERS_DIR"])
import _torch_port_elastic_workers as w
import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as hvd_torch
from horovod_tpu_torch.backend.elastic_env import spawn_identity
from horovod_tpu_torch.common import drain, fault_injection
from horovod_tpu_torch.common.exceptions import WorkerPreempted

TOTAL = int(os.environ["TEST_TOTAL_BATCHES"])
rec = {"pid": os.getpid(), "steps": [], "resume": None}
path = os.path.join(os.environ["TEST_OUT"], f"{spawn_identity()}.{os.getpid()}")

SERIES = ("horovod_elastic_", "horovod_checkpoint_", "horovod_preemptions_total",
          "horovod_drain_seconds", "horovod_faults_injected_total")

def dump():
    rec["metrics"] = {k: v for k, v in hvd.metrics()["metrics"].items()
                      if k.startswith(SERIES)}
    with open(path + ".tmp", "wb") as f:
        pickle.dump(rec, f)
    os.replace(path + ".tmp", path)

def on_exit():
    rec["clean_exit"] = True
    dump()

atexit.register(on_exit)
hvd.init(device="cpu")
model = w.toy_model()
opt = hvd_torch.DistributedOptimizer(torch.optim.AdamW(model.parameters(), lr=1e-3),
                                     named_parameters=model.named_parameters())
state = hvd.elastic.TorchState(model, opt, batch=0)

@hvd.elastic.run
def train(state):
    if hvd.elastic.resume_log and rec["resume"] is None:
        rec["resume"] = {"step": hvd.elastic.resume_log[-1]["step"], "batch": state.batch,
                         "size": hvd.size(),
                         "digest": w.leaves_digest(state.checkpoint_trees())}
    while state.batch < TOTAL:
        fault_injection.advance_step()
        w.toy_step(model, opt, state.batch, hvd.rank())
        state.batch += 1
        try:
            state.commit()
        except WorkerPreempted:
            rec["drained_at_commit"] = state.batch
            dump()
            raise
        except hvd.HorovodInternalError:
            if drain.coordinator.fleet_draining() and "drain_seen_at_commit" not in rec:
                rec["drain_seen_at_commit"] = state.batch
            raise
        rec["steps"].append((state.batch, hvd.rank(), hvd.size()))
        dump()
    return state.batch

train(state)
rec["final"] = w.flat_state(model, opt)
rec["done"] = True
dump()
'''


def launch_durable(tmp_path, name: str, min_np: int, max_np: int, env: dict,
                   hosts: int = 3, timeout: float = 150):
    """The port's launcher, elastic, ``min_np``..``max_np`` slots over
    ``hosts`` hosts h0.. of one slot each (HVDRUN_FORCE_LOCAL), DURABLE_WORKER on gloo
    with the engine's fusion off (each gradient reduced alone: one
    summation order in every run); (the finished process, {file: record})."""
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(tests)
    script = tmp_path / "discover.sh"
    if not script.exists():
        script.write_text("#!/bin/sh\n" + "".join(f"echo h{i}:1\n" for i in range(hosts)))
        script.chmod(0o755)
        (tmp_path / "worker.py").write_text(DURABLE_WORKER)
    out = tmp_path / name
    out.mkdir()
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(PYTHONPATH=repo, HVDRUN_FORCE_LOCAL="1", HOROVOD_CYCLE_TIME="1",
                HOROVOD_FUSION_THRESHOLD="0", HOROVOD_ELASTIC_DISCOVERY_INTERVAL="0.25",
                TEST_WORKERS_DIR=tests, TEST_OUT=str(out), **env)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "--min-np", str(min_np),
         "--max-np", str(max_np), "--host-discovery-script", str(script),
         sys.executable, str(tmp_path / "worker.py")],
        cwd=repo, env=full, capture_output=True, text=True, timeout=timeout)
    recs = {}
    for n in os.listdir(out):
        if not n.endswith(".tmp"):
            with open(out / n, "rb") as f:
                recs[n] = pickle.load(f)
    return proc, recs
