"""Elastic training on the port against the JAX package's
(``horovod_tpu/elastic/``): ``ObjectState`` and ``TorchState`` commit,
restore and sync; ``check_host_updates`` folds the same host messages into
the same ``HostsUpdatedInterrupt``; a dead peer on gloo ends every
survivor's collective with ``HorovodInternalError`` (the engine's and a
direct one), ``shutdown()`` stays local, and ``init()`` forms the next
world in the same process; the binding's hook optimizer follows a world
that goes 2 -> 1 -> 2; and the port's launcher runs the two integration
schedules of tests/test_elastic_integration.py with real worker processes
on gloo, a toy GPT-2 training under ``TorchState``."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.elastic import state as port_state

import _torch_port_elastic_workers as workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))


def _toy_adamw():
    model = workers.toy_model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.1)
    workers.toy_step(model, opt, 0, 0)
    return model, opt


def _mutate(model, opt, batch):
    workers.toy_step(model, opt, batch, 0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)


def test_object_state_commit_restore_twice():
    s = hvd.elastic.ObjectState(batch=0, history=[1, 2])
    s.history.append(3)
    s.batch = 5
    s.save()
    s.history.append(4)
    s.restore()
    assert s.batch == 5 and s.history == [1, 2, 3]
    s.history.append(9)             # in place, after a restore
    s.restore()
    assert s.history == [1, 2, 3]


def test_torch_state_restores_the_commit_bitwise_twice():
    """A toy GPT-2 with AdamW: commit, mutate in place (a step and an
    in-place add), restore bitwise; mutate again, restore again: still the
    commit, so the restore copied out of it and aliased nothing."""
    model, opt = _toy_adamw()
    s = hvd.elastic.TorchState(model, opt, batch=1)
    committed = workers.flat_state(model, opt)
    for attempt in range(2):
        _mutate(model, opt, 3 + attempt)
        s.batch = 99
        assert not np.array_equal(workers.flat_state(model, opt), committed)
        s.restore()
        np.testing.assert_array_equal(workers.flat_state(model, opt), committed)
        assert s.batch == 1
    # The optimizer steps on from the restored state as it did from the commit.
    want_model, want_opt = _toy_adamw()
    workers.toy_step(want_model, want_opt, 7, 0)
    workers.toy_step(model, opt, 7, 0)
    np.testing.assert_array_equal(workers.flat_state(model, opt),
                                  workers.flat_state(want_model, want_opt))
    assert s.saved_bytes("cpu") == sum(
        t.numel() * t.element_size() for t in model.state_dict().values()) + sum(
        v.numel() * v.element_size() for st in opt.state.values()
        for v in st.values() if isinstance(v, torch.Tensor))


# (timestamp, HostUpdateResult) message lists: ADDED, REMOVED, both.
HOST_MESSAGES = {
    "none": [],
    "added": [(10.0, 2)],
    "removed": [(10.0, 1)],
    "removed_then_added": [(10.0, 1), (11.0, 2)],
    "two_removed": [(10.0, 1), (12.0, 1)],
    "stale": [(-1.0, 2)],
}


def _host_update_verdict(state_cls, messages, monkeypatch, module):
    monkeypatch.setattr(module, "broadcast_object", lambda obj, root_rank=0, name=None: obj)
    s = state_cls(batch=0)
    for ts, res in messages:
        s.on_hosts_updated(ts, res)
    try:
        s.check_host_updates()
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return type(e).__name__, getattr(e, "skip_sync", None), s._last_updated_timestamp
    return None, None, s._last_updated_timestamp


@pytest.mark.parametrize("name", sorted(HOST_MESSAGES))
def test_check_host_updates_matches_the_jax_state(name, monkeypatch):
    from horovod_tpu.common import functions as jax_functions
    from horovod_tpu.elastic import state as jax_state

    # The JAX State imports broadcast_object into its module; at a world of
    # one both packages' broadcast is the identity.
    monkeypatch.setattr(jax_functions, "broadcast_object",
                        lambda obj, root_rank=0, name=None: obj)
    got = _host_update_verdict(port_state.ObjectState, HOST_MESSAGES[name], monkeypatch,
                               port_state)
    want = _host_update_verdict(jax_state.ObjectState, HOST_MESSAGES[name], monkeypatch,
                                jax_state)
    assert got == want


def test_sync_on_two_gloo_ranks(tmp_path):
    """Rank 1's model differs and its AdamW has no state (a worker that
    joined); after sync both hold rank 0's parameters and AdamW state
    bitwise, and a step of each stays bitwise equal."""
    res = workers.spawn(2, str(tmp_path), "_run_sync")
    assert res[0]["batch"] == res[1]["batch"] == 7
    assert res[0]["tag"] == res[1]["tag"] == "r0"
    assert res[0]["n_state"] == res[1]["n_state"] > 0
    np.testing.assert_array_equal(res[0]["synced"], res[1]["synced"])
    np.testing.assert_array_equal(res[0]["stepped"], res[1]["stepped"])


@pytest.mark.parametrize("path", ["engine", "direct"])
def test_dead_peer_on_gloo(tmp_path, path):
    """Three gloo ranks; rank 2 exits while ranks 0 and 1 are in a
    collective. Each survivor raises HorovodInternalError, its shutdown()
    returns within 10 s, and init() forms the world of two in the same
    process, where the engine's and a direct collective work."""
    res = workers.spawn(3, str(tmp_path), "_run_dead_peer", path, timeout=60)
    assert sorted(res) == [0, 1]
    for r in (0, 1):
        out = res[r]
        assert out["raised"] == "HorovodInternalError", out
        assert out["shutdown_s"] < 10, out
        assert out["new_world"] == (r, 2)
        np.testing.assert_array_equal(out["sum"], [3.0, 3.0, 3.0])
        np.testing.assert_array_equal(out["direct_sum"], [2.0, 2.0])


def test_hook_optimizer_follows_the_world(tmp_path):
    """One hook optimizer through a world of 2, of 1, of 2: the average
    over 2, the local gradient alone, the average over 2 again; Adasum's
    delta class combines in the worlds of 2 and steps plainly alone. The
    ranks' gradients are g0 and 2·g0: their mean is 1.5·g0, and so is the
    Adasum of the two parallel SGD deltas, (1 - 1)·g0 + (1 - 1/4)·2·g0."""
    res = workers.spawn(2, str(tmp_path), "_run_world_change")
    g0 = np.array([1.0, 2.0, 3.0])
    for r in (0, 1):
        for tag in ("w2a", "w2b"):
            np.testing.assert_allclose(res[r][f"{tag}_avg"], 1.5 * g0, rtol=1e-6)
            np.testing.assert_allclose(res[r][f"{tag}_ada"], 1.5 * g0, rtol=1e-6)
    np.testing.assert_allclose(res[0]["w1_avg"], g0, rtol=1e-6)
    np.testing.assert_allclose(res[0]["w1_ada"], g0, rtol=1e-6)
    assert "w1_avg" not in res[1]


def _run_launcher(tmp_path, discovery_lines, env, timeout=120):
    """The port's launcher in elastic mode with real worker processes on
    gloo; (exit code, {spawn identity: (rank, history, state bytes)})."""
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\n" + discovery_lines + "exit 0\n")
    script.chmod(0o755)
    worker = tmp_path / "worker.py"
    worker.write_text(workers.WORKER)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(PYTHONPATH=REPO, HVDRUN_FORCE_LOCAL="1", HOROVOD_CYCLE_TIME="1",
                HOROVOD_ELASTIC_DISCOVERY_INTERVAL="0.25", TEST_WORKERS_DIR=TESTS,
                TEST_OUT=str(out_dir), **env)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "--min-np", "1",
         "--max-np", "2", "--host-discovery-script", str(script), "--slots-per-host", "1",
         sys.executable, str(worker)],
        cwd=REPO, env=full, capture_output=True, text=True, timeout=timeout)
    results = {}
    for name in os.listdir(out_dir):
        with open(out_dir / name, "rb") as f:
            results[name] = pickle.load(f)
    return proc, results


def test_launcher_host_added_mid_training(tmp_path):
    """(tests/test_elastic_integration.py:222) One host; a second appears
    mid-run. Training continues through the reset and finishes at size 2,
    with bitwise-equal replicas."""
    phase2 = tmp_path / "phase2"
    proc, results = _run_launcher(
        tmp_path, f"echo hostA:1\n[ -f {phase2} ] && echo hostB:1\n",
        {"TEST_TOTAL_BATCHES": "12", "TEST_PHASE2": str(phase2)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "hostA:0" in results
    rank, hist, state_a = results["hostA:0"]
    sizes = {s for _, s in hist}
    assert 1 in sizes and 2 in sizes, sizes
    assert "hostB:0" in results  # the added worker also finished
    np.testing.assert_array_equal(results["hostB:0"][2], state_a)


def test_launcher_worker_death(tmp_path):
    """(tests/test_elastic_integration.py:248) Two hosts; hostB's worker
    dies at batch 3. The driver blacklists hostB and the survivor restores
    its last commit and finishes alone."""
    sentinel = tmp_path / "failed_once"
    proc, results = _run_launcher(
        tmp_path, "echo hostA:1\necho hostB:1\n",
        {"TEST_TOTAL_BATCHES": "8", "TEST_FAIL_KEY": "hostB:0",
         "TEST_FAIL_SENTINEL": str(sentinel)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sentinel.exists()  # the failure really happened
    assert "hostA:0" in results
    rank, hist, _ = results["hostA:0"]
    sizes = [s for _, s in hist]
    assert 2 in sizes and sizes[-1] == 1, sizes  # shrank to 1 and finished
    assert [s for _, s in hist] == [2, 2, 2] + [1] * 5


def test_static_launch_and_run_func(tmp_path):
    """A static launch of two gloo workers through the CLI, and
    ``runner.run`` of a function on two processes."""
    worker = tmp_path / "w.py"
    worker.write_text(
        "import torch, horovod_tpu_torch as hvd\n"
        "torch.set_num_threads(1)\n"
        "hvd.init(device='cpu')\n"
        "x = hvd.allreduce(torch.ones(2) * (hvd.rank() + 1), op=hvd.Sum, name='x')\n"
        "print('RESULT', hvd.rank(), hvd.size(), x.tolist(), flush=True)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
                           "2", sys.executable, str(worker)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = sorted(ln.split(":", 1)[1] for ln in proc.stdout.splitlines() if "RESULT" in ln)
    assert lines == ["RESULT 0 2 [3.0, 3.0]", "RESULT 1 2 [3.0, 3.0]"]
