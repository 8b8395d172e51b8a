"""The port's drain plane (``horovod_tpu_torch/common/drain.py``, the
drain barrier in ``State.commit``, the driver's drain notices and the
quarantine of ``runner/elastic/discovery.py``) against the JAX package's,
and the engine's launch order (ROADMAP C7): the coordinator's notice,
grace and exits behave as the JAX one's; a world of one drains at its
commit with the checkpoint made durable first; on two gloo workers under
the port's launcher the drain is handed over at one commit on both ranks,
the drained worker exits cleanly and the survivor goes on at np=1; and the
batched ``broadcast_parameters`` launches its collectives in one order on
both ranks across the engine's channels, each response entered in the
launch log before any of its handles completes."""
import signal
import sys
import time

import numpy as np
import pytest

from horovod_tpu.common import drain as jax_drain
from horovod_tpu.common import fault_injection as jax_fi
from horovod_tpu.runner.elastic import discovery as jax_disc
from horovod_tpu.utils import env as jax_env

from horovod_tpu_torch.common import checkpoint as ck
from horovod_tpu_torch.common import drain
from horovod_tpu_torch.common import env as port_env
from horovod_tpu_torch.common import fault_injection as fi
from horovod_tpu_torch.common.exceptions import WorkerPreempted
from horovod_tpu_torch.elastic import state as port_state
from horovod_tpu_torch.runner.elastic import discovery as port_disc

import _torch_port_elastic_workers as workers

PACKAGES = {"port": drain, "jax": jax_drain}


@pytest.fixture
def coordinators(monkeypatch):
    """A fresh coordinator of each package, with its hard exit recorded
    instead of taken, and SIGUSR1 as the preemption signal (the test
    process keeps its SIGTERM)."""
    monkeypatch.setenv("HOROVOD_PREEMPT_SIGNAL", "SIGUSR1")
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", raising=False)
    made = {}
    for name, mod in PACKAGES.items():
        c = mod.DrainCoordinator()
        c.exits = []
        c._exit = c.exits.append
        made[name] = c
    yield made
    for c in made.values():
        c.reset()


@pytest.mark.parametrize("value", [None, "0", "12.5", "bogus", "-3"])
def test_drain_grace_is_read_as_in_the_jax_package(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HOROVOD_DRAIN_GRACE_SECONDS", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_DRAIN_GRACE_SECONDS", value)
    assert port_env.drain_grace_seconds() == jax_env.drain_grace_seconds()


@pytest.mark.parametrize("value", [None, "SIGTERM", "term", "USR1", "sigusr2", "10", "", "NOPE"])
def test_preempt_signal_is_read_as_in_the_jax_package(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HOROVOD_PREEMPT_SIGNAL", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_PREEMPT_SIGNAL", value)
    assert port_env.preempt_signal() == jax_env.preempt_signal()


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_CHECKPOINT_INTERVAL_STEPS", "7"), ("HOROVOD_CHECKPOINT_INTERVAL_STEPS", "-1"),
    ("HOROVOD_CHECKPOINT_KEEP", "0"), ("HOROVOD_CHECKPOINT_KEEP", "5"),
    ("HOROVOD_CHECKPOINT_COMMIT_TIMEOUT_SECONDS", "2.5"), ("HOROVOD_CHECKPOINT_FSYNC", "0"),
    ("HOROVOD_CHECKPOINT_FSYNC", "yes")])
def test_checkpoint_knobs_are_read_as_in_the_jax_package(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    for fn in ("checkpoint_interval_steps", "checkpoint_keep", "checkpoint_commit_timeout",
               "checkpoint_fsync"):
        assert getattr(port_env, fn)() == getattr(jax_env, fn)()


def test_an_unmanaged_notice_exits_zero_at_once(coordinators):
    for c in coordinators.values():
        c.request("test")
        assert c.exits == [0] and c.pending()


def test_a_managed_notice_arms_the_grace_and_exits_zero_when_it_expires(coordinators,
                                                                      monkeypatch):
    monkeypatch.setenv("HOROVOD_DRAIN_GRACE_SECONDS", "0.3")
    for c in coordinators.values():
        c.set_managed(True)
        c.request("test")
        assert c.exits == [] and c.pending() and c.active()
        assert c.checkpoint_budget() == 1.0      # floor: 0.3 s less 2 s for the exit
    time.sleep(0.8)
    assert [c.exits for c in coordinators.values()] == [[0], [0]]


def test_install_is_idempotent_and_leaves_a_foreign_handler(coordinators):
    prev = signal.getsignal(signal.SIGUSR1)
    try:
        for c in coordinators.values():
            assert c.install(managed=True) and c.install()
            assert signal.getsignal(signal.SIGUSR1) == c._on_signal
            c.reset()
            assert signal.getsignal(signal.SIGUSR1) == prev
        signal.signal(signal.SIGUSR1, lambda *a: None)
        for c in coordinators.values():
            assert not c.install()
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_a_preempt_rule_delivers_the_notice_through_the_signal(coordinators):
    """preempt:step=2 on each package's injector sends SIGUSR1 to this
    process at step 2; the installed handler marks the drain pending."""
    prev = signal.getsignal(signal.SIGUSR1)
    try:
        for name, c in coordinators.items():
            inj = (fi if name == "port" else jax_fi).FaultInjector()
            inj.install((fi if name == "port" else jax_fi).parse_spec("preempt:step=2"))
            assert c.install(managed=True)
            inj.advance_step()
            assert not c.pending()
            inj.advance_step()
            t0 = time.time()
            while not c.pending() and time.time() - t0 < 5:
                time.sleep(0.01)
            assert c.pending() and c.reason == "signal SIGUSR1"
            c.reset()
    finally:
        signal.signal(signal.SIGUSR1, prev)


class _Manager:
    def __init__(self):
        self.calls = []

    def save_now(self, state, timeout):
        self.calls.append(timeout)


@pytest.mark.parametrize("pending", [False, True])
def test_the_commit_barrier_of_a_world_of_one(monkeypatch, coordinators, pending):
    """Managed, at a world of one: a pending drain makes the commit durable
    (``save_now`` within the grace budget) and leaves through
    ``WorkerPreempted``, a ``SystemExit`` of code 0; no drain, nothing."""
    c = coordinators["port"]
    monkeypatch.setattr(drain, "coordinator", c)
    c.set_managed(True)
    if pending:
        c.request("test")
    mgr = _Manager()
    state = port_state.ObjectState(batch=3)
    state.set_checkpoint_manager(mgr)
    if pending:
        with pytest.raises(WorkerPreempted) as e:
            drain.commit_barrier(state)
        assert isinstance(e.value, SystemExit) and e.value.code == 0
        assert len(mgr.calls) == 1 and 0 < mgr.calls[0] <= 30
    else:
        drain.commit_barrier(state)
        assert mgr.calls == []
    c.set_managed(False)
    drain.commit_barrier(state)                   # unmanaged: nothing at all


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_a_quarantined_host_leaves_and_comes_back_without_a_strike(mod):
    m = port_disc if mod == "port" else jax_disc
    hosts = m.FixedHosts({"a": 1, "b": 1})
    mgr = m.HostManager(hosts, cooldown=600)
    assert mgr.update_available_hosts() == m.HostUpdateResult.ADDED
    mgr.quarantine("b", 0.3)
    assert mgr.current_hosts == [("a", 1)] and mgr.is_quarantined("b")
    assert mgr.update_available_hosts() == m.HostUpdateResult.NO_UPDATE
    time.sleep(0.4)
    assert mgr.update_available_hosts() == m.HostUpdateResult.ADDED
    assert mgr.current_hosts == [("a", 1), ("b", 1)] and not mgr.is_blacklisted("b")


def test_launch_log_holds_a_response_once_its_handle_completes():
    """A single-response step read at once, many times over: the last
    entry of ``launch_log()`` is that response as soon as ``synchronize``
    returns. A thread switch every microsecond makes the reader run
    between the completion and any later bookkeeping of the executor: an
    engine that logs after completing the handle fails this in most
    steps."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        eng = hvd.common.basics.engine()
        t = torch.ones(4)
        late = []
        for i in range(300):
            hvd.synchronize(hvd.allreduce_async(t, name=f"race{i}"))
            log = eng.launch_log()
            if not log or log[-1][2] != f"allreduce.race{i}":
                late.append(i)
        assert late == [], f"{len(late)} of 300 steps read the log before its entry"
        assert [seq for seq, _, _ in eng.launch_log()] == list(range(300))
    finally:
        sys.setswitchinterval(interval)
        hvd.shutdown()


def test_batched_broadcast_launches_in_one_order_on_two_ranks(tmp_path):
    """C7: the binding's hook optimizer and the batched broadcast of the
    model's and AdamW's state, 5 times on two gloo ranks: the engine
    launched the same responses in the same order on both ranks, one at a
    time in the coordinator's sequence, over both channels; the state is
    bitwise on both."""
    res = workers.spawn(2, str(tmp_path), "_run_batched_broadcast", 5)
    log0, log1 = res[0]["log"], res[1]["log"]
    assert log0 == log1
    assert [seq for seq, _, _ in log0] == list(range(len(log0)))
    assert {ch for _, ch, _ in log0} == {0, 1}
    assert sum(name.startswith("broadcast.bp.") for _, _, name in log0) >= 5
    np.testing.assert_array_equal(res[0]["state"], res[1]["state"])


def test_drain_hands_over_at_one_commit_on_two_ranks(tmp_path):
    """Two gloo workers under the port's launcher with checkpoints;
    preempt:step=4:rank=1. Both ranks see the drain at the commit of step
    4, which is a complete checkpoint of two shards; rank 1 leaves through
    WorkerPreempted (a clean exit); the driver quarantines its host and
    re-meshes at its exit; rank 0 restores that commit in memory and goes
    on alone to step 8, with no restore from the checkpoint."""
    ckpt = tmp_path / "ckpt"
    proc, recs = workers.launch_durable(
        tmp_path, "drain", 1, 2,
        {"HOROVOD_CHECKPOINT_DIR": str(ckpt), "HOROVOD_CHECKPOINT_INTERVAL_STEPS": "3",
         "HOROVOD_CHECKPOINT_KEEP": "10", "TEST_TOTAL_BATCHES": "8",
         "HOROVOD_FAULT_INJECT": "preempt:step=4:rank=1"}, hosts=2)
    assert proc.returncode == 0, proc.stderr[-3000:]
    drained = [r for r in recs.values() if "drained_at_commit" in r]
    survivors = [r for r in recs.values() if r.get("done")]
    assert len(drained) == 1 and len(survivors) == 1, sorted(recs)
    d, s = drained[0], survivors[0]
    assert d["drained_at_commit"] == 4 and d.get("clean_exit") and not d.get("done")
    assert s["drain_seen_at_commit"] == 4 and s["resume"] is None
    # The metrics plane saw the same: one notice and one drain on rank 1,
    # one in-memory restore and one reset on the survivor (the coordinator,
    # which committed the checkpoints of steps 3 and 4), no durable restore.
    dm, sm = d["metrics"], s["metrics"]
    assert dm["horovod_preemptions_total"] == 1
    assert dm['horovod_faults_injected_total{action="preempt"}'] == 1
    assert dm["horovod_drain_seconds"]["count"] == 1
    assert sm["horovod_elastic_restores_total"] == 1
    assert sm["horovod_elastic_resets_total"] == 1
    assert sm["horovod_checkpoint_commits_total"] >= 2
    assert sm["horovod_checkpoint_restores_total"] == 0
    assert s["steps"] == [(b, 0, 2) for b in (1, 2, 3)] + [(b, 0, 1) for b in range(5, 9)]
    man = ck.load_manifest(ck.manifest_path(str(ckpt), 4))
    assert man is not None and len(man["shards"]) == 2 and ck.is_complete(str(ckpt), man)
    assert "drain notice from h1:0" in proc.stderr
