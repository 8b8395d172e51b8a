"""The port's launcher and elastic driver against the JAX package's
(``horovod_tpu/runner/``): host parsing and slot assignment, the worker env
contract, the HMAC rendezvous wire in both directions, host discovery, the
driver's epoch rows under the same discovery and failure sequences, the
fault-rule grammar, and the unported knobs, which raise naming their
ROADMAP item. Everything here runs in this process; the real worker
processes are in tests/test_torch_port_elastic.py."""
import dataclasses
import functools
import os
import threading
import time

import pytest

from horovod_tpu.common import fault_injection as jax_fi
from horovod_tpu.runner import hosts as jax_hosts
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner import rendezvous_server as jax_rs
from horovod_tpu.backend.rendezvous import RendezvousClient as JaxClient
from horovod_tpu.runner.elastic import discovery as jax_disc
from horovod_tpu.runner.elastic.driver import ElasticDriver as JaxDriver

from horovod_tpu_torch.backend.rendezvous import RendezvousClient
from horovod_tpu_torch.common import fault_injection as fi
from horovod_tpu_torch.runner import hosts
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner import rendezvous_server as rs
from horovod_tpu_torch.runner.elastic import discovery
from horovod_tpu_torch.runner.elastic.driver import ElasticDriver

HOST_CASES = [
    ("localhost:4", 4, None),
    ("h1:2,h2:2", 4, None),
    ("h1:2,h2:2", 3, 3),
    ("h1:3,h2:1,h3:2", 2, 5),
    ("a,b,c", 3, None),
    ("a:1,b:4", 2, 2),
    ("h1:2,h2:2", 5, None),          # too few slots: both raise
    ("x:0,y:2", 2, None),
]


def _slots(mod, spec, min_np, max_np):
    try:
        return [dataclasses.asdict(s) for s in mod.get_host_assignments(
            mod.parse_hosts(spec), min_np, max_np)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec,min_np,max_np", HOST_CASES)
def test_host_assignments_match_the_jax_launcher(spec, min_np, max_np):
    assert [dataclasses.asdict(h) for h in hosts.parse_hosts(spec)] == \
        [dataclasses.asdict(h) for h in jax_hosts.parse_hosts(spec)]
    assert _slots(hosts, spec, min_np, max_np) == _slots(jax_hosts, spec, min_np, max_np)
    if not isinstance(_slots(hosts, spec, min_np, max_np), tuple):
        rows = [s.to_response_string() for s in hosts.get_host_assignments(
            hosts.parse_hosts(spec), min_np, max_np)]
        assert rows == [s.to_response_string() for s in jax_hosts.get_host_assignments(
            jax_hosts.parse_hosts(spec), min_np, max_np)]


@pytest.mark.parametrize("text", [
    "h1 slots=2\nh2 slots=4\n",
    "# comment\nh1:2\n\nh2\n",
    "a slots=1  # trailing\nb:3\n",
])
def test_hostfile_matches_the_jax_launcher(tmp_path, text):
    path = tmp_path / "hostfile"
    path.write_text(text)
    assert [dataclasses.asdict(h) for h in hosts.parse_hostfile(str(path))] == \
        [dataclasses.asdict(h) for h in jax_hosts.parse_hostfile(str(path))]


# The keys where the port's worker env differs from the JAX package's, by
# design: no TCP backend knobs, and the launcher's store.
JAX_ONLY_KEYS = {"HOROVOD_CONTROLLER", "HOROVOD_CPU_OPERATIONS"}
PORT_ONLY_KEYS = {"HOROVOD_STORE_PORT"}


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("spec,np_", [("localhost:2", 2), ("h1:2,h2:2", 4),
                                      ("h1:1,h2:3", 3)])
def test_slot_env_matches_the_jax_launcher(spec, np_, elastic):
    key = b"k" * 32
    extra = {"HOROVOD_CYCLE_TIME": "1"}
    for mine, theirs in zip(
            hosts.get_host_assignments(hosts.parse_hosts(spec), np_, np_),
            jax_hosts.get_host_assignments(jax_hosts.parse_hosts(spec), np_, np_)):
        got = launch.slot_env(mine, "10.0.0.1", 1234, extra, elastic, key, store_port=4321)
        want = jax_launch.slot_env(theirs, "10.0.0.1", 1234, extra, elastic, key)
        assert set(want) - set(got) == JAX_ONLY_KEYS
        assert set(got) - set(want) == PORT_ONLY_KEYS
        assert {k: v for k, v in got.items() if k not in PORT_ONLY_KEYS} == \
            {k: v for k, v in want.items() if k not in JAX_ONLY_KEYS}
        assert got["HOROVOD_STORE_PORT"] == "4321"


def test_ssh_command_matches_the_jax_launcher():
    env = {"HOROVOD_RANK": "1", "HOROVOD_SECRET_KEY": "ab" * 32}
    cmd = ["python", "train.py", "--x", "a b"]
    assert launch.build_ssh_command("h2", cmd, env, 2222, "/id") == \
        jax_launch.build_ssh_command("h2", cmd, env, 2222, "/id")


def test_args_to_env_matches_the_jax_launcher():
    argv = ["--fusion-threshold-mb", "32", "--cycle-time-ms", "2", "--cache-capacity",
            "0", "--timeline-filename", "/tmp/t.json", "--no-stall-check",
            "--log-level", "DEBUG", "--autotune", "python", "x.py"]
    from horovod_tpu.runner import config_parser as jax_cp
    from horovod_tpu_torch.runner import config_parser as cp

    assert cp.args_to_env(launch.make_parser().parse_args(argv)) == \
        jax_cp.args_to_env(jax_launch.make_parser().parse_args(argv))


@pytest.mark.parametrize("method,path,body,ts", [
    ("PUT", "/rank_and_size_e0/a:0", b"0,2,0,1,0,2", "1700000000.5"),
    ("GET", "/meta/epoch", b"", "1.25"),
    ("DELETE", "/jobs/x/scope", b"", "1700000001.0"),
])
def test_sign_request_gives_the_jax_bytes(method, path, body, ts):
    key = bytes(range(32))
    assert rs.sign_request(key, method, path, body, ts) == \
        jax_rs.sign_request(key, method, path, body, ts)


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_rendezvous_wire_across_the_packages(server_side):
    """The port's client against the JAX server, and the JAX client against
    the port's: put, get, wait_get, scope delete, and a wrong key refused."""
    key = bytes(range(32))
    if server_side == "port":
        server = rs.RendezvousServer(secret_key=key)
        client = functools.partial(JaxClient, namespace="")
    else:
        server = jax_rs.RendezvousServer(secret_key=key, fleet_slots=0)
        client = RendezvousClient
    port = server.start()
    try:
        c = client("127.0.0.1", port, timeout=5.0, secret_key=key)
        c.put("scope_a", "k1", b"v1")
        c.put("scope_a", "k2", b"v2")
        assert c.get("scope_a", "k1") == b"v1"
        assert c.get("scope_a", "missing") is None
        threading.Timer(0.3, lambda: c.put("late", "k", b"here")).start()
        assert c.wait_get("late", "k") == b"here"
        c.delete("scope_a")
        assert c.get("scope_a", "k2") is None
        assert server.handle_get("late/k") == b"here"
        bad = client("127.0.0.1", port, timeout=5.0, secret_key=b"x" * 32)
        with pytest.raises(PermissionError, match="bad digest"):
            bad.get("late", "k")
        # A refused PUT: the JAX client says RuntimeError("... 403"), the
        # port's PermissionError with the server's reason, as its GET does.
        with pytest.raises((PermissionError, RuntimeError), match="403|digest"):
            bad.put("late", "k", b"evil")
        assert server.handle_get("late/k") == b"here"
    finally:
        server.stop()


def test_rendezvous_refuses_a_replayed_put():
    key = bytes(range(32))
    server = rs.RendezvousServer(secret_key=key)
    port = server.start()
    try:
        import http.client

        digest, ts = rs.sign_request(key, "PUT", "/s/k", b"v")
        codes = []
        for _ in range(2):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("PUT", "/s/k", body=b"v", headers={
                "X-Horovod-Digest": digest, "X-Horovod-Timestamp": ts})
            codes.append(conn.getresponse().status)
            conn.close()
        assert codes == [200, 403]
    finally:
        server.stop()


# Host discovery sequences: each step sets the discovered hosts, or
# blacklists one ("!host").
DISCOVERY_SEQUENCES = {
    "grow_shrink": [{"a": 2}, {"a": 2}, {"a": 2, "b": 2}, {"b": 2}, {"a": 1}],
    "slots_change": [{"a": 1, "b": 1}, {"a": 2, "b": 1}, {"a": 2}, {"a": 2, "c": 3}],
    "blacklist": [{"a": 1, "b": 1, "c": 1}, "!a", {"c": 1, "b": 1, "d": 1},
                  {"a": 1, "b": 1}],
}


def _host_results(mod, seq):
    d = mod.FixedHosts({})
    m = mod.HostManager(d, cooldown=600.0)
    out = []
    for step in seq:
        if isinstance(step, str):
            m.blacklist(step[1:])
            out.append(("blacklisted", m.current_hosts))
            continue
        d.set(step)
        out.append((m.update_available_hosts(), m.current_hosts, m.available_slots()))
    return out


@pytest.mark.parametrize("name", sorted(DISCOVERY_SEQUENCES))
def test_host_manager_matches_the_jax_driver(name):
    seq = DISCOVERY_SEQUENCES[name]
    assert _host_results(discovery, seq) == _host_results(jax_disc, seq)


def test_discovery_script_matches_the_jax_driver(tmp_path):
    script = tmp_path / "d.sh"
    script.write_text("#!/bin/sh\necho h1:2\necho h2\n\necho h3:1\n")
    script.chmod(0o755)
    assert discovery.HostDiscoveryScript(str(script), 4).find_available_hosts_and_slots() \
        == jax_disc.HostDiscoveryScript(str(script), 4).find_available_hosts_and_slots()
    with pytest.raises(ValueError, match="slots-per-host"):
        discovery.HostDiscoveryScript(str(script)).find_available_hosts_and_slots()


class FakeProc:
    """The fake worker of tests/test_elastic_driver.py."""

    def __init__(self):
        self._rc = None
        self._done = threading.Event()

    def poll(self):
        return self._rc

    def wait(self, timeout=None):
        self._done.wait(timeout)
        return self._rc

    def exit(self, rc):
        self._rc = rc
        self._done.set()

    def terminate(self):
        self.exit(-15)

    def kill(self):
        self.exit(-9)


# Driver scenarios: (initial hosts, min_np, max_np, steps). A step is
# ("hosts", {...}): discovery changes and the discovery loop's body runs;
# ("fail", "h:i"): that worker exits 1 and every other live worker parks
# READY at the barrier; ("sleep", s): the blacklist cooldown (1 s) runs
# out; ("ok", None): every worker exits 0.
DRIVER_CASES = {
    "host_added": ({"a": 2}, 2, 8, [("hosts", {"a": 2, "b": 2}),
                                    ("hosts", {"a": 2, "b": 2, "c": 1}), ("ok", None)]),
    "host_removed": ({"a": 1, "b": 1, "c": 1}, 1, None, [("hosts", {"a": 1, "c": 1}),
                                                         ("ok", None)]),
    "worker_death": ({"a": 1, "b": 1}, 1, 2, [("fail", "b:0"), ("ok", None)]),
    "death_then_return": ({"c0": 1, "c1": 1, "c2": 1, "c3": 1}, 3, 4,
                          [("fail", "c3:0"), ("sleep", 1.2),
                           ("hosts", {"c0": 1, "c1": 1, "c2": 1, "c3": 1}), ("ok", None)]),
    "max_np_cut": ({"a": 4, "b": 4}, 2, 6, [("hosts", {"a": 4, "b": 4, "c": 2}),
                                            ("fail", "a:1"), ("ok", None)]),
}


def _drive(make_server, driver_cls, disc_mod, hosts0, min_np, max_np, steps, monkeypatch):
    """Run one driver through ``steps``; the rows of every epoch."""
    monkeypatch.setenv("HOROVOD_BLACKLIST_COOLDOWN_SECONDS", "1")
    server = make_server()
    disc = disc_mod.FixedHosts(hosts0)
    driver = driver_cls(server, disc, min_np, max_np, poll_interval=0.05)
    procs = {}

    def create(slot, extra_env):
        procs[(slot.hostname, slot.local_rank)] = p = FakeProc()
        return p

    def snapshot():
        e = int(server.handle_get("meta/epoch"))
        with server._lock:
            rows = {k: v.decode() for k, v in server._store.items()
                    if k.startswith(f"rank_and_size_e{e}/")}
        return e, rows

    def wait_epoch(e):
        deadline = time.monotonic() + 10
        while driver.epoch < e and time.monotonic() < deadline:
            time.sleep(0.01)
        assert driver.epoch >= e

    out = []
    driver._create_worker = create
    driver.wait_for_available_slots(min_np)
    driver._activate()
    out.append(snapshot())
    try:
        for kind, arg in steps:
            if kind == "hosts":
                disc.set(arg)
                res = driver.host_manager.update_available_hosts()
                if driver.host_manager.available_slots() >= min_np:
                    driver._activate(notify_update=res)
                out.append(("update", res) + snapshot())
            elif kind == "sleep":
                time.sleep(arg)
            elif kind == "fail":
                e = driver.epoch
                host, idx = arg.split(":")
                procs[(host, int(idx))].exit(1)
                time.sleep(0.05)
                for (h, i) in list(driver._assignments):
                    if (h, i) != (host, int(idx)):
                        server.handle_put(f"ready_e{e}/{h}:{i}", b"1")
                wait_epoch(e + 1)
                out.append(("fail", driver.host_manager.is_blacklisted(host)) + snapshot())
            else:
                for (h, i) in list(driver._assignments):
                    procs[(h, i)].exit(0)
                out.append(("done", driver.wait(timeout=10)))
    finally:
        driver.stop()
    return out


@pytest.mark.parametrize("name", sorted(DRIVER_CASES))
def test_driver_rows_match_the_jax_driver(name, monkeypatch):
    """The same discovery and failure sequence through both drivers with
    fake workers: the same rank_and_size_e<E> rows and meta/epoch at
    every epoch."""
    hosts0, min_np, max_np, steps = DRIVER_CASES[name]
    got = _drive(rs.RendezvousServer, ElasticDriver, discovery, hosts0, min_np, max_np,
                 steps, monkeypatch)
    want = _drive(functools.partial(jax_rs.RendezvousServer, fleet_slots=0), JaxDriver,
                  jax_disc, hosts0, min_np, max_np, steps, monkeypatch)
    assert got == want
    assert got[-1] == ("done", 0)


def test_driver_ready_timeout_evicts_a_silent_slot(monkeypatch):
    """A slot with no verdict by the ready deadline is killed and recorded
    failed, so the survivors' barrier fires."""
    monkeypatch.setenv("HOROVOD_ELASTIC_READY_TIMEOUT", "0.3")
    server = rs.RendezvousServer()
    driver = ElasticDriver(server, discovery.FixedHosts({"a": 1, "b": 1}), 1, 2,
                           poll_interval=0.05)
    procs = {}

    def create(slot, extra_env):
        procs[(slot.hostname, slot.local_rank)] = p = FakeProc()
        return p

    driver.start(create)
    try:
        server.handle_put("ready_e0/a:0", b"1")     # b stays silent
        deadline = time.monotonic() + 5
        while driver.epoch < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert driver.epoch == 1 and procs[("b", 0)].poll() == -9
        assert server.handle_get("rank_and_size_e1/a:0").decode().startswith("0,1,")
    finally:
        driver.stop()


FAULT_SPECS = [
    "kill:step=5",
    "kill:step=5:rank=3",
    "sever:peer=0:after=3;delay:peer=2:secs=0.2",
    "drop:peer=1:op=send:rank=2",
    "wedge:step=4:rank=1",
    "hang:peer=0:op=recv:after=2",
    "preempt:secs=1.5",
    "diskfail:path=ckpt:op=write:after=1;diskslow:secs=0.1",
    "killdoor:after=3",
]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_rules_parse_as_in_the_jax_package(spec):
    assert [dataclasses.asdict(r) for r in fi.parse_spec(spec)] == \
        [dataclasses.asdict(r) for r in jax_fi.parse_spec(spec)]


@pytest.mark.parametrize("spec", ["nope:step=1", "kill", "sever:peer=x", "drop:op=recv",
                                  "delay:peer=1", "path:x", "kill:step=1:op=read"])
def test_bad_fault_rules_raise_as_in_the_jax_package(spec):
    with pytest.raises(ValueError):
        jax_fi.parse_spec(spec)
    with pytest.raises(ValueError):
        fi.parse_spec(spec)


@pytest.mark.parametrize("spec,item", [
    ("sever:peer=0", "A7"), ("drop:peer=1", "A7"), ("delay:peer=1:secs=1", "A7"),
    ("hang:peer=0", "A7"), ("wedge:step=3", "A8"), ("killdoor:after=1", "A9"),
])
def test_unported_fault_rules_raise_naming_their_item(monkeypatch, spec, item):
    import horovod_tpu_torch as hvd

    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        fi.FaultInjector().install(fi.parse_spec(spec))
    monkeypatch.setenv("HOROVOD_FAULT_INJECT", spec)
    monkeypatch.setattr(fi, "injector", fi.FaultInjector())
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_kill_rule_counts_steps_on_its_rank(monkeypatch):
    inj = fi.FaultInjector()
    inj.install(fi.parse_spec("kill:step=3:rank=1"))
    exits = []
    monkeypatch.setattr(fi.os, "_exit", exits.append)
    monkeypatch.setenv("HOROVOD_RANK", "0")
    assert [inj.advance_step() for _ in range(4)] == [1, 2, 3, 4] and not exits
    monkeypatch.setenv("HOROVOD_RANK", "1")
    inj.advance_step()
    assert exits == [1]


@pytest.mark.parametrize("spec,op,fires", [
    ("preempt:step=2", "step", [0, 1, 1]),
    ("diskfail:after=0", "disk", "InjectedDiskFault"),
    ("diskslow:secs=1", "disk", 1.0),
])
def test_durability_rules_arm_at_init_and_fire(monkeypatch, spec, op, fires):
    """The rules of the durability plane, once raise cases: armed at
    ``hvd.init()`` from the environment, they fire. preempt:step=2 sends
    HOROVOD_PREEMPT_SIGNAL to this process once, at step 2; diskfail raises
    an OSError on the first disk I/O; diskslow sleeps before it."""
    import signal

    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_FAULT_INJECT", spec)
    monkeypatch.setattr(fi, "injector", fi.FaultInjector())
    kills, sleeps = [], []
    monkeypatch.setattr(fi.os, "kill", lambda pid, sig: kills.append((pid, sig)))
    monkeypatch.setattr(fi.time, "sleep", sleeps.append)
    hvd.init(device="cpu")
    try:
        inj = fi.get_injector()
        assert inj.active
        if op == "step":
            seen = []
            for _ in range(3):
                inj.advance_step()
                seen.append(len(kills))
            assert seen == fires
            assert kills == [(os.getpid(), int(signal.SIGTERM))]
        elif fires == "InjectedDiskFault":
            with pytest.raises(fi.InjectedDiskFault):
                inj.check_disk("write", "/x/shard-00000.pkl")
            assert issubclass(fi.InjectedDiskFault, OSError)
        else:
            inj.check_disk("read", "/x/manifest.json")
            assert sleeps == [fires]
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_CHECKPOINT_DIR", "ckpt"),
    ("HOROVOD_DRAIN_GRACE_SECONDS", "30"),
    ("HOROVOD_PREEMPT_SIGNAL", "SIGUSR1"),
])
def test_durability_knobs_are_read_as_in_the_jax_package(monkeypatch, tmp_path, knob, value):
    """The knobs of the durability and drain planes, once raise cases:
    ``hvd.init()`` takes them, and the port reads each as the JAX package
    does (the checkpoint manager of the directory, the grace, the signal)."""
    from horovod_tpu.utils import env as jax_env

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import checkpoint, env as port_env

    if knob == "HOROVOD_CHECKPOINT_DIR":
        value = str(tmp_path / value)
    monkeypatch.setenv(knob, value)
    hvd.init(device="cpu")
    try:
        assert hvd.is_initialized()
        assert port_env.checkpoint_dir() == jax_env.checkpoint_dir()
        assert port_env.drain_grace_seconds() == jax_env.drain_grace_seconds()
        assert port_env.preempt_signal() == jax_env.preempt_signal()
        mgr = checkpoint.manager_from_env()
        if knob == "HOROVOD_CHECKPOINT_DIR":
            assert mgr.directory == value and os.path.isdir(value)
        else:
            assert mgr is None
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("knob,value", [
    ("HVDRUN_USE_TASK_SERVICE", "1"),
    ("HOROVOD_CONTROLLER_INTERVAL_SECONDS", "30"),
])
def test_durability_knobs_raise_naming_a7(monkeypatch, knob, value):
    """The knobs of the rest of A7 (the elasticity controller, the
    task-service launch)."""
    import horovod_tpu_torch as hvd

    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


@pytest.mark.parametrize("knob,value", [("HOROVOD_JOB_NAME", "trainer"),
                                        ("HOROVOD_FLEET_SLOTS", "8")])
def test_shared_server_knobs_raise_naming_a9(monkeypatch, knob, value):
    """Jobs sharing one rendezvous server (key namespaces, capacity
    arbitration) serve the serving plane."""
    import horovod_tpu_torch as hvd

    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_config_file_matches_the_jax_launcher(tmp_path):
    """YAML defaults under the flags given on the command line."""
    path = tmp_path / "hvd.yaml"
    path.write_text("tuning:\n  fusion-threshold-mb: 16\n  cycle_time_ms: 3\n"
                    "verbose: true\nnum_proc: 4\n")
    argv = ["--config-file", str(path), "--cycle-time-ms", "9", "python", "x.py"]
    got = launch.make_parser().parse_args(argv)
    launch._apply_config_file(launch.make_parser(), got)
    want = jax_launch.make_parser().parse_args(argv)
    jax_launch._apply_config_file(jax_launch.make_parser(), want)
    keys = ("fusion_threshold_mb", "cycle_time_ms", "verbose", "num_proc", "command")
    assert [getattr(got, k) for k in keys] == [getattr(want, k) for k in keys]
    assert got.cycle_time_ms == 9 and got.fusion_threshold_mb == 16
    path.write_text("no_such_flag: 1\n")
    with pytest.raises(SystemExit, match="unknown config-file keys"):
        launch._apply_config_file(launch.make_parser(), launch.make_parser().parse_args(
            ["--config-file", str(path), "true"]))


def test_run_returns_each_rank_result():
    """``runner.run``: a function on two processes, results in rank order."""
    from horovod_tpu_torch.runner import run

    assert run(functools.partial(os.getenv, "HOROVOD_RANK"), np=2) == ["0", "1"]


def test_task_service_switch_raises_at_launch(monkeypatch, tmp_path):
    monkeypatch.setenv("HVDRUN_USE_TASK_SERVICE", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        launch.run_commandline(["-np", "1", "true"])


def test_check_build_names_the_port():
    text = launch.check_build()
    assert "PyTorch" in text and "NCCL" in text and "JAX" not in text
