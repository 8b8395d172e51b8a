"""The port's metrics plane (``horovod_tpu_torch/common/telemetry.py``,
``common/metrics_export.py`` and the series the engine, checkpoint, drain,
elastic, retry and fault modules register) against the JAX package's.

* Registries: the same seeded sequence of ``inc``/``set``/``observe``
  calls gives byte-equal Prometheus text and equal JSON in both packages
  (the build identity, which names each package, is not registered), and
  each package's ``parse_prometheus`` reads the other's text.
* Fleet blobs: an ``encode_push`` blob of either package is read by the
  other's ``FleetView`` into the same snapshot; garbage is ignored by both.
* Exporters: the HTTP server on a free port serves ``/metrics``,
  ``/metrics.json``, a registered view and the JAX 404 listing; the file
  writer dumps the JSON; ``HOROVOD_METRICS_PORT`` and
  ``HOROVOD_METRICS_FILE`` start both through ``hvd.init(device="cpu")``
  in mesh and in process mode, and ``shutdown()`` frees the port for a
  second ``init``.
* Engine series: one sequence of named all-reduces, all-gathers,
  broadcasts and an all-to-all through the JAX engine at 2 ranks (threads
  over ``ThreadedGroup``) and the port's on 2 spawned gloo ranks, fusion
  off: the same metric names and label keys, the same tensors, bytes and
  responses, and as many latency observations.
* The fleet view at 2 gloo ranks: rank 0's view holds both ranks, each
  rank's values as that rank read them, min and max tagged with the rank.
* Checkpoint, drain, retry and driver series move on the same events in
  both packages; a ZeRO step sets the optimizer-state gauges.
"""
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.backend.threaded import ThreadedGroup
from horovod_tpu.common import checkpoint as jax_ck
from horovod_tpu.common import drain as jax_drain
from horovod_tpu.common import metrics_export as jax_export
from horovod_tpu.common import telemetry as jax_tel
from horovod_tpu.elastic import state as jax_state
from horovod_tpu.engine.engine import Engine as JaxEngine
from horovod_tpu.runner import rendezvous_server as jax_rs
from horovod_tpu.runner.elastic import discovery as jax_disc
from horovod_tpu.runner.elastic.driver import ElasticDriver as JaxDriver
from horovod_tpu.utils import retry as jax_retry

from horovod_tpu_torch.common import checkpoint as ck
from horovod_tpu_torch.common import drain
from horovod_tpu_torch.common import metrics_export as port_export
from horovod_tpu_torch.common import telemetry as port_tel
from horovod_tpu_torch.elastic import state as port_state
from horovod_tpu_torch.runner import rendezvous_server as rs
from horovod_tpu_torch.runner.elastic import discovery
from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
from horovod_tpu_torch.utils import retry as port_retry

import _torch_port_workers as workers

TEL = {"port": port_tel, "jax": jax_tel}
EXPORT = {"port": port_export, "jax": jax_export}


def _feed(tel, seed: int):
    """A registry of ``tel``'s package after a seeded run of counter,
    gauge and histogram calls, with labels, help texts and label values
    that need escaping, values on the histogram's bucket bounds, below and
    above its range, and a pull gauge whose callback fails (NaN)."""
    reg = tel.MetricsRegistry()
    rng = np.random.RandomState(seed)
    ops = ["allreduce", "allgather", 'we"ird\\op\nx']
    for _ in range(300):
        kind, i = rng.randint(3), rng.randint(3)
        labels = {"op": ops[rng.randint(3)]} if rng.randint(2) else None
        if kind == 0:
            reg.counter(f"hvd_test_{i}_total", f"counter {i}\nsecond \\ line",
                        labels).inc(int(rng.randint(1, 1 << 40)))
        elif kind == 1:
            g = reg.gauge(f"hvd_test_{i}_gauge", f"gauge {i}", labels)
            if rng.randint(2):
                g.set(float(rng.randn()) * 10.0 ** rng.randint(-8, 8))
            else:
                g.inc(int(rng.randint(-5, 6)))
        else:
            exps = (-20, 6) if i else (0, 12)
            h = reg.histogram(f"hvd_test_{i}_seconds", f"histogram {i}", labels,
                              min_exp=exps[0], max_exp=exps[1])
            pick = rng.randint(4)
            v = (2.0 ** rng.randint(exps[0] - 2, exps[1] + 3) if pick == 0 else
                 float(rng.randint(0, 5)) if pick == 1 else
                 abs(float(rng.randn())) * 10.0 ** rng.randint(-7, 3))
            h.observe(v)
    reg.gauge("hvd_test_nan", "a pull gauge whose callback raises").set_function(
        lambda: 1 / 0)
    return reg


def _untimed(text: str) -> str:
    return re.sub(r'"time": [0-9.e+-]+', '"time": 0', text)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registries_render_the_same_text(seed):
    port, jax = _feed(port_tel, seed), _feed(jax_tel, seed)
    text = port_export.to_prometheus(port)
    assert text == jax_export.to_prometheus(jax)
    assert "NaN" in text and '\\"' in text and "\\n" in text
    assert _untimed(port_export.to_json(port)) == _untimed(jax_export.to_json(jax))
    assert port.scalars().keys() == jax.scalars().keys()
    for reader, writer in ((port_export, jax), (jax_export, port)):
        samples, types, helps = reader.parse_prometheus(
            (jax_export if reader is port_export else port_export).to_prometheus(writer))
        mine = (port_export if reader is port_export else jax_export).parse_prometheus(text)
        assert (types, helps) == mine[1:]
        assert samples.keys() == mine[0].keys()
        for k, v in samples.items():
            assert v == mine[0][k] or (v != v and mine[0][k] != mine[0][k]), k


def _without_ages(snap: dict) -> dict:
    snap = json.loads(json.dumps(snap))
    for entry in snap["ranks"].values():
        entry.pop("age_seconds")
    return snap


@pytest.mark.parametrize("src", ["port", "jax"])
def test_each_fleet_view_reads_the_other_packages_push(src):
    dst = "jax" if src == "port" else "port"
    blobs = [TEL[src].encode_push(_feed(TEL[src], r), r) for r in range(3)]
    views = {name: TEL[name].FleetView(3) for name in (src, dst)}
    for view in views.values():
        for r, blob in enumerate(blobs):
            view.ingest(blob, rank_hint=r)
        for garbage in (b"\xff\xfenot json", b"{}", b"[1, 2]", b'{"rank": "x"}',
                        b'{"rank": 1, "metrics": [1]}', b'{"rank": -2, "metrics": {}}'):
            view.ingest(garbage)
    snaps = {name: _without_ages(v.snapshot()) for name, v in views.items()}
    assert snaps[src] == snaps[dst]
    assert sorted(snaps[dst]["ranks"]) == ["0", "1", "2"]
    agg = snaps[dst]["aggregate"]
    assert agg and all(a["count"] == 3 and a["min"] <= a["max"] for a in agg.values())


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_and_file_exporters_serve_what_the_jax_ones_serve(tmp_path):
    out = {}
    for name in ("port", "jax"):
        reg = _feed(TEL[name], 5)
        fleet = TEL[name].FleetView(2)
        fleet.ingest(TEL[name].encode_push(reg, 1))
        srv = EXPORT[name].MetricsHTTPServer(0, reg, fleet).start()
        srv.add_view("status", lambda: {"rank": 0, "queue_depth": 3})
        path = str(tmp_path / f"{name}.{{rank}}.json")
        writer = EXPORT[name].MetricsFileWriter(path, reg, fleet, interval=0.05,
                                                rank=1).start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            out[name] = {"metrics": _get(base + "/metrics"),
                         "json": _get(base + "/metrics.json"),
                         "status": _get(base + "/status"),
                         "missing": _get(base + "/nope")}
            assert out[name]["metrics"] == (200, EXPORT[name].to_prometheus(reg))
        finally:
            srv.stop()
            writer.stop()
        doc = json.loads((tmp_path / f"{name}.1.json").read_text())
        assert doc["rank"] == 1 and doc["metrics"] == json.loads(
            EXPORT[name].to_json(reg))["metrics"]
        out[name]["file_fleet"] = sorted(doc["fleet"]["ranks"])
    port, jax = out["port"], out["jax"]
    assert port["metrics"] == jax["metrics"]
    assert port["status"] == jax["status"] == (200, json.dumps(
        {"queue_depth": 3, "rank": 0}, indent=1, sort_keys=True))
    assert port["missing"] == jax["missing"]
    assert port["missing"][0] == 404 and "/status" in port["missing"][1]
    pj, jj = (json.loads(x["json"][1]) for x in (port, jax))
    assert pj["metrics"] == jj["metrics"]
    assert _without_ages(pj["fleet"]) == _without_ages(jj["fleet"])
    assert port["file_fleet"] == jax["file_fleet"] == ["1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["mesh", "process"])
def test_knobs_start_the_exporters_in_both_modes(monkeypatch, tmp_path, mode):
    """Mesh mode starts the exporters in ``init`` (the registry and a
    small status view); process mode lets the engine own them (its
    ``/status``). Both serve the engine's series, the world size and the
    build identity; ``shutdown`` stops them, and a second ``init`` binds
    the same port again."""
    import horovod_tpu_torch as hvd

    port = _free_port()
    monkeypatch.setenv("HOROVOD_METRICS_PORT", str(port))
    monkeypatch.setenv("HOROVOD_METRICS_FILE", str(tmp_path / "m.{rank}.json"))
    monkeypatch.setenv("HOROVOD_METRICS_FILE_INTERVAL", "0.05")
    monkeypatch.setenv("HOROVOD_PREEMPT_SIGNAL", "SIGUSR2")
    if mode == "process":
        monkeypatch.setenv("HOROVOD_RANK", "0")
        monkeypatch.setenv("HOROVOD_SIZE", "1")
    try:
        for attempt in range(2):
            hvd.init(device="cpu")
            try:
                assert hvd.mode() == mode
                hvd.allreduce(torch.ones(3), name=f"knob{attempt}")
                code, text = _get(f"http://127.0.0.1:{port}/metrics")
                assert code == 200
                samples, types, _ = port_export.parse_prometheus(text)
                assert samples["horovod_world_size"] == 1
                assert samples["horovod_allreduce_tensors_total"] >= 1
                assert types["horovod_op_latency_seconds"] == "histogram"
                assert any(k.startswith("horovod_build_info{") and 'package="horovod_tpu_torch"'
                           in k for k in samples)
                code, body = _get(f"http://127.0.0.1:{port}/status")
                status = json.loads(body)
                snap = hvd.metrics()
                assert snap["mode"] == mode and snap["size"] == 1
                if mode == "process":
                    assert "queue_depth" in status and "channels" in status
                    assert snap["status"]["rank"] == 0 and "fleet" in snap
                else:
                    assert status == {"rank": 0, "size": 1, "mode": "mesh"}
                    assert "status" not in snap and "fleet" not in snap
            finally:
                hvd.shutdown()
            with pytest.raises(urllib.error.URLError):
                urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)
        doc = json.loads((tmp_path / "m.0.json").read_text())
        assert doc["rank"] == 0 and doc["metrics"]["horovod_allreduce_tensors_total"] >= 2
    finally:
        drain.coordinator.reset()


# ---------------------------------------------------------------------------
# Engine series against the JAX engine
ENGINE_FAMILIES = (
    "horovod_cycle_seconds", "horovod_cycle_wakeups_total", "horovod_responses_total",
    "horovod_response_tensors", "horovod_response_bytes", "horovod_executor_queue_depth",
    "horovod_tensor_queue_depth", "horovod_inflight_responses",
    "horovod_last_cycle_age_seconds", "horovod_op_latency_seconds",
    "horovod_response_cache_hits_total", "horovod_response_cache_misses_total",
    "horovod_response_cache_invalidations_total",
    "horovod_tensor_queue_latched_errors_total", "horovod_tensor_queue_aborted_entries_total",
    "horovod_stall_warnings_total", "horovod_stall_aborts_total",
    "horovod_straggler_rank", "horovod_negotiation_wait_seconds",
) + tuple(f"horovod_{t}_{w}_total" for t in ("allreduce", "allgather", "broadcast", "alltoall")
          for w in ("tensors", "bytes"))
# Integer series that must be equal, and histograms whose count and sum
# must be.
EXACT = tuple(f for f in ENGINE_FAMILIES if f.endswith(("_tensors_total", "_bytes_total")))
EXACT_HIST = ("horovod_response_tensors", "horovod_response_bytes")
ENV = {"HOROVOD_FUSION_THRESHOLD": "0", "HOROVOD_CYCLE_TIME": "1"}


def _family(key: str) -> str:
    return key.split("{", 1)[0]


def _label_keys(key: str) -> tuple:
    return tuple(sorted(re.findall(r'(\w+)="', key)))


def _engine_view(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if _family(k) in ENGINE_FAMILIES}


def _delta(after, before):
    if isinstance(after, dict):
        b = before or {"count": 0, "sum": 0.0}
        return {"count": after["count"] - b["count"], "sum": after["sum"] - b["sum"]}
    return after - (before or 0)


def _jax_series(size: int) -> list:
    with pytest.MonkeyPatch.context() as patch:
        for k, v in ENV.items():
            patch.setenv(k, v)
        group = ThreadedGroup(size)
        regs = [jax_tel.MetricsRegistry() for _ in range(size)]
        engines = [JaxEngine(rank=r, size=size, backend=group.backend(r), registry=regs[r])
                   for r in range(size)]
        for e in engines:
            e.cycle_time_s = 0.001
            e.start()
    errors = [None] * size

    def body(r):
        try:
            workers.telemetry_ops(engines[r], r, size, np.asarray)
        except BaseException as ex:  # noqa: BLE001 - re-raised below
            errors[r] = ex

    threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    out = [reg.snapshot() for reg in regs]
    stops = [threading.Thread(target=e.shutdown) for e in engines]
    for t in stops:
        t.start()
    for t in stops:
        t.join(timeout=60)
    for err in errors:
        if err is not None:
            raise err
    return out


@pytest.fixture(scope="module")
def engine_series(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry_engine")
    port = workers.spawn_world(2, tmp, "_run_telemetry_world", env=ENV)
    return port, _jax_series(2)


def test_engine_series_have_the_jax_names_and_labels(engine_series):
    port, jax = engine_series
    for r in range(2):
        got = {(_family(k), _label_keys(k)) for k in _engine_view(port[r]["after"])}
        want = {(_family(k), _label_keys(k)) for k in _engine_view(jax[r])}
        assert got == want, (r, got ^ want)
        # The same series, label values included, except the op label,
        # which names each package's implementation (GLOO_ALLREDUCE, ...).
        got = {k for k in _engine_view(port[r]["after"]) if "op=" not in k}
        assert got == {k for k in _engine_view(jax[r]) if "op=" not in k}, r


def test_engine_series_count_what_the_jax_engine_counts(engine_series):
    port, jax = engine_series
    for r in range(2):
        after, before = port[r]["after"], port[r]["before"]
        for f in EXACT + ("horovod_responses_total",):
            assert _delta(after.get(f, 0), before.get(f)) == jax[r].get(f, 0), (r, f)
        for f in EXACT_HIST:
            assert _delta(after[f], before.get(f)) == {
                "count": jax[r][f]["count"], "sum": jax[r][f]["sum"]}, (r, f)
        lat = {k: v for k, v in after.items() if _family(k) == "horovod_op_latency_seconds"}
        got = sum(_delta(v, before.get(k))["count"] for k, v in lat.items())
        want = sum(v["count"] for k, v in jax[r].items()
                   if _family(k) == "horovod_op_latency_seconds")
        assert got == want == 4 + 3 + 2 + 2 + 1, (r, got, want)
        assert all(_delta(v, before.get(k))["sum"] > 0 for k, v in lat.items())
        assert {re.search(r'op="(\w+)"', k).group(1) for k in lat} == {
            "GLOO_ALLREDUCE", "GLOO_ALLGATHER", "GLOO_BROADCAST", "GLOO_ALLTOALL"}
    assert port[0]["after"]["horovod_allgather_bytes_total"] == 4 * 3 * (1 + 2)
    assert port[1]["after"]["horovod_allgather_bytes_total"] == 4 * 3 * (2 + 3)


def test_the_fleet_view_at_two_gloo_ranks(tmp_path):
    res = workers.spawn_world(2, tmp_path, "_run_fleet_world", 2.0,
                              env={**ENV, "HOROVOD_METRICS_SYNC_SECONDS": "0.1"})
    assert [r["mode"] for r in res] == ["process", "process"]
    fleet = res[0]["fleet"]
    assert res[1]["fleet"] is None and fleet["size"] == 2
    assert sorted(fleet["ranks"]) == [0, 1]
    key = "horovod_allgather_bytes_total"
    own = [res[r]["own"][key] for r in range(2)]
    assert own == [3 * 4 * 4, 3 * 8 * 4]
    for r in range(2):
        assert fleet["ranks"][r]["metrics"][key] == own[r]
    agg = fleet["aggregate"][key]
    assert (agg["min"], agg["min_rank"], agg["max"], agg["max_rank"]) == (
        own[0], 0, own[1], 1)
    assert agg["sum"] == sum(own) and agg["count"] == 2
    assert res[0]["status"]["size"] == 2


# ---------------------------------------------------------------------------
# The other planes' series

CKPT = ("writes", "failures", "commits", "restores", "skipped")


def _checkpoint_series(mod: str, tmp_path) -> dict:
    m, st_mod, tel = (ck, port_state, port_tel) if mod == "port" else (
        jax_ck, jax_state, jax_tel)
    from horovod_tpu.common import fault_injection as jax_fi

    from horovod_tpu_torch.common import fault_injection as fi

    f = fi if mod == "port" else jax_fi
    reg = tel.MetricsRegistry()
    mgr = m.CheckpointManager(str(tmp_path / mod), interval_steps=0, fsync=False,
                              registry=reg)
    st = st_mod.ObjectState(batch=1)
    try:
        assert mgr.save(st, step=1, blocking=True)
        f.injector.install(f.parse_spec("diskfail:op=write:path=shard-"))
        mgr.save(st, step=2, blocking=True)
        slow = f.parse_spec("diskslow:secs=0.3:op=write:path=shard-")
        f.injector.install(slow)
        assert mgr.save(st, step=3) and not mgr.save(st, step=4)
        # The wait follows the write in flight, the shard and its sidecar each
        # slowed once, as the JAX package's tests wait on a busy writer, not a
        # wall-clock bound on how fast a loaded host runs it.
        assert mgr.flush()
        assert slow[0].hits == 2
    finally:
        f.injector.install([])
    restorer = m.CheckpointManager(str(tmp_path / mod), interval_steps=0, fsync=False,
                                   registry=reg)
    assert restorer.restore_latest(st_mod.ObjectState(batch=0)) == 3
    mgr.stop()
    return reg.snapshot()


def test_checkpoint_series_move_as_in_the_jax_package(tmp_path):
    port, jax = (_checkpoint_series(m, tmp_path) for m in ("port", "jax"))
    for k in CKPT:
        name = f"horovod_checkpoint_{k}_total"
        assert port[name] == jax[name], name
    assert [port[f"horovod_checkpoint_{k}_total"] for k in CKPT] == [2, 1, 2, 1, 1]
    for h in ("write", "commit"):
        name = f"horovod_checkpoint_{h}_seconds"
        assert port[name]["count"] == jax[name]["count"] == 2, name
    assert port["horovod_checkpoint_last_step"] == jax["horovod_checkpoint_last_step"] == 3
    assert port["horovod_checkpoint_bytes_total"] > 0


def _delta_of(tel, names, fn):
    reg = tel.default_registry()
    before = {n: reg.snapshot().get(n) for n in names}
    fn()
    after = reg.snapshot()
    return {n: _delta(after.get(n, 0), before[n]) for n in names}


def test_drain_series_move_as_in_the_jax_package(monkeypatch):
    """A managed notice counts one preemption; the drained exit observes
    the notice-to-drained seconds."""
    monkeypatch.setenv("HOROVOD_PREEMPT_SIGNAL", "SIGUSR1")
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", raising=False)
    names = ("horovod_preemptions_total", "horovod_drain_seconds")
    got = {}
    for name, mod, tel in (("port", drain, port_tel), ("jax", jax_drain, jax_tel)):
        c = mod.DrainCoordinator()
        c._exit = lambda code: None
        c.set_managed(True)

        def run():
            c.request("test")
            time.sleep(0.02)
            with pytest.raises(SystemExit):
                c.execute(None)

        try:
            got[name] = _delta_of(tel, names, run)
        finally:
            c.reset()
    assert got["port"]["horovod_preemptions_total"] == got["jax"][
        "horovod_preemptions_total"] == 1
    for d in (got["port"]["horovod_drain_seconds"], got["jax"]["horovod_drain_seconds"]):
        assert d["count"] == 1 and d["sum"] >= 0.02


def test_retry_series_move_as_in_the_jax_package():
    got = {}
    for name, mod, tel in (("port", port_retry, port_tel), ("jax", jax_retry, jax_tel)):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionRefusedError("down")
            return "up"

        got[name] = _delta_of(tel, ("horovod_retry_attempts_total",), lambda: mod.call_with_retry(
            flaky, "probe", attempts=5, base=0.001, cap=0.002))
    assert got["port"] == got["jax"] == {"horovod_retry_attempts_total": 2}


def test_driver_series_move_as_in_the_jax_driver(monkeypatch):
    """A worker death re-meshed once and its host blacklisted; a silent
    slot evicted at the ready deadline."""
    import test_torch_port_launch as launch

    names = ("horovod_elastic_recovery_seconds", "horovod_hosts_blacklisted_total",
             "horovod_elastic_evictions_total")
    got = {}
    for name, server, driver_cls, disc, tel in (
            ("port", rs.RendezvousServer, ElasticDriver, discovery, port_tel),
            ("jax", lambda: jax_rs.RendezvousServer(fleet_slots=0), JaxDriver, jax_disc,
             jax_tel)):
        hosts0, min_np, max_np, steps = launch.DRIVER_CASES["worker_death"]
        death = _delta_of(tel, names, lambda: launch._drive(
            server, driver_cls, disc, hosts0, min_np, max_np, steps, monkeypatch))

        def silent():
            monkeypatch.setenv("HOROVOD_ELASTIC_READY_TIMEOUT", "0.3")
            srv = server()
            drv = driver_cls(srv, disc.FixedHosts({"a": 1, "b": 1}), 1, 2,
                             poll_interval=0.05)
            drv.start(lambda slot, env: launch.FakeProc())
            try:
                srv.handle_put("ready_e0/a:0", b"1")
                deadline = time.monotonic() + 5
                while drv.epoch < 1 and time.monotonic() < deadline:
                    time.sleep(0.02)
                assert drv.epoch == 1
            finally:
                drv.stop()
            monkeypatch.delenv("HOROVOD_ELASTIC_READY_TIMEOUT")

        evict = _delta_of(tel, names, silent)
        got[name] = (death, evict)
    for death, evict in got.values():
        assert death["horovod_elastic_recovery_seconds"]["count"] == 1
        assert death["horovod_hosts_blacklisted_total"] == 1
        assert death["horovod_elastic_evictions_total"] == 0
        assert evict["horovod_elastic_evictions_total"] == 1
        assert evict["horovod_elastic_recovery_seconds"]["count"] == 1

    def counts(d):
        return {k: (v["count"] if isinstance(v, dict) else v) for k, v in d.items()}

    assert [counts(d) for d in got["port"]] == [counts(d) for d in got["jax"]]


def test_zero_sets_the_optimizer_state_gauges():
    """A ZeRO step sets ``horovod_optimizer_state_bytes{mode}`` to the
    state it holds: AdamW's two f32 moments of every element, the whole of
    them at one rank."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        net = torch.nn.Linear(8, 4)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(net.parameters(), lr=1e-3), zero=1)
        net(torch.randn(3, 8)).sum().backward()
        opt.step()
        snap = port_tel.default_registry().snapshot()
        want = 2 * 4 * sum(p.numel() for p in net.parameters())
        assert opt.state_bytes() == want
        assert snap['horovod_optimizer_state_bytes{mode="sharded"}'] == want
        assert snap['horovod_optimizer_state_bytes{mode="replicated"}'] == want
    finally:
        hvd.shutdown()
