"""The port's durability plane (``horovod_tpu_torch/common/checkpoint.py``,
``utils/atomic_file.py``, the disk rules of ``common/fault_injection.py``
and ``TorchState``'s hooks) against the JAX package's: the same shard
cut, rule grammar, tmp naming and debris rules; each package reads the
other's checkpoints bitwise; discovery and GC choose the same step and
leave the same files over one directory of torn attempts; a kill-all
round trip through the port's launcher on two gloo workers resumes
bitwise an uninterrupted run and restores bitwise at worlds 1 and 3;
``TorchState`` round-trips a toy GPT-2 bitwise (bf16 too), and a changed
model raises; ``diskfail`` never commits, ``diskslow`` survives."""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from horovod_tpu.common import checkpoint as jax_ck
from horovod_tpu.common import fault_injection as jax_fi
from horovod_tpu.elastic import state as jax_state
from horovod_tpu.utils import atomic_file as jax_af

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import checkpoint as ck
from horovod_tpu_torch.common import fault_injection as fi
from horovod_tpu_torch.elastic import state as port_state
from horovod_tpu_torch.utils import atomic_file as af

import _torch_port_elastic_workers as workers


@pytest.fixture(autouse=True)
def _no_injected_faults(monkeypatch):
    monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
    monkeypatch.setattr(fi, "injector", fi.FaultInjector())
    monkeypatch.setattr(jax_fi, "injector", jax_fi.FaultInjector())


# ---------------------------------------------------------------------------
# The shard cut, the rules, the tmp names

@pytest.mark.parametrize("seed,n,shards", [(0, 10, 1), (1, 10, 3), (2, 7, 4), (3, 3, 5),
                                           (4, 450, 4), (5, 1, 2), (6, 0, 3), (7, 64, 7)])
def test_shard_ranges_match_jax(seed, n, shards):
    rng = np.random.RandomState(seed)
    sizes = [int(x) for x in rng.randint(0, 1 << 20, size=n)]
    if n > 4:
        sizes[rng.randint(n)] = 1 << 28            # one leaf heavier than the rest
    assert ck.shard_ranges(sizes, shards) == jax_ck.shard_ranges(sizes, shards)


@pytest.mark.parametrize("spec", [
    "diskfail", "diskfail:after=2", "diskfail:op=write:path=shard-", "diskfail:op=read:rank=1",
    "diskslow:secs=0.5", "diskslow:secs=2:op=write:after=1:path=manifest",
    "preempt:step=5", "preempt:step=5:rank=3", "preempt:secs=12.5",
    "kill:step=3;preempt:step=4:rank=1;diskfail:after=1",
])
def test_durability_rules_parse_as_in_the_jax_package(spec):
    assert [dataclasses.asdict(r) for r in fi.parse_spec(spec)] == \
        [dataclasses.asdict(r) for r in jax_fi.parse_spec(spec)]
    fi.check_supported(fi.parse_spec(spec))


@pytest.mark.parametrize("spec", ["preempt", "preempt:secs=0", "diskslow",
                                  "diskfail:op=send", "preempt:path=x", "diskslow:secs=-1"])
def test_bad_durability_rules_raise_as_in_the_jax_package(spec):
    with pytest.raises(ValueError):
        jax_fi.parse_spec(spec)
    with pytest.raises(ValueError):
        fi.parse_spec(spec)


DEBRIS_NAMES = ["manifest-0000000004.json", "manifest-0000000004.json.tmp.12.345",
                "shard-00000.pkl.tmp.9.1", "shard-00000.pkl", "shard-00000.pkl.meta.json",
                "ckpt-0000000002", "x.tmp", "a.tmp.b", ".tmp.", "tmp"]


def test_atomic_file_tmp_names_and_debris_match_jax(tmp_path):
    assert [af.is_tmp_debris(n) for n in DEBRIS_NAMES] == \
        [jax_af.is_tmp_debris(n) for n in DEBRIS_NAMES]
    assert af.TMP_MARKER == jax_af.TMP_MARKER
    path = str(tmp_path / "f.bin")
    for mod in (af, jax_af):
        prefix, _, rest = mod.tmp_path_for(path).rpartition(af.TMP_MARKER)
        pid, _, ns = rest.partition(".")
        assert prefix == path and int(pid) == os.getpid() and int(ns) > 0


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_atomic_write_leaves_the_old_file_and_no_tmp_on_failure(tmp_path, mod):
    m = af if mod == "port" else jax_af
    path = str(tmp_path / "d" / "f.bin")
    m.atomic_write_bytes(path, b"old", fsync=True)

    def fill(f):
        f.write(b"half")
        raise OSError("disk full")

    with pytest.raises(OSError):
        m.atomic_write(path, fill)
    assert open(path, "rb").read() == b"old"
    assert os.listdir(tmp_path / "d") == ["f.bin"]
    assert m.checked_read_bytes(path) == b"old"


# ---------------------------------------------------------------------------
# Each package reads the other's checkpoints

class NumpyState(port_state.ObjectState):
    """A state of numpy leaves on the port's side (the counterpart of a
    ``JaxState`` holding numpy arrays)."""

    def __init__(self, params=None, **kwargs):
        self.params = params
        super().__init__(**kwargs)

    def save(self):
        super().save()
        self._saved_params = {k: v.copy() for k, v in (self.params or {}).items()}

    def checkpoint_trees(self) -> dict:
        return {"params": [self._saved_params[k] for k in sorted(self._saved_params)]}

    def load_checkpoint(self, objects, trees):
        keys = sorted(self.params)
        if len(keys) != len(trees["params"]):
            raise ValueError("leaf count")
        self.params = {k: np.array(v) for k, v in zip(keys, trees["params"])}
        super().load_checkpoint(objects, {})


def _numpy_params(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"b": rng.standard_normal(7).astype(np.float32),
            "w": rng.standard_normal((3, 5)).astype(np.float64),
            "i": rng.randint(0, 99, size=(4,)).astype(np.int32),
            "s": np.float32(rng.standard_normal())}


@pytest.mark.parametrize("kind", ["objects", "numpy_leaves"])
@pytest.mark.parametrize("size", [1, 3])
def test_jax_checkpoint_loads_bitwise_in_the_port(tmp_path, kind, size):
    """The JAX manager writes (one shard a rank of a world of ``size``);
    the port finds, checks and loads it bitwise."""
    params = _numpy_params(size)
    for r in reversed(range(size)):            # the coordinator, rank 0, last
        if kind == "objects":
            st = jax_state.ObjectState(batch=11, history=[(0, 2), (1, 2)])
        else:
            st = jax_state.JaxState(params=params, batch=11)
        jax_ck.CheckpointManager(str(tmp_path), rank=r, size=size, interval_steps=0,
                                 fsync=False).save(st, step=11, blocking=True)
    step, man, _ = ck.find_latest_manifest(str(tmp_path))
    assert step == 11 and len(man["shards"]) == size
    if kind == "objects":
        got = port_state.ObjectState(batch=0, history=[])
    else:
        got = NumpyState(params={k: np.zeros_like(v) for k, v in params.items()}, batch=0)
    assert ck.CheckpointManager(str(tmp_path), fsync=False).restore_latest(got) == 11
    assert got.batch == 11
    if kind == "objects":
        assert got.history == [(0, 2), (1, 2)]
    else:
        for k, v in params.items():
            assert got.params[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got.params[k], v)


@pytest.mark.parametrize("kind", ["objects", "numpy_leaves", "torch_state"])
@pytest.mark.parametrize("size", [1, 2])
def test_port_checkpoint_loads_bitwise_in_the_jax_package(tmp_path, kind, size):
    """The port's manager writes; the JAX package finds, CRC-checks and
    loads it: objects into its ObjectState, numpy leaves into a JaxState,
    a TorchState's tensors as the numpy arrays of their bytes."""
    params = _numpy_params(10 + size)
    model = opt = None
    if kind == "torch_state":
        model = workers.toy_model()
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
        workers.toy_step(model, opt, 0, 0)
    for r in reversed(range(size)):            # the coordinator, rank 0, last
        if kind == "objects":
            st = port_state.ObjectState(batch=5, history=["a", 1.5])
        elif kind == "numpy_leaves":
            st = NumpyState(params=params, batch=5)
        else:
            st = hvd.elastic.TorchState(model, opt, batch=5)
        ck.CheckpointManager(str(tmp_path), rank=r, size=size, interval_steps=0,
                             fsync=False).save(st, step=5, blocking=True)
    step, man, _ = jax_ck.find_latest_manifest(str(tmp_path))
    assert step == 5 and len(man["shards"]) == size
    objects, trees = jax_ck.load_checkpoint_arrays(str(tmp_path), man)
    if kind == "objects":
        got = jax_state.ObjectState(batch=0, history=[])
        got.load_checkpoint(objects, trees)
        assert got.batch == 5 and got.history == ["a", 1.5]
    elif kind == "numpy_leaves":
        got = jax_state.JaxState(params={k: np.zeros_like(v) for k, v in params.items()},
                                 batch=0)
        got.load_checkpoint(objects, trees)
        assert got.batch == 5
        for k, v in params.items():
            np.testing.assert_array_equal(np.asarray(got.params[k]), v)
            assert np.asarray(got.params[k]).dtype == np.asarray(v).dtype
    else:
        want = st.checkpoint_trees()
        assert sorted(trees) == sorted(want) == ["model", "optimizer"]
        for attr in want:
            for a, t in zip(trees[attr], want[attr]):
                np.testing.assert_array_equal(a, t.numpy())
        assert objects["batch"] == 5


# ---------------------------------------------------------------------------
# Discovery and GC over torn attempts

def _torn_directory(root: str):
    """Complete checkpoints at steps 2, 4, 6 and 8 (two shards each), then
    the wreckage of later attempts: a shard directory with no manifest
    (10), a manifest whose second shard is short (12), a manifest that is
    not JSON (14), a manifest of another format (16), root tmp debris and
    a shard's tmp file."""
    for step in (2, 4, 6, 8):
        for r in (1, 0):
            st = port_state.ObjectState(batch=step, rank=r)
            ck.CheckpointManager(root, rank=r, size=2, interval_steps=0, keep=10,
                                 fsync=False).save(st, step=step, blocking=True)
    os.makedirs(ck.step_dir(root, 10))
    with open(os.path.join(root, ck.shard_file(10, 0)), "wb") as f:
        f.write(b"partial")
    with open(os.path.join(root, ck.shard_file(10, 0) + ".tmp.1.2"), "wb") as f:
        f.write(b"partial")
    shutil.copytree(ck.step_dir(root, 8), ck.step_dir(root, 12))
    man = ck.load_manifest(ck.manifest_path(root, 8))
    man["step"] = 12
    for sh in man["shards"]:
        sh["file"] = sh["file"].replace("ckpt-0000000008", "ckpt-0000000012")
    with open(os.path.join(root, man["shards"][1]["file"]), "r+b") as f:
        f.truncate(3)
    with open(ck.manifest_path(root, 12), "w") as f:
        f.write(__import__("json").dumps(man))
    with open(ck.manifest_path(root, 14), "w") as f:
        f.write("{not json")
    with open(ck.manifest_path(root, 16), "w") as f:
        f.write('{"format": 99, "shards": []}')
    for name in ("manifest-0000000018.json.tmp.7.8", "junk.tmp.1.1"):
        with open(os.path.join(root, name), "w") as f:
            f.write("x")


def _tree(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_discovery_and_gc_match_jax_over_torn_attempts(tmp_path, keep):
    """The port's and the JAX package's discovery choose the same step, and
    their GC, purge and restore leave the same files, each in its own copy
    of one directory of torn attempts."""
    base = str(tmp_path / "base")
    _torn_directory(base)
    copies = {k: str(tmp_path / k) for k in ("port", "jax")}
    for d in copies.values():
        shutil.copytree(base, d)
    assert ck.find_latest_manifest(copies["port"])[0] == \
        jax_ck.find_latest_manifest(copies["jax"])[0] == 8
    ck.CheckpointManager(copies["port"], keep=keep, fsync=False)._gc()
    jax_ck.CheckpointManager(copies["jax"], keep=keep, fsync=False)._gc()
    assert _tree(copies["port"]) == _tree(copies["jax"])
    assert not any(af.is_tmp_debris(n) for n in os.listdir(copies["port"]))
    for d in copies.values():
        shutil.rmtree(d)
        shutil.copytree(base, d)
    ck.purge_newer_than(copies["port"], 8)
    jax_ck.purge_newer_than(copies["jax"], 8)
    assert _tree(copies["port"]) == _tree(copies["jax"])
    got = {}
    for k, d in copies.items():
        mod = ck if k == "port" else jax_ck
        st = (port_state if k == "port" else jax_state).ObjectState(batch=0, rank=-1)
        got[k] = (mod.CheckpointManager(d, fsync=False).restore_latest(st), st.batch)
    assert got["port"] == got["jax"] == (8, 8)
    assert _tree(copies["port"]) == _tree(copies["jax"])


def test_a_corrupt_newest_shard_falls_back_to_the_one_before(tmp_path):
    root = str(tmp_path)
    for step in (3, 6):
        ck.CheckpointManager(root, interval_steps=0, fsync=False).save(
            port_state.ObjectState(batch=step), step=step, blocking=True)
    path = os.path.join(root, ck.shard_file(6, 0))
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF                                 # same size, wrong CRC
    open(path, "wb").write(bytes(data))
    st = port_state.ObjectState(batch=0)
    mgr = ck.CheckpointManager(root, fsync=False)
    assert mgr.restore_latest(st) == 3 and st.batch == 3
    assert mgr.status()["failures"] == 1


# ---------------------------------------------------------------------------
# TorchState's hooks

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_state_round_trips_a_toy_gpt2_bitwise(tmp_path, dtype):
    """A toy GPT-2 (bf16 parameters too: numpy has no bfloat16, the leaf
    travels as the uint16 of its bits) and AdamW after two steps,
    checkpointed, loaded into a model of another seed and a fresh AdamW:
    bitwise, and the next step bitwise too."""
    model = workers.toy_model().to(dtype)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.1)
    for b in range(2):
        workers.toy_step(model, opt, b, 0)
    state = hvd.elastic.TorchState(model, opt, batch=2, note="x")
    mgr = ck.CheckpointManager(str(tmp_path), interval_steps=0, fsync=False)
    mgr.save(state, step=2, blocking=True)
    man = ck.find_latest_manifest(str(tmp_path))[1]
    kinds = {str(np.asarray(a).dtype) for a in ck.load_checkpoint_arrays(
        str(tmp_path), man)[1]["model"]}
    assert kinds == ({"uint16"} if dtype == torch.bfloat16 else {"float32"})
    other = workers.toy_model(seed=5).to(dtype)
    other_opt = torch.optim.AdamW(other.parameters(), lr=1e-2, weight_decay=0.1)
    got = hvd.elastic.TorchState(other, other_opt, batch=0)
    assert ck.CheckpointManager(str(tmp_path), fsync=False).restore_latest(got) == 2
    assert got.batch == 2 and got.note == "x"
    np.testing.assert_array_equal(workers.flat_state(other, other_opt),
                                  workers.flat_state(model, opt))
    workers.toy_step(model, opt, 7, 0)
    workers.toy_step(other, other_opt, 7, 0)
    np.testing.assert_array_equal(workers.flat_state(other, other_opt),
                                  workers.flat_state(model, opt))
    # The restore was snapshotted: an in-memory restore goes back to it.
    got.restore()
    assert got.batch == 2


@pytest.mark.parametrize("change", ["depth", "width", "dtype", "no_optimizer_state"])
def test_a_changed_model_raises(tmp_path, change):
    from horovod_tpu_torch.models.registry import get_model

    model = workers.toy_model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    workers.toy_step(model, opt, 0, 0)
    ck.CheckpointManager(str(tmp_path), interval_steps=0, fsync=False).save(
        hvd.elastic.TorchState(model, opt, batch=1), step=1, blocking=True)
    gen = torch.Generator().manual_seed(0)
    if change == "depth":
        other = get_model("gpt2-tiny").make_model(device="cpu", generator=gen, n_layers=3,
                                                  max_len=32)
    elif change == "width":
        other = get_model("gpt2-tiny").make_model(device="cpu", generator=gen, n_layers=2,
                                                  max_len=64)
    else:
        other = workers.toy_model()
        if change == "dtype":
            other = other.to(torch.float64)
    other_opt = torch.optim.AdamW(other.parameters(), lr=1e-2)
    st = hvd.elastic.TorchState(other, None if change == "no_optimizer_state" else other_opt,
                                batch=0)
    _, man, _ = ck.find_latest_manifest(str(tmp_path))
    objects, trees = ck.load_checkpoint_arrays(str(tmp_path), man)
    with pytest.raises(ValueError):
        st.load_checkpoint(objects, trees)


def test_object_state_without_tensors_refuses_tensor_leaves(tmp_path):
    model = workers.toy_model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    ck.CheckpointManager(str(tmp_path), interval_steps=0, fsync=False).save(
        hvd.elastic.TorchState(model, opt, batch=1), step=1, blocking=True)
    _, man, _ = ck.find_latest_manifest(str(tmp_path))
    with pytest.raises(ValueError, match="TorchState"):
        port_state.ObjectState(batch=0).load_checkpoint(
            *ck.load_checkpoint_arrays(str(tmp_path), man))


# ---------------------------------------------------------------------------
# The disk rules against the manager

@pytest.mark.parametrize("mod", ["port", "jax"])
def test_diskfail_never_commits(tmp_path, mod):
    """diskfail on the shard's write: no manifest, no shard, no tmp left,
    the failure counted, and the next checkpoint commits once the disk is
    back."""
    m, f = (ck, fi) if mod == "port" else (jax_ck, jax_fi)
    f.injector.install(f.parse_spec("diskfail:op=write:path=shard-"))
    mgr = m.CheckpointManager(str(tmp_path), interval_steps=0, fsync=False)
    st = (port_state if mod == "port" else jax_state).ObjectState(batch=1)
    mgr.save(st, step=1, blocking=True)
    assert m.list_manifests(str(tmp_path)) == []
    assert _tree(str(tmp_path)) == []
    assert mgr.status()["last_error"] is not None
    f.injector.install([])
    mgr.save(st, step=2, blocking=True)
    assert [s for s, _ in m.list_manifests(str(tmp_path))] == [2]


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_diskslow_survives(tmp_path, mod):
    m, f = (ck, fi) if mod == "port" else (jax_ck, jax_fi)
    f.injector.install(f.parse_spec("diskslow:secs=0.2:op=write:path=shard-"))
    mgr = m.CheckpointManager(str(tmp_path), interval_steps=0, fsync=False)
    st = (port_state if mod == "port" else jax_state).ObjectState(batch=1)
    assert mgr.save(st, step=1, blocking=True)
    assert [s for s, _ in m.list_manifests(str(tmp_path))] == [1]
    if mod == "port":
        assert mgr.status()["last_write_s"] >= 0.2
    # A read through the rules: a diskfail on reads fails the restore's
    # read, and restore falls back to nothing.
    f.injector.install(f.parse_spec("diskfail:op=read"))
    assert m.CheckpointManager(str(tmp_path), fsync=False).restore_latest(
        (port_state if mod == "port" else jax_state).ObjectState(batch=0)) is None


def test_backpressure_skips_a_snapshot_while_a_write_is_in_flight(tmp_path):
    fi.injector.install(fi.parse_spec("diskslow:secs=0.5:op=write:path=shard-"))
    mgr = ck.CheckpointManager(str(tmp_path), interval_steps=1, fsync=False)
    st = port_state.ObjectState(batch=0)
    assert mgr.maybe_save(st) and not mgr.maybe_save(st)
    assert mgr.flush(timeout=10)
    assert mgr.status()["skipped"] == 1
    assert [s for s, _ in ck.list_manifests(str(tmp_path))] == [1]
    mgr.stop()


# ---------------------------------------------------------------------------
# Kill-all through the launcher, on gloo workers

def _launch(tmp_path, name: str, np_: int, env: dict):
    return workers.launch_durable(tmp_path, name, np_, np_, env)


def test_kill_all_round_trip_through_the_launcher(tmp_path):
    """Two gloo workers checkpoint every 4 commits; kill:step=13 ends both,
    and the job, with the write of step 12 cut off. A restart at np=2
    restores the newest complete step, bitwise its manifest, and ends
    bitwise an uninterrupted run; restarts at np=1 and np=3 from copies of
    the directory restore the same bytes and train on with bitwise
    replicas."""
    ckpt = tmp_path / "ckpt"
    env = {"HOROVOD_CHECKPOINT_DIR": str(ckpt), "HOROVOD_CHECKPOINT_INTERVAL_STEPS": "4",
           "HOROVOD_CHECKPOINT_COMMIT_TIMEOUT_SECONDS": "20", "TEST_TOTAL_BATCHES": "15"}
    proc, recs = _launch(tmp_path, "control", 2, {"TEST_TOTAL_BATCHES": "15"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    control = [r["final"] for r in recs.values() if r.get("done")]
    assert len(control) == 2
    np.testing.assert_array_equal(control[0], control[1])
    proc, recs = _launch(tmp_path, "killed", 2, {**env, "HOROVOD_FAULT_INJECT": "kill:step=13"})
    assert proc.returncode != 0
    assert sorted(len(r["steps"]) for r in recs.values()) == [12, 12]
    step, man, _ = ck.find_latest_manifest(str(ckpt))
    assert step in (8, 12) and len(man["shards"]) == 2, step
    assert [s for s, _ in ck.list_manifests(str(ckpt))][:2] == [4, 8]
    digest = workers.leaves_digest(ck.load_checkpoint_arrays(str(ckpt), man)[1])
    for size in (1, 3):
        shutil.copytree(ckpt, tmp_path / f"ckpt{size}")
    proc, recs = _launch(tmp_path, "resumed", 2, env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    done = [r for r in recs.values() if r.get("done")]
    assert len(done) == 2
    for r in done:
        assert r["resume"] == {"step": step, "batch": step, "size": 2, "digest": digest}
        assert [s[0] for s in r["steps"]] == list(range(step + 1, 16))
        np.testing.assert_array_equal(r["final"], control[0])
        # One durable restore, no in-memory one, on every rank.
        assert r["metrics"]["horovod_checkpoint_restores_total"] == 1
        assert r["metrics"]["horovod_elastic_restores_total"] == 0
    for size in (1, 3):
        root = tmp_path / f"ckpt{size}"
        proc, recs = _launch(tmp_path, f"world{size}", size,
                             {**env, "HOROVOD_CHECKPOINT_DIR": str(root),
                              "TEST_TOTAL_BATCHES": str(step + 2)})
        assert proc.returncode == 0, proc.stderr[-3000:]
        done = [r for r in recs.values() if r.get("done")]
        assert len(done) == size
        for r in done:
            assert r["resume"] == {"step": step, "batch": step, "size": size,
                                   "digest": digest}
        for r in done[1:]:
            np.testing.assert_array_equal(r["final"], done[0]["final"])
        assert ck.find_latest_manifest(str(root))[0] == step
        assert not any(af.is_tmp_debris(n) for n in _tree(str(root)))
