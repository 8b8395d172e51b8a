"""The port's eager engine against the JAX package's.

* Messages: ``Request``, ``Response`` and their lists serialise to the same
  bytes in both packages, and each decodes the other's.
* Controllers: the same per-rank request sequences go through both
  coordinators, one thread per rank over an in-memory transport; every
  rank's response lists (types, names in order, fused groups, channel ids,
  codecs, error texts: the serialised bytes) and cache bits are equal.
  The cases are those of tests/test_engine.py: fusion under and over the
  threshold, the steady-state cache, shape, dtype and op mismatches, join
  with and without a cached tensor, allgather after join, cache
  invalidation on a shape change, divergent cache hits; and a three-rank
  mix with late ranks and bulk responses over both channels. A duplicate
  name is refused by both tensor queues with the same text.
* Engines: the port's engine on 2 and 3 spawned gloo ranks
  (tests/_torch_port_workers.py ``_run_engine_world``) against the JAX
  engine on as many threads over ``ThreadedGroup``, from the same seeded
  numpy inputs: f32 SUM, AVERAGE and a fused group bitwise at 2 ranks and
  within 1e-6 relative at 3 (the sums' order may differ); MIN, MAX,
  PRODUCT, integer AVERAGE (not truncated), ragged allgather, uneven
  alltoall, broadcast from each root, permuted asynchronous submission and
  an uneven join (the joined rank's zeros; AVERAGE divides by the world)
  equal. The steady-state tensor hits the response cache.
* Stall and timeline: both stall inspectors warn with the same text; the
  port's engine names the stalled tensor and the missing rank. Both
  engines' timelines hold the same events per tensor (the op's
  implementation, NCCL/gloo against ring/star, named by its collective).
* The control plane's gloo transport (gather, broadcast, bitwise word
  all-reduces, barrier) on 3 ranks.
* A world of one: ``join`` returns 0, the cache serves a steady tensor,
  the knobs of unported modules raise naming their ROADMAP item, and the
  metrics knobs start the exporters.
"""
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu.common.message as jax_msg
from horovod_tpu.backend.threaded import ThreadedGroup
from horovod_tpu.common.types import DataType as JaxDataType
from horovod_tpu.common.types import ReduceOp as JaxReduceOp
from horovod_tpu.engine import controller as jax_controller
from horovod_tpu.engine import stall as jax_stall
from horovod_tpu.engine import tensor_queue as jax_tq
from horovod_tpu.engine.engine import Engine as JaxEngine
from horovod_tpu.utils.logging import get_logger as jax_logger

import horovod_tpu_torch.common.message as port_msg
from horovod_tpu_torch.engine import controller as port_controller
from horovod_tpu_torch.engine import stall as port_stall
from horovod_tpu_torch.engine import tensor_queue as port_tq
from horovod_tpu_torch.utils.logging import get_logger as port_logger

import _torch_port_workers as workers

TOL = 1e-6
ENV = {"HOROVOD_CYCLE_TIME": "1", "HOROVOD_STALL_CHECK_TIME_SECONDS": "1"}


# ---------------------------------------------------------------------------
# Messages
def _request(mod, **kw):
    return mod.Request(**kw)


REQUESTS = [
    dict(request_rank=1, request_type=2, tensor_type=7, tensor_name="broadcast.w",
         root_rank=1, device=-1, tensor_shape=(3, 4), prescale_factor=0.5,
         postscale_factor=0.25, reduce_op=1),
    dict(request_rank=0, request_type=0, tensor_type=10, tensor_name="grad.ünïcode",
         tensor_shape=(), reduce_op=4),
]


def _responses(mod):
    return [mod.Response(mod.ResponseType.ALLREDUCE, ["a", "b"], "", [-1, -1], [2, 3],
                         7, 0.5, 0.25, -1, [(2,), (3, 1)], 1, 1, 8, 1),
            mod.Response(mod.ResponseType.ERROR, ["x"], "[x] Mismatched data types."),
            mod.Response(mod.ResponseType.JOIN, last_joined_rank=3)]


def test_message_bytes_equal_both_ways():
    for kw in REQUESTS:
        jb = _request(jax_msg, **{**kw, "request_type": jax_msg.RequestType(kw["request_type"]),
                                  "tensor_type": JaxDataType(kw["tensor_type"])}).serialize()
        pb = _request(port_msg, **{**kw, "request_type": port_msg.RequestType(kw["request_type"]),
                                   "tensor_type": port_controller.DataType(kw["tensor_type"])}
                      ).serialize()
        assert jb == pb
        assert port_msg.Request.deserialize(jb)[0].serialize() == jb
        assert jax_msg.Request.deserialize(pb)[0].serialize() == pb
    jrl = jax_msg.RequestList([jax_msg.Request.deserialize(
        _request(port_msg, **{**REQUESTS[0], "request_type": port_msg.RequestType(2),
                              "tensor_type": port_controller.DataType(7)}).serialize())[0]],
        shutdown=True)
    prl = port_msg.RequestList.deserialize(jrl.serialize())
    assert prl.shutdown and prl.serialize() == jrl.serialize()
    jresp, presp = _responses(jax_msg), _responses(port_msg)
    for j, p in zip(jresp, presp):
        assert j.serialize() == p.serialize()
    jl, pl = jax_msg.ResponseList(jresp, True), port_msg.ResponseList(presp, True)
    assert jl.serialize() == pl.serialize()
    assert port_msg.ResponseList.deserialize(jl.serialize()).serialize() == jl.serialize()
    assert jax_msg.ResponseList.deserialize(pl.serialize()).serialize() == pl.serialize()


# ---------------------------------------------------------------------------
# Controllers
class _Shared:
    def __init__(self, size):
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size
        self.box = [None]


class _Transport:
    """An in-memory control plane: one thread per rank, a barrier per
    step, the same protocol for both packages' controllers."""

    def __init__(self, shared: _Shared, rank: int, size: int):
        self.shared, self.rank, self.size = shared, rank, size

    def gather_bytes(self, payload):
        self.shared.slots[self.rank] = payload
        self.shared.barrier.wait()
        out = list(self.shared.slots) if self.rank == 0 else None
        self.shared.barrier.wait()
        return out

    def bcast_bytes(self, payload):
        if self.rank == 0:
            self.shared.box[0] = payload
        self.shared.barrier.wait()
        out = self.shared.box[0]
        self.shared.barrier.wait()
        return out


# A request in a case: (rank, type, dtype, name, shape, root, reduce op).
def _req(mod, dtypes, rank, rtype, dtype, name, shape, root=0, rop=1):
    return mod.Request(request_rank=rank, request_type=mod.RequestType[rtype],
                       tensor_type=dtypes[dtype], tensor_name=name, root_rank=root,
                       device=-1, tensor_shape=tuple(shape), reduce_op=rop)


def _ar(name, shape=(2,), dtype="FLOAT32", rop=1):
    return ("ALLREDUCE", dtype, name, shape, 0, rop)


def _join():
    return ("JOIN", "UINT8", "join.noname.0", (), 0, 0)


BULK = (20000,)     # 80 kB: past the latency lane's 64 kB
CASES = {
    "fusion_under": (2, {}, [{r: [_ar(f"f{i}") for i in range(8)] for r in range(2)}]),
    "fusion_over": (2, {"HOROVOD_FUSION_THRESHOLD": "16"},
                    [{r: [_ar(f"f{i}") for i in range(8)] for r in range(2)}]),
    "steady_cache": (2, {}, [{r: [_ar("steady")] for r in range(2)}] * 5),
    "shape_mismatch": (2, {}, [{0: [_ar("bad", (2,))], 1: [_ar("bad", (3,))]}]),
    "dtype_mismatch": (2, {}, [{0: [_ar("baddt")], 1: [_ar("baddt", dtype="FLOAT64")]}]),
    "op_mismatch": (2, {}, [{0: [_ar("op", rop=1)], 1: [_ar("op", rop=4)]}]),
    "join_uneven": (2, {}, [{0: [_ar("j0")], 1: [_ar("j0")]}, {0: [_ar("j1")], 1: [_join()]},
                            {0: [_ar("j2")]}, {0: [_join()]}]),
    "join_cached": (2, {}, [{r: [_ar("sj")] for r in range(2)}] * 2
                    + [{0: [_ar("sj")], 1: [_join()]}, {0: [_ar("sj")]}, {0: [_join()]}]),
    "allgather_after_join": (2, {}, [{1: [_join()]},
                                     {0: [("ALLGATHER", "FLOAT32", "agj", (2, 2), 0, 0)]},
                                     {0: [_join()]}]),
    "cache_invalidation": (2, {}, [{r: [_ar("t", (4,))] for r in range(2)}] * 2
                           + [{r: [_ar("t", (8,))] for r in range(2)}]),
    "divergent_cache_hits": (2, {}, [{r: [_ar("t", (4,))] for r in range(2)}] * 2
                             + [{0: [_ar("t", (4,))], 1: [_ar("t", (8,))]}, {}]),
    "three_ranks_mixed": (3, {}, [
        {0: [("ALLGATHER", "FLOAT32", "ag", (1, 2), 0, 0), _ar("big0", BULK)],
         1: [("ALLGATHER", "FLOAT32", "ag", (2, 2), 0, 0), _ar("big0", BULK),
             ("BROADCAST", "UINT8", "b", (3,), 2, 0)]},
        {0: [("BROADCAST", "UINT8", "b", (3,), 2, 0), _ar("big1", BULK)],
         1: [_ar("big1", BULK)],
         2: [("ALLGATHER", "FLOAT32", "ag", (3, 2), 0, 0), _ar("big0", BULK),
             ("BROADCAST", "UINT8", "b", (3,), 2, 0), _ar("big1", BULK)]},
        {r: [("ALLTOALL", "FLOAT32", "a2a", (6, 2), 0, 0), _ar("small")] for r in range(3)},
        {r: [("BARRIER", "UINT8", "barrier.noname.0", (0,), 0, 0)] for r in range(3)},
        {r: [_ar("big0", BULK), _ar("big1", BULK)] for r in range(3)},
    ]),
}


def _drive(make_ctrl, mod, dtypes, size, cycles):
    """Each rank's responses (serialised) and cache bits after each cycle."""
    shared = _Shared(size)
    ctrls = [make_ctrl(_Transport(shared, r, size), size, r) for r in range(size)]
    record = [[] for _ in range(size)]
    errors = []

    def rank_body(r):
        try:
            for cycle in cycles:
                reqs = [_req(mod, dtypes, r, *spec) for spec in cycle.get(r, [])]
                for q in reqs:
                    n = 1
                    for d in q.tensor_shape:
                        n *= d
                    ctrls[r].record_tensor_size(q.tensor_name, n * 4)
                resp, shutdown = ctrls[r].compute_response_list(reqs)
                bits = {n: ent[0] for n, ent in ctrls[r].response_cache._by_name.items()}
                record[r].append(([x.serialize() for x in resp.responses], shutdown, bits))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            shared.barrier.abort()

    threads = [threading.Thread(target=rank_body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return record


@pytest.mark.parametrize("case", list(CASES))
def test_controllers_give_equal_response_lists(case, monkeypatch):
    size, env, cycles = CASES[case]
    monkeypatch.setenv("HOROVOD_METRICS_SYNC_SECONDS", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax_rec = _drive(lambda t, n, r: jax_controller.Controller(t, n, r), jax_msg,
                     {d.name: d for d in JaxDataType}, size, cycles)
    port_rec = _drive(lambda t, n, r: port_controller.Controller(t, n, r), port_msg,
                      {d.name: d for d in port_controller.DataType}, size, cycles)
    assert port_rec == jax_rec
    emitted = [jax_msg.Response.deserialize(b)[0] for cyc in jax_rec[0] for b in cyc[0]]
    kinds = {r.response_type.name for r in emitted}
    if case.endswith("mismatch") or case in ("allgather_after_join", "divergent_cache_hits"):
        assert "ERROR" in kinds, kinds
    if case == "fusion_under":
        assert [len(r.tensor_names) for r in emitted] == [8]
    if case == "fusion_over":
        assert [len(r.tensor_names) for r in emitted] == [2] * 4
    if case == "three_ranks_mixed":
        assert {r.channel for r in emitted} == {0, 1}


def test_duplicate_name_is_refused_with_the_same_text():
    jq, pq = jax_tq.TensorQueue(), port_tq.TensorQueue()
    req = jax_msg.Request(tensor_name="allreduce.dup")
    preq = port_msg.Request(tensor_name="allreduce.dup")
    texts = []
    for q, mod, r in ((jq, jax_tq, req), (pq, port_tq, preq)):
        assert q.add_to_tensor_queue(mod.TensorTableEntry("allreduce.dup", None), r).ok()
        status = q.add_to_tensor_queue(mod.TensorTableEntry("allreduce.dup", None), r)
        assert not status.ok()
        texts.append(status.reason)
    assert texts[0] == texts[1] == port_tq.DUPLICATE_NAME_ERROR


# ---------------------------------------------------------------------------
# Stall inspectors
class _Keep(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.got = []

    def emit(self, record):
        self.got.append(record.getMessage())


def test_stall_inspectors_warn_with_the_same_text(monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "0")
    texts = []
    for mod, logger in ((jax_stall, jax_logger()), (port_stall, port_logger())):
        keep = _Keep()
        logger.addHandler(keep)
        try:
            insp = mod.StallInspector(3)
            insp.record("allreduce.grad.w", 0)
            insp.record("allreduce.grad.w", 2)
            insp.pending["allreduce.grad.w"] = (time.monotonic() - 7.2,
                                                insp.pending["allreduce.grad.w"][1])
            assert insp.check() is None
        finally:
            logger.removeHandler(keep)
        texts.append(keep.got)
    assert texts[0] == texts[1]
    assert len(texts[1]) == 1
    assert "allreduce.grad.w" in texts[1][0] and "[missing ranks: [1]]" in texts[1][0]


# ---------------------------------------------------------------------------
# Engines
def _jax_rank(eng, r: int, size: int) -> dict:
    """``_run_engine_world``'s collectives on one JAX engine."""
    inp = workers.engine_inputs(r, size)

    def sync(h):
        return eng.synchronize(h, timeout=60)

    out = {"sum": sync(eng.enqueue_allreduce(inp["f32"], name="f32", op=JaxReduceOp.SUM)),
           "avg": sync(eng.enqueue_allreduce(inp["f32"], name="f32avg",
                                             op=JaxReduceOp.AVERAGE))}
    for op in ("MIN", "MAX", "PRODUCT"):
        out[op] = sync(eng.enqueue_allreduce(inp["f32"], name=op, op=JaxReduceOp[op]))
    hs = [eng.enqueue_allreduce(m, name=f"many.{i}", op=JaxReduceOp.SUM)
          for i, m in enumerate(inp["many"])]
    out["many"] = [sync(h) for h in hs]
    out["iavg"] = sync(eng.enqueue_allreduce(inp["int"], name="iavg", op=JaxReduceOp.AVERAGE))
    out["ag"] = sync(eng.enqueue_allgather(inp["ag"], name="ag"))
    out["a2a"], out["a2a_splits"] = sync(eng.enqueue_alltoall(inp["a2a"], [r + 1] * size,
                                                              name="a2a"))
    for root in range(size):
        out[f"bcast_{root}"] = sync(eng.enqueue_broadcast(inp["bcast"], root, name=f"b{root}"))
    order = [(i + r) % 4 for i in range(4)]
    hs = {i: eng.enqueue_allreduce(inp["perm"][i], name=f"perm{i}", op=JaxReduceOp.SUM)
          for i in order}
    out["perm"] = [sync(hs[i]) for i in range(4)]
    out["join"] = [sync(eng.enqueue_allreduce(inp["join"], name=f"j{i}",
                                              op=JaxReduceOp.AVERAGE))
                   for i in range(workers.ENGINE_ROUNDS if r != size - 1 else 1)]
    out["last_joined"] = int(sync(eng.enqueue_join()))
    for name in ("tl0", "tl1"):
        sync(eng.enqueue_allreduce(np.ones(4, np.float32) * r, name=name,
                                   op=JaxReduceOp.AVERAGE))
    sync(eng.enqueue_allgather(inp["ag"], name="tlg"))
    sync(eng.enqueue_broadcast(inp["bcast"], 0, name="tlb"))
    sync(eng.enqueue_barrier())
    return out


def _jax_engines(size: int, timeline: str) -> tuple:
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("HOROVOD_TIMELINE", timeline)
        group = ThreadedGroup(size)
        engines = [JaxEngine(rank=r, size=size, backend=group.backend(r))
                   for r in range(size)]
    for e in engines:
        e.cycle_time_s = 0.001
        e.start()
    results, errors = [None] * size, [None] * size

    def body(r):
        try:
            results[r] = _jax_rank(engines[r], r, size)
        except BaseException as ex:  # noqa: BLE001 - re-raised below
            errors[r] = ex

    threads = [threading.Thread(target=body, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    tids = dict(engines[0].timeline._tids)
    stops = [threading.Thread(target=e.shutdown) for e in engines]
    for t in stops:
        t.start()
    for t in stops:
        t.join(timeout=60)
    for err in errors:
        if err is not None:
            raise err
    with open(timeline) as f:
        return results, json.load(f), tids


@pytest.fixture(scope="module", params=[2, 3], ids=lambda n: f"{n}ranks")
def worlds(request, tmp_path_factory):
    size = request.param
    tmp = tmp_path_factory.mktemp(f"engine{size}")
    port = workers.spawn_world(size, tmp, "_run_engine_world", str(tmp / "port.json"),
                               env={**ENV, "HOROVOD_TIMELINE": str(tmp / "port.json")})
    jax_res, jax_tl, jax_tids = _jax_engines(size, str(tmp / "jax.json"))
    return size, port, jax_res, jax_tl, jax_tids


def _close(size, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if size == 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("key", ["sum", "avg"])
def test_f32_sum_and_average_match_the_jax_engine(worlds, key):
    size, port, jax_res, _, _ = worlds
    for r in range(size):
        _close(size, port[r][key], jax_res[r][key])


def test_fused_group_matches_the_jax_engine(worlds):
    size, port, jax_res, _, _ = worlds
    for r in range(size):
        for got, want in zip(port[r]["many"], jax_res[r]["many"]):
            _close(size, got, want)
    assert port[0]["counters"]["fused_responses"] >= 1


@pytest.mark.parametrize("key", ["MIN", "MAX", "PRODUCT", "iavg", "ag", "a2a"])
def test_collective_matches_the_jax_engine(worlds, key):
    size, port, jax_res, _, _ = worlds
    for r in range(size):
        if key == "PRODUCT":
            np.testing.assert_allclose(port[r][key], jax_res[r][key], rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(port[r][key], jax_res[r][key])
        assert port[r][key].dtype == np.asarray(jax_res[r][key]).dtype
    if key == "iavg":    # AVERAGE of int64 [2, 4, 6]·(r + 1): not truncated to 0
        want = np.array([2, 4, 6]) * sum(range(1, size + 1)) // size
        np.testing.assert_array_equal(port[0][key], want)
    if key == "a2a":
        for r in range(size):
            assert list(port[r]["a2a_splits"]) == list(jax_res[r]["a2a_splits"])


def test_broadcast_from_each_root_matches_the_jax_engine(worlds):
    size, port, jax_res, _, _ = worlds
    for root in range(size):
        for r in range(size):
            np.testing.assert_array_equal(port[r][f"bcast_{root}"], jax_res[r][f"bcast_{root}"])
            np.testing.assert_array_equal(port[r][f"bcast_{root}"],
                                          np.full(3, root * 10, np.float32))


def test_permuted_submission_is_negotiated_by_name(worlds):
    size, port, jax_res, _, _ = worlds
    total = [sum(workers.engine_inputs(r, size)["perm"][i] for r in range(size))
             for i in range(4)]
    for r in range(size):
        for i in range(4):
            _close(size, port[r]["perm"][i], jax_res[r]["perm"][i])
            np.testing.assert_allclose(port[r]["perm"][i], total[i], rtol=TOL, atol=TOL)


def test_uneven_join_matches_the_jax_engine(worlds):
    size, port, jax_res, _, _ = worlds
    for r in range(size):
        assert port[r]["last_joined"] == jax_res[r]["last_joined"]
        assert len(port[r]["join"]) == len(jax_res[r]["join"])
        for got, want in zip(port[r]["join"], jax_res[r]["join"]):
            _close(size, got, want)
    # Step 2 on: the joined last rank adds zeros; AVERAGE divides by size.
    want = np.full(2, sum(range(1, size)) / size, np.float32)
    np.testing.assert_allclose(port[0]["join"][1], want, rtol=TOL)


def test_steady_state_tensor_hits_the_cache(worlds):
    """The fast path serves a tensor only in a cycle where every rank has it
    queued (the AND of the hit bits); a pass whose ranks enqueue a cycle
    apart is negotiated in full, so not every pass hits."""
    size, port, _, _, _ = worlds
    for r in range(size):
        for got in port[r]["steady"]:
            np.testing.assert_array_equal(got, np.full(3, size * (size + 1) / 2, np.float32))
        print(f"rank {r} counters: {port[r]['counters']}")
        assert port[r]["counters"]["cache_hits"] >= 1, port[r]["counters"]


def test_stall_warning_names_the_tensor_and_the_missing_rank(worlds):
    size, port, _, _, _ = worlds
    msgs = port[0]["stall"]
    assert any("Stalled op: allreduce.late" in m and "[missing ranks: [1]]" in m
               for m in msgs), msgs
    for r in range(1, size):
        assert port[r]["stall"] == []      # only the coordinator inspects


def _lane_events(doc, tids, name):
    """The (phase, name) events of ``name``'s lane, the instant rank ticks
    as a sorted set, the op's implementation named by its collective."""
    tid = tids[name]
    seq, ticks = [], set()
    for ev in doc:
        if ev.get("tid") != tid or ev.get("ph") == "M":
            continue
        if ev["ph"] == "i":
            ticks.add(ev["name"])
            continue
        label = ev.get("name")
        if label and not label.startswith("NEGOTIATE_") and "_" in label \
                and label.split("_", 1)[0] in ("STAR", "RING", "SHM", "HIERARCHICAL",
                                               "GLOO", "NCCL", "LOCAL"):
            label = "IMPL_" + label.split("_")[-1]
        seq.append((ev["ph"], label))
    return seq, sorted(ticks)


def test_timelines_hold_the_same_events_per_tensor(worlds):
    size, port, _, jax_tl, jax_tids = worlds
    port_tl, port_tids = port[0]["timeline"], port[0]["tids"]
    for name in workers.TIMELINE_TENSORS:
        got, want = _lane_events(port_tl, port_tids, name), _lane_events(jax_tl, jax_tids, name)
        assert got == want, (name, got, want)
        op = name.split(".")[0].upper()
        assert ("B", f"NEGOTIATE_{op}") in got[0] and ("B", op) in got[0]
        assert got[1] == [str(r) for r in range(size)]


def test_gloo_transport_moves_bytes_and_words(tmp_path):
    size = 3
    res = workers.spawn_world(size, tmp_path, "_run_transport_world")
    assert res[0]["gathered"] == [bytes([r]) * (r + 1) for r in range(size)]
    assert all(r["gathered"] is None for r in res[1:])
    high = 1 << 63
    for r in res:
        assert r["bcast"] == b"coordinator" and r["empty"] == b""
        assert r["and"] == [high, 0xFFFF_FFFF_FFFF_FFFF ^ 0b111]
        assert r["or"] == [high | 0b111, 0xFFFF_FFFF_FFFF_FFFF]


# ---------------------------------------------------------------------------
# A world of one
@pytest.fixture
def one(monkeypatch, tmp_path):
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_TIMELINE", str(tmp_path / "tl.json"))
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_world_of_one_joins_caches_and_writes_the_timeline(one, tmp_path):
    hvd = one
    assert hvd.join() == 0
    for _ in range(3):
        out = hvd.allreduce(torch.ones(2), name="steady", op=hvd.Sum)
    np.testing.assert_array_equal(out.numpy(), [1.0, 1.0])
    counters = hvd.common.basics.engine().counters()
    assert counters["cache_hits"] >= 2, counters
    hvd.shutdown()
    with open(tmp_path / "tl.json") as f:
        names = {ev.get("name") for ev in json.load(f)}
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE", "LOCAL_ALLREDUCE"} <= names


@pytest.mark.parametrize("knob,item", [("HOROVOD_AUTOTUNE", "A6"),
                                       ("HOROVOD_HIERARCHICAL_ALLREDUCE", "A6"),
                                       ("HOROVOD_TRACE_DIR", "A8")])
def test_unported_knobs_raise_naming_their_roadmap_item(monkeypatch, knob, item):
    import horovod_tpu_torch as hvd

    monkeypatch.setenv(knob, "1")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


@pytest.mark.parametrize("knob", ["HOROVOD_METRICS_PORT", "HOROVOD_METRICS_FILE"])
def test_metrics_knobs_start_the_exporters(monkeypatch, tmp_path, knob):
    """The metrics knobs run since the metrics plane was ported: ``init``
    starts the exporter, ``/metrics`` answers (or the file is written), and
    ``shutdown`` stops it."""
    import urllib.request

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics, metrics_export

    path = tmp_path / "metrics.json"
    monkeypatch.setenv(knob, "0" if knob == "HOROVOD_METRICS_PORT" else str(path))
    hvd.init(device="cpu")
    try:
        hvd.allreduce(torch.ones(2), name="knob")
        exps = basics._state.exporters
        assert len(exps) == 1
        if knob == "HOROVOD_METRICS_PORT":
            assert isinstance(exps[0], metrics_export.MetricsHTTPServer)
            with urllib.request.urlopen(f"http://127.0.0.1:{exps[0].port}/metrics",
                                        timeout=10) as r:
                text = r.read().decode()
            samples, types, _ = metrics_export.parse_prometheus(text)
            assert samples["horovod_allreduce_tensors_total"] >= 1
            assert types["horovod_responses_total"] == "counter"
    finally:
        hvd.shutdown()
    assert basics._state.exporters == []
    if knob == "HOROVOD_METRICS_FILE":
        doc = json.loads(path.read_text())
        assert doc["metrics"]["horovod_allreduce_tensors_total"] >= 1
