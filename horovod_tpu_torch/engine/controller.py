"""Coordinator protocol: rank-0 master/worker negotiation of ready tensors
(counterpart of ``horovod_tpu/engine/controller.py``; ref:
horovod/common/controller.{h,cc}, protocol at controller.h:66-100):

  * every cycle, workers send a RequestList of newly ready tensors to the
    coordinator (rank 0); the coordinator counts requests per tensor name
    (``IncrementTensorCount``, ref: controller.cc:837-860): a tensor is
    ready when all ``size - joined_size`` ranks have requested it;
  * the coordinator checks cross-rank consistency (dtype/shape/op/root,
    ref: ConstructResponse, controller.cc:380-657) and answers with a
    (fused) ResponseList, or an ERROR response carrying the mismatch text;
  * responses are fused up to the fusion threshold
    (ref: FuseResponses, controller.cc:686-809);
  * a bit-vector response cache short-circuits negotiation for
    steady-state tensors (ref: ComputeResponseList fast path,
    controller.cc:63-358), in one fused gather + broadcast round.

The transport is abstract (``ControllerTransport``); the port's is a gloo
group on the CPU (``engine/transport.py``). The request lists, the error
texts, fusion, the cache bits and the channel ids are the JAX package's.
Three error texts say more than the JAX package's, each after its JAX
sentence: the prescale/postscale mismatch and the allgather trailing-dims
mismatch name both ranks' values, and a broadcast whose shapes differ is
refused (NCCL and gloo broadcast into a buffer of the root's shape on
every rank; the JAX star backend sends the root's shape instead). The
wire codec follows the port's ``ops/wire.py`` policy.

Every HOROVOD_METRICS_SYNC_SECONDS each rank piggybacks its scalar
telemetry snapshot (``telemetry.encode_push``) on the request list it
gathers to rank 0, which folds the blobs into its ``FleetView``; a rank
overdue for a push raises HAS_UNCACHED, so a cache-only steady state
still runs one negotiation round an interval (the JAX package's push).
The coordinator forces such a round too when a stall check is due on
pending tensors. Rank 0 also keeps the JAX package's straggler gauges
(the last rank in, and each rank's wait past the first arrival). The
tracing, alert and event piggybacks wait for ROADMAP A8.2 and A8.4, and
the liveness plane's abort verdicts (the JAX package's ``_FLAG_ABORT``)
for A8.3.
"""
from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..common import env as env_cfg
from ..common import telemetry
from ..common.message import (
    Request,
    RequestList,
    RequestType,
    Response,
    ResponseList,
    ResponseType,
)
from ..common.types import DataType, ReduceOp, dtype_size
from .response_cache import CacheState, ResponseCache
from .stall import StallInspector

# Flag bits carried in the cache-coordination exchange
# (ref: response_cache.h CacheCoordinator flags).
_FLAG_HAS_UNCACHED = 1 << 0
_FLAG_SHUTDOWN = 1 << 1
# This rank has joined: the coordinator substitutes an all-ones hit
# vector for it in the AND pass (a joined rank takes part in every cached
# collective with zeros, so it must not veto the intersection).
_FLAG_JOINED = 1 << 2

_ALL_ONES = 0xFFFFFFFFFFFFFFFF

# Wire codec ids, the JAX package's (common/compression.py CODEC_*; 0 is
# full width).
CODEC_BF16 = 1
CODEC_FP16 = 2
CODEC_INT8 = 3


# Response types eligible for a pipelined executor channel. Everything
# else (JOIN / BARRIER / ERROR) is a fence: the engine drains all
# channels before running it, so it keeps channel 0.
_CHANNELED_TYPES = frozenset((
    ResponseType.ALLREDUCE,
    ResponseType.ADASUM,
    ResponseType.ALLGATHER,
    ResponseType.BROADCAST,
    ResponseType.ALLTOALL,
))


class ControllerTransport:
    """Abstract control-plane transport (ref: controller.h:45-59,133-146)."""

    rank: int
    size: int

    def gather_bytes(self, payload: bytes) -> Optional[List[bytes]]:
        """Workers -> coordinator. All payloads on rank 0, None elsewhere."""
        raise NotImplementedError

    def bcast_bytes(self, payload: Optional[bytes]) -> bytes:
        """Coordinator -> workers."""
        raise NotImplementedError

    def allreduce_words(self, words: List[int], op: str) -> List[int]:
        """Element-wise bitwise 'and'/'or' of 64-bit words across ranks
        (ref: CrossRankBitwiseAnd/Or, controller.h:141-143)."""
        raise NotImplementedError

    def barrier(self):
        raise NotImplementedError


@dataclass
class _TensorRecord:
    requests: List[Request] = field(default_factory=list)
    ranks: Set[int] = field(default_factory=set)


def _dims(shape) -> str:
    return str([int(d) for d in shape])


class Controller:
    def __init__(self, transport: ControllerTransport, size: int, rank: int,
                 timeline=None, num_channels: Optional[int] = None, registry=None):
        # Coordinator-side timeline hook: negotiation phases are only
        # observable here (ref: operations.cc:416-429).
        self.timeline = timeline
        self.transport = transport
        self.size = size
        self.rank = rank
        self.is_coordinator = rank == 0
        self.registry = registry if registry is not None else telemetry.default_registry()
        self.response_cache = ResponseCache(env_cfg.cache_capacity(), registry=self.registry)
        self.cache_enabled = env_cfg.cache_enabled()
        self.fusion_threshold = env_cfg.fusion_threshold_bytes()
        self.stall_inspector = StallInspector(size, registry=self.registry)
        # Cross-rank telemetry (module docstring); 0 disables it. A last
        # push at 0 makes the first gather carry a snapshot, so the fleet
        # view exists as soon as the first negotiation completes.
        self.fleet = telemetry.FleetView(size) if self.is_coordinator else None
        self._metrics_sync_s = env_cfg.metrics_sync_seconds()
        self._last_metrics_push = 0.0
        # Per-tensor request arrivals (coordinator, monotonic ns) for the
        # straggler gauges.
        self._arrivals: Dict[str, Dict[int, int]] = {}
        if self.is_coordinator:
            self._m_straggler = self.registry.gauge(
                "horovod_straggler_rank",
                "Rank whose request arrived last for the most recently "
                "negotiated collective (-1 before the first)")
            self._m_straggler.set(-1)
            self._m_neg_wait: Dict[int, telemetry.Gauge] = {}
        # Channels: fixed when the engine starts (each holds a process
        # group); the coordinator assigns ids below this count.
        self.num_channels = (env_cfg.num_channels() if num_channels is None
                             else num_channels)
        self.message_table: Dict[str, _TensorRecord] = {}
        # Join state (ref: global_state.h:103-107, controller.cc:220-308)
        self.joined_ranks: Set[int] = set()
        self.joined = False  # this rank called join
        # This cycle's cache hits, parked by cache bit so non-intersecting
        # hits can be re-queued into full negotiation.
        self._pending_cached: Dict[int, Request] = {}
        # Tensor metadata for fusion byte accounting
        self._sizes_by_name: Dict[str, int] = {}
        # Round-robin executor-channel cursor (coordinator only); the id
        # rides the Response, so every rank follows rank 0.
        self._next_channel = 0
        # Cache-replayed responses get a deterministic per-rank replay id
        # (odd space), negotiated ones a coordinator id (even space).
        self._trace_seq = 0
        self._replay_seq = 0
        # Negotiation rounds run (the engine's counters read it).
        self.negotiations = 0

    # ------------------------------------------------------------------
    def compute_response_list(
        self, messages: List[Request], shutdown: bool = False
    ) -> Tuple[ResponseList, bool]:
        """One negotiation cycle; returns (responses, should_shutdown).
        Mirrors Controller::ComputeResponseList (controller.cc:63-358):
        cache fast path first, then full negotiation for uncached tensors."""
        # --- split messages into cache hits and misses -----------------
        uncached: List[Request] = []
        local_invalid_bits: Set[int] = set()
        for req in messages:
            if req.request_type == RequestType.JOIN:
                self.joined = True
                uncached.append(req)
                continue
            state = (
                self.response_cache.cached(req) if self.cache_enabled else CacheState.MISS
            )
            if state == CacheState.HIT:
                self._pending_cached[
                    self.response_cache.peek_bit(req.tensor_name)
                ] = req
            else:
                if state == CacheState.INVALID:
                    # Signature changed (e.g. new shape): announce the old
                    # bit in the OR pass so every rank drops its entry in
                    # the same cycle (ref: CacheCoordinator invalid bits).
                    local_invalid_bits.add(
                        self.response_cache.peek_bit(req.tensor_name)
                    )
                    self.response_cache.erase(req.tensor_name)
                uncached.append(req)

        responses: List[Response] = []

        # --- cache coordination: ONE fused control round ---------------
        # Each rank gathers [flags, pending-hit bits, invalid bits] to
        # rank 0, which computes the AND-intersection, the OR of flags and
        # invalid bits and the requeue-induced HAS_UNCACHED in one shot,
        # then broadcasts the verdict.
        if self.cache_enabled:
            nwords = (max(self.response_cache.num_bits(), 1) + 63) // 64
            flags = 0
            # HAS_UNCACHED: a rank overdue for a telemetry push raises it
            # too, and so does the coordinator when a stall check is due
            # on pending tensors: in a cache-only steady state no
            # negotiation would otherwise run, and the fleet view would go
            # stale exactly when the job is busiest.
            if uncached or self._telemetry_due() or self._stall_check_due():
                flags |= _FLAG_HAS_UNCACHED
            if shutdown:
                flags |= _FLAG_SHUTDOWN
            if self.joined:
                flags |= _FLAG_JOINED
            pending_words = self.response_cache.bits_to_vector(
                set(self._pending_cached), nwords)
            invalid_words = self.response_cache.bits_to_vector(
                local_invalid_bits, nwords)
            flags, common_bits, global_invalid = self._coordinate_cache(
                flags, pending_words, invalid_words)
            shutdown = bool(flags & _FLAG_SHUTDOWN)
            any_uncached = bool(flags & _FLAG_HAS_UNCACHED)

            # Hits outside the (invalid-pruned) intersection go back to
            # full negotiation: peers were not ready, or the entry was
            # invalidated somewhere.
            for bit in sorted(set(self._pending_cached) - common_bits):
                uncached.append(self._pending_cached.pop(bit))

            for bit in global_invalid:
                if self.response_cache.has_bit(bit):
                    self.response_cache.erase_bit(bit)

            # Emit cached responses common to all ranks, in stable bit
            # order. A joined rank emits them too: it must take part in
            # the data plane (with zero contributions) or peers block.
            for bit in sorted(common_bits):
                if bit in self._pending_cached or (
                    self.joined and self.response_cache.has_bit(bit)
                ):
                    resp = self.response_cache.get_response_by_bit(bit)
                    self._replay_seq += 1
                    responses.append(replace(
                        resp, trace_id=(self._replay_seq << 1) | 1))
                    self._pending_cached.pop(bit, None)
                    self.response_cache.count_hit()
        else:
            any_uncached = True

        # --- full negotiation for uncached tensors ---------------------
        if any_uncached or not self.cache_enabled:
            self.negotiations += 1
            req_list = RequestList(uncached, shutdown=shutdown)
            # Attach at half the interval once a gather runs anyway: a rank
            # drawn into another rank's forced round publishes too and
            # resets its timer, so the ranks' deadlines coalesce into about
            # one forced round an interval.
            if self._telemetry_elapsed() >= self._metrics_sync_s / 2 > 0:
                self._last_metrics_push = time.monotonic()
                req_list.telemetry = telemetry.encode_push(self.registry, self.rank)
            gathered = self.transport.gather_bytes(req_list.serialize())
            if self.is_coordinator:
                negotiated: List[Response] = []
                ready_names: List[str] = []
                joined_before = len(self.joined_ranks)
                for peer_rank, payload in enumerate(gathered):
                    rl = RequestList.deserialize(payload)
                    if rl.telemetry is not None:
                        self.fleet.ingest(rl.telemetry, rank_hint=peer_rank)
                    shutdown = shutdown or rl.shutdown
                    for req in rl.requests:
                        if req.request_type == RequestType.JOIN:
                            self.joined_ranks.add(req.request_rank)
                            continue
                        if self._increment_tensor_count(req):
                            ready_names.append(req.tensor_name)
                if len(self.joined_ranks) != joined_before:
                    # A new join lowers the readiness bar; re-check pending
                    # tensors (ref: controller.cc:220-231).
                    need = self.size - len(self.joined_ranks)
                    for n, rec in self.message_table.items():
                        if n not in ready_names and len(rec.ranks) >= need:
                            ready_names.append(n)
                # All ranks joined: a JOIN response resetting the state
                # (ref: controller.cc:263-308), after this cycle's data
                # responses, so the drain it triggers covers them.
                join_resp = None
                if self.joined_ranks and len(self.joined_ranks) == self.size:
                    join_resp = Response(
                        ResponseType.JOIN,
                        last_joined_rank=max(self.joined_ranks))
                    self.joined_ranks.clear()
                new_responses = [self._construct_response(n) for n in ready_names]
                fused = self._fuse_responses(new_responses)
                self._assign_channels(fused)
                self._assign_codecs(fused)
                negotiated.extend(fused)
                if join_resp is not None:
                    negotiated.append(join_resp)
                stall_reason = self.stall_inspector.check()
                if stall_reason:
                    shutdown = True
                    # Tensor-less ERROR response: the engine finalizes
                    # every pending handle with the stall diagnosis.
                    negotiated.append(Response(
                        ResponseType.ERROR, [], error_message=stall_reason
                    ))
                self._assign_trace_ids(negotiated)
                # Broadcast only the negotiated responses; every rank
                # prepends its (identical) cached fast-path list locally.
                self.transport.bcast_bytes(
                    ResponseList(negotiated, shutdown=shutdown).serialize())
                resp_list = ResponseList(responses + negotiated, shutdown)
            else:
                recv = ResponseList.deserialize(self.transport.bcast_bytes(None))
                resp_list = ResponseList(responses + recv.responses, recv.shutdown)
            # Populate the cache from negotiated responses on every rank
            # so cache bit assignment stays rank-consistent.
            if self.cache_enabled:
                for resp in resp_list.responses:
                    self._maybe_cache(resp)
            if any(
                r.response_type == ResponseType.JOIN for r in resp_list.responses
            ):
                self.joined = False
            return resp_list, resp_list.shutdown

        return ResponseList(responses, shutdown=shutdown), shutdown

    # ------------------------------------------------------------------
    @staticmethod
    def _pack_coord(flags: int, a: Sequence[int], b: Sequence[int]) -> bytes:
        return struct.pack(f"<QII{len(a)}Q{len(b)}Q", flags, len(a), len(b), *a, *b)

    @staticmethod
    def _unpack_coord(buf) -> Tuple[int, List[int], List[int]]:
        flags, na, nb = struct.unpack_from("<QII", buf, 0)
        words = struct.unpack_from(f"<{na + nb}Q", buf, struct.calcsize("<QII"))
        return flags, list(words[:na]), list(words[na:])

    def _coordinate_cache(
        self, flags: int, pending_words: List[int],
        invalid_words: List[int],
    ) -> Tuple[int, Set[int], Set[int]]:
        """Fused cache-coordination round: one gather + one broadcast.
        Returns (global flags, common bit set, globally-invalid bit set).
        Vector lengths may differ across ranks while cache sizes converge:
        rank 0 zero-extends (and extends a joined rank's implicit all-ones
        hit vector to the full width)."""
        payload = self._pack_coord(flags, pending_words, invalid_words)
        gathered = self.transport.gather_bytes(payload)
        if self.is_coordinator:
            decoded = [self._unpack_coord(b) for b in gathered]
            nw = max(1, max(len(p) for _, p, _ in decoded),
                     max(len(i) for _, _, i in decoded))
            out_flags = 0
            common = [_ALL_ONES] * nw
            or_pending = [0] * nw
            or_invalid = [0] * nw
            for fl, pend, inv in decoded:
                out_flags |= fl & (_FLAG_HAS_UNCACHED | _FLAG_SHUTDOWN)
                joined = bool(fl & _FLAG_JOINED)
                for w in range(nw):
                    p = pend[w] if w < len(pend) else 0
                    hit = _ALL_ONES if joined else p
                    common[w] &= hit
                    or_pending[w] |= p
                    if w < len(inv):
                        or_invalid[w] |= inv[w]
            # Invalidated bits leave the intersection; any pending bit
            # outside the final intersection means its rank requeues it
            # into full negotiation, so the negotiation gather must run.
            requeue = 0
            for w in range(nw):
                common[w] &= ~or_invalid[w] & _ALL_ONES
                requeue |= or_pending[w] & ~common[w]
            if requeue:
                out_flags |= _FLAG_HAS_UNCACHED
            verdict = self._pack_coord(out_flags, common, or_invalid)
            self.transport.bcast_bytes(verdict)
        else:
            verdict = self.transport.bcast_bytes(None)
        out_flags, common, or_invalid = self._unpack_coord(verdict)
        return (out_flags, ResponseCache.vector_to_bits(common),
                ResponseCache.vector_to_bits(or_invalid))

    # ------------------------------------------------------------------
    def _assign_channels(self, responses: List[Response]):
        """Executor-channel assignment (coordinator side; the id rides the
        Response, so every rank follows it). Under the default "size"
        policy the highest channel is a latency lane: small responses
        (<= HOROVOD_LATENCY_CHANNEL_BYTES) go there and bulk responses
        round-robin over the rest; "rr" round-robins everything."""
        nchan = self.num_channels
        if nchan <= 1:
            return
        size_policy = env_cfg.channel_policy() == "size"
        small = env_cfg.latency_channel_bytes()
        bulk = nchan - 1 if size_policy else nchan
        for resp in responses:
            if resp.response_type not in _CHANNELED_TYPES:
                continue
            if size_policy and sum(
                self._byte_size(resp, n) for n in resp.tensor_names
            ) <= small:
                resp.channel = nchan - 1
                continue
            if self._next_channel >= bulk:
                self._next_channel = 0
            resp.channel = self._next_channel
            self._next_channel = (self._next_channel + 1) % bulk

    def _assign_codecs(self, responses: List[Response]):
        """Wire-codec assignment (coordinator side; the codec id rides the
        Response next to the channel id, so every rank, joined ranks
        replaying cached responses too, casts the same response the same
        way). The policy is the port's ``ops/wire.py``: an f32 SUM
        all-reduce of at least HOROVOD_WIRE_COMPRESSION_MIN_BYTES (the
        whole fused response) travels in bf16 (fp16 under fp16), or in the
        int8 lane with HOROVOD_WIRE_COMPRESSION_INT8; MIN/MAX/PRODUCT and
        other dtypes ship full width."""
        mode = env_cfg.wire_compression_mode()
        if mode == "none":
            return
        codec = (CODEC_INT8 if env_cfg.wire_compression_int8()
                 else CODEC_FP16 if mode == "fp16" else CODEC_BF16)
        min_bytes = env_cfg.wire_compression_min_bytes()
        for resp in responses:
            if (resp.response_type != ResponseType.ALLREDUCE
                    or resp.error_message):
                continue
            if DataType(resp.tensor_type) != DataType.FLOAT32:
                continue
            if resp.reduce_op not in (0, int(ReduceOp.SUM)):
                continue
            nbytes = sum(self._byte_size(resp, n) for n in resp.tensor_names)
            if nbytes >= min_bytes:
                resp.codec = codec

    def _telemetry_elapsed(self) -> float:
        return time.monotonic() - self._last_metrics_push

    def _telemetry_due(self) -> bool:
        return (self._metrics_sync_s > 0
                and self._telemetry_elapsed() >= self._metrics_sync_s)

    def _note_negotiated(self, name: str):
        """Straggler attribution for one ready tensor: each rank's wait past
        the first arrival, and the last rank in."""
        arr = self._arrivals.pop(name, None)
        if not arr or len(arr) < 2:
            return
        first = min(arr.values())
        for r, t in arr.items():
            g = self._m_neg_wait.get(r)
            if g is None:
                g = self._m_neg_wait[r] = self.registry.gauge(
                    "horovod_negotiation_wait_seconds",
                    "How long the most recent collective's negotiation "
                    "waited on this rank past the first request arrival",
                    labels={"rank": str(r)})
            g.set((t - first) / 1e9)
        self._m_straggler.set(max(arr, key=arr.get))

    def _stall_check_due(self) -> bool:
        insp = self.stall_inspector
        return (self.is_coordinator and insp.enabled and bool(insp.pending)
                and time.monotonic() - insp.last_check >= min(insp.warning_time, 10.0))

    def _assign_trace_ids(self, responses: List[Response]):
        """Coordinator: stamp every negotiated response with a fresh id
        (even space), carried on the wire."""
        for resp in responses:
            self._trace_seq += 1
            resp.trace_id = self._trace_seq << 1

    # ------------------------------------------------------------------
    def _increment_tensor_count(self, req: Request) -> bool:
        """(ref: IncrementTensorCount, controller.cc:837-860)"""
        if self.timeline is not None:
            if req.tensor_name not in self.message_table:
                # First rank's request opens the NEGOTIATE_<OP> phase
                # (ref: Timeline::NegotiateStart, timeline.h:87-95).
                self.timeline.negotiate_start(
                    req.tensor_name, req.request_type.name
                )
            self.timeline.negotiate_rank_ready(
                req.tensor_name, req.request_rank
            )
        rec = self.message_table.setdefault(req.tensor_name, _TensorRecord())
        if req.request_rank not in rec.ranks:
            rec.requests.append(req)
            rec.ranks.add(req.request_rank)
            self._arrivals.setdefault(
                req.tensor_name, {})[req.request_rank] = time.monotonic_ns()
        self.stall_inspector.record(req.tensor_name, req.request_rank)
        return len(rec.ranks) == self.size - len(self.joined_ranks)

    # ------------------------------------------------------------------
    def _construct_response(self, name: str) -> Response:
        """Check cross-rank consistency and build the Response
        (ref: ConstructResponse, controller.cc:380-657)."""
        rec = self.message_table.pop(name)
        if self.timeline is not None:
            # Negotiation closes the moment the response is formed
            # (ref: Timeline::NegotiateEnd, timeline.h:96-104).
            self.timeline.negotiate_end(
                name, rec.requests[0].request_type.name
            )
        self.stall_inspector.remove(name)
        self._note_negotiated(name)
        reqs = rec.requests
        first = reqs[0]

        def error(msg: str) -> Response:
            # Always name the failing op (ref: controller.cc error strings
            # are likewise prefixed).
            return Response(ResponseType.ERROR, [name],
                            error_message=f"[{name}] {msg}")

        for r in reqs[1:]:
            if r.request_type != first.request_type:
                return error(
                    f"Mismatched collective operations: One rank requested "
                    f"{first.request_type.name}, another {r.request_type.name}."
                )
            if r.tensor_type != first.tensor_type:
                return error(
                    f"Mismatched data types: One rank had type "
                    f"{DataType(first.tensor_type).name}, another "
                    f"{DataType(r.tensor_type).name}."
                )
            if (
                r.prescale_factor != first.prescale_factor
                or r.postscale_factor != first.postscale_factor
            ):
                return error(
                    "Mismatched prescale/postscale factors. One rank sent "
                    f"prescale {first.prescale_factor!r}, postscale "
                    f"{first.postscale_factor!r}; another prescale "
                    f"{r.prescale_factor!r}, postscale {r.postscale_factor!r}."
                )
            if r.reduce_op != first.reduce_op:
                return error(
                    f"Mismatched reduce ops: One rank requested op "
                    f"{first.reduce_op}, another {r.reduce_op}."
                )

        rt = first.request_type
        # Join compatibility gate first: with joined ranks, not every rank
        # has a request (ref: controller.cc:487-494,568-571: only
        # allreduce/barrier support join).
        if self.joined_ranks and rt not in (
            RequestType.ALLREDUCE,
            RequestType.BARRIER,
        ):
            return error(
                f"{rt.name} is not supported while some ranks have joined."
            )
        if self.joined_ranks and first.reduce_op not in (
            0, int(ReduceOp.SUM)
        ):
            # Joined ranks contribute zeros: the identity only for SUM.
            return error(
                "MIN/MAX/PRODUCT allreduce is not supported while some "
                "ranks have joined."
            )

        tensor_sizes: List[int] = []
        if rt == RequestType.ALLREDUCE or rt == RequestType.ADASUM:
            for r in reqs[1:]:
                if tuple(r.tensor_shape) != tuple(first.tensor_shape):
                    return error(
                        f"Mismatched allreduce tensor shapes: One rank sent "
                        f"{list(first.tensor_shape)}, another {list(r.tensor_shape)}."
                    )
            resp_type = (
                ResponseType.ADASUM if rt == RequestType.ADASUM else ResponseType.ALLREDUCE
            )
        elif rt == RequestType.ALLGATHER:
            # First dim may differ; trailing dims must match.
            by_rank = {r.request_rank: r for r in reqs}
            for r in reqs[1:]:
                if r.tensor_shape[1:] != first.tensor_shape[1:]:
                    return error(
                        "Mismatched allgather tensor shapes: all dimensions "
                        "except the first must match. One rank sent "
                        f"{_dims(first.tensor_shape)}, another {_dims(r.tensor_shape)}."
                    )
                if len(r.tensor_shape) != len(first.tensor_shape):
                    return error("Mismatched allgather tensor ranks.")
            tensor_sizes = [
                int(by_rank[i].tensor_shape[0]) if by_rank[i].tensor_shape else 0
                for i in range(self.size)
            ]
            resp_type = ResponseType.ALLGATHER
        elif rt == RequestType.BROADCAST:
            for r in reqs[1:]:
                if r.root_rank != first.root_rank:
                    return error(
                        f"Mismatched broadcast root ranks: One rank sent root "
                        f"{first.root_rank}, another {r.root_rank}."
                    )
            for r in reqs[1:]:
                if tuple(r.tensor_shape) != tuple(first.tensor_shape):
                    return error(
                        f"Mismatched broadcast tensor shapes: One rank sent "
                        f"{list(first.tensor_shape)}, another {list(r.tensor_shape)}."
                    )
            resp_type = ResponseType.BROADCAST
        elif rt == RequestType.ALLTOALL:
            resp_type = ResponseType.ALLTOALL
        elif rt == RequestType.BARRIER:
            resp_type = ResponseType.BARRIER
        else:
            return error(f"Unsupported request type {rt}")

        return Response(
            response_type=resp_type,
            tensor_names=[name],
            devices=[r.device for r in reqs],
            tensor_sizes=tensor_sizes,
            tensor_type=first.tensor_type,
            prescale_factor=first.prescale_factor,
            postscale_factor=first.postscale_factor,
            tensor_shapes=[tuple(first.tensor_shape)],
            reduce_op=first.reduce_op,
        )

    # ------------------------------------------------------------------
    def _fuse_responses(self, responses: List[Response]) -> List[Response]:
        """Greedy fusion of same-type/dtype allreduce responses up to the
        fusion threshold (ref: FuseResponses, controller.cc:686-809, with
        the dtype look-ahead collapsed into a full scan)."""
        fused: List[Response] = []
        pending = list(responses)
        while pending:
            base = pending.pop(0)
            if base.response_type not in (ResponseType.ALLREDUCE,):
                fused.append(base)
                continue
            base_bytes = sum(self._byte_size(base, n) for n in base.tensor_names)
            i = 0
            while i < len(pending):
                cand = pending[i]
                if (
                    cand.response_type == base.response_type
                    and cand.tensor_type == base.tensor_type
                    and cand.devices == base.devices
                    and cand.prescale_factor == base.prescale_factor
                    and cand.postscale_factor == base.postscale_factor
                    and cand.reduce_op == base.reduce_op
                    and not cand.error_message
                ):
                    cand_bytes = sum(self._byte_size(cand, n) for n in cand.tensor_names)
                    if base_bytes + cand_bytes <= self.fusion_threshold:
                        base.tensor_names.extend(cand.tensor_names)
                        base.tensor_sizes.extend(cand.tensor_sizes)
                        base.tensor_shapes.extend(cand.tensor_shapes)
                        base_bytes += cand_bytes
                        pending.pop(i)
                        continue
                i += 1
            fused.append(base)
        return fused

    def _byte_size(self, resp: Response, name: str) -> int:
        # Byte size recorded at request time; a coordinator that joined
        # never enqueued the tensor, so derive it from the response's own
        # shape and dtype.
        n = self._sizes_by_name.get(name)
        if n is not None:
            return n
        try:
            idx = resp.tensor_names.index(name)
            count = 1
            for d in resp.tensor_shapes[idx]:
                count *= d
            return count * dtype_size(DataType(resp.tensor_type))
        except (ValueError, IndexError):
            return 0

    def record_tensor_size(self, name: str, nbytes: int):
        self._sizes_by_name[name] = nbytes

    # ------------------------------------------------------------------
    def _maybe_cache(self, resp: Response):
        """Populate the cache from a freshly negotiated response, keyed on
        Response fields alone so every rank (joined ranks too) assigns the
        same bits. Single-tensor responses only: fused groups re-negotiate
        (ref: controller.cc:174-203 re-fuses cached hits)."""
        if resp.response_type in (
            ResponseType.ALLREDUCE,
            ResponseType.ADASUM,
        ) and not resp.error_message and len(resp.tensor_names) == 1:
            key_req = Request(
                request_rank=0,
                request_type=RequestType.ADASUM
                if resp.response_type == ResponseType.ADASUM
                else RequestType.ALLREDUCE,
                tensor_type=DataType(resp.tensor_type),
                tensor_name=resp.tensor_names[0],
                root_rank=0,
                tensor_shape=tuple(resp.tensor_shapes[0])
                if resp.tensor_shapes
                else (),
                prescale_factor=resp.prescale_factor,
                postscale_factor=resp.postscale_factor,
                reduce_op=resp.reduce_op,
            )
            self.response_cache.put(key_req, resp)
