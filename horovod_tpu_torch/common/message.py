"""Control-plane wire messages: Request / Response and their lists
(counterpart of ``horovod_tpu/common/message.py``; the port's own copy).

Re-design of the reference's FlatBuffers-based protocol
(ref: horovod/common/message.h:50-149, horovod/common/wire/message.fbs:18-40):
a compact length-prefixed binary codec (struct-packed). The layout is the
JAX package's byte for byte, so both engines speak the same wire format.
The trailing telemetry field of ``RequestList`` carries a rank's metrics
push (``common/telemetry.py`` ``encode_push``, the JAX package's JSON);
the trace id of ``Response`` is stamped and carried, and read by no
tracing plane until ROADMAP A8.2.
"""
from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .types import DataType


class RequestType(enum.IntEnum):
    """(ref: horovod/common/message.h:50-52)"""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    REDUCESCATTER = 7


class ResponseType(enum.IntEnum):
    """(ref: horovod/common/message.h:147-149)"""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    REDUCESCATTER = 7
    ERROR = 8


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def _unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off : off + n].decode("utf-8"), off + n


def _pack_i64list(xs) -> bytes:
    return struct.pack("<I", len(xs)) + struct.pack(f"<{len(xs)}q", *xs)


def _unpack_i64list(buf: bytes, off: int):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    xs = list(struct.unpack_from(f"<{n}q", buf, off))
    return xs, off + 8 * n


@dataclass
class Request:
    """A worker's announcement that one tensor is ready for a collective
    (ref: message.h Request; fields mirror wire/message.fbs:18-29)."""

    request_rank: int = 0
    request_type: RequestType = RequestType.ALLREDUCE
    tensor_type: DataType = DataType.FLOAT32
    tensor_name: str = ""
    root_rank: int = 0
    device: int = 0
    tensor_shape: Tuple[int, ...] = ()
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    # ReduceOp for ALLREDUCE (SUM/MIN/MAX/PRODUCT; AVERAGE lowers to
    # SUM+postscale before enqueue). The reference encodes this in the
    # op layer; here it rides the wire so the coordinator can validate
    # cross-rank agreement (ref: message.h Request op semantics).
    reduce_op: int = 0

    def serialize(self) -> bytes:
        head = struct.pack(
            "<iiiiiddi",
            self.request_rank,
            int(self.request_type),
            int(self.tensor_type),
            self.root_rank,
            self.device,
            self.prescale_factor,
            self.postscale_factor,
            self.reduce_op,
        )
        return head + _pack_str(self.tensor_name) + _pack_i64list(self.tensor_shape)

    @staticmethod
    def deserialize(buf: bytes, off: int = 0) -> Tuple["Request", int]:
        rr, rt, tt, root, dev, pre, post, rop = struct.unpack_from(
            "<iiiiiddi", buf, off)
        off += struct.calcsize("<iiiiiddi")
        name, off = _unpack_str(buf, off)
        shape, off = _unpack_i64list(buf, off)
        return (
            Request(rr, RequestType(rt), DataType(tt), name, root, dev,
                    tuple(shape), pre, post, rop),
            off,
        )


@dataclass
class RequestList:
    """(ref: message.h RequestList; shutdown flag at message.h:120-135)

    `telemetry` is an optional opaque blob a rank piggybacks on its
    per-cycle gather: its metrics push for rank 0's fleet view, every
    HOROVOD_METRICS_SYNC_SECONDS (the span, alert and event batches the JAX
    package adds to it wait for ROADMAP A8.2 and A8.4). It is a TRAILING
    optional field: decoders that stop after `requests` stay
    wire-compatible, and this decoder treats a missing tail as None.
    """

    requests: List[Request] = field(default_factory=list)
    shutdown: bool = False
    telemetry: Optional[bytes] = None

    def serialize(self) -> bytes:
        out = struct.pack("<?I", self.shutdown, len(self.requests))
        for r in self.requests:
            out += r.serialize()
        if self.telemetry is not None:
            out += struct.pack("<I", len(self.telemetry)) + self.telemetry
        return out

    @staticmethod
    def deserialize(buf: bytes) -> "RequestList":
        shutdown, n = struct.unpack_from("<?I", buf, 0)
        off = struct.calcsize("<?I")
        reqs = []
        for _ in range(n):
            r, off = Request.deserialize(buf, off)
            reqs.append(r)
        telemetry = None
        if off + 4 <= len(buf):
            (tn,) = struct.unpack_from("<I", buf, off)
            off += 4
            telemetry = buf[off : off + tn]
        return RequestList(reqs, shutdown, telemetry)


@dataclass
class Response:
    """Coordinator's instruction to execute a (possibly fused) collective
    (ref: message.h Response; wire/message.fbs:31-40)."""

    response_type: ResponseType = ResponseType.ALLREDUCE
    tensor_names: List[str] = field(default_factory=list)
    error_message: str = ""
    devices: List[int] = field(default_factory=list)
    # Allgather: aggregated first-dim sizes per rank; Alltoall: recv splits.
    tensor_sizes: List[int] = field(default_factory=list)
    tensor_type: DataType = DataType.FLOAT32
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    last_joined_rank: int = -1
    # Per-tensor shapes (parallel to tensor_names). Lets every rank —
    # including joined ranks that never issued the request — populate the
    # response cache with an identical key, keeping cache-bit assignment
    # rank-consistent (ref: response_cache.cc put-from-response).
    tensor_shapes: List[Tuple[int, ...]] = field(default_factory=list)
    reduce_op: int = 0
    # Executor channel the coordinator assigned (round-robin over
    # HOROVOD_NUM_CHANNELS for non-fence responses; fences stay 0).
    # Wire-carried so every rank — workers and joined ranks replaying
    # cached responses alike — executes the same response on the same
    # channel in the same per-channel FIFO order, the ordering invariant
    # that keeps concurrent collectives from deadlocking.
    channel: int = 0
    # Tracing-plane correlation id the coordinator assigned
    # (common/tracing.py). Wire-carried like the channel id so every
    # rank's spans for this collective — negotiation, queue dwell,
    # executor run, backend phases — share one id in the merged trace.
    # Cache-replayed responses use a deterministic per-rank replay
    # sequence instead (odd id space; the cache fast path exchanges no
    # per-response bytes).
    trace_id: int = 0
    # Wire codec id (common/compression.py CODEC_*) the coordinator
    # assigned for this response's data-plane frames — 0 = full-width.
    # Wire-carried next to the channel id for the same reason: codec
    # choice MUST be collectively agreed (a half-width frame meeting a
    # full-width reader is a desync) and cache-replay-stable (the
    # cached Response carries it, so every replay re-applies the codec
    # it was negotiated with, on every rank, joined ranks included).
    codec: int = 0

    def serialize(self) -> bytes:
        out = struct.pack(
            "<iiddiiiqi",
            int(self.response_type),
            int(self.tensor_type),
            self.prescale_factor,
            self.postscale_factor,
            self.last_joined_rank,
            self.reduce_op,
            self.channel,
            self.trace_id,
            self.codec,
        )
        out += struct.pack("<I", len(self.tensor_names))
        for n in self.tensor_names:
            out += _pack_str(n)
        out += _pack_str(self.error_message)
        out += _pack_i64list(self.devices)
        out += _pack_i64list(self.tensor_sizes)
        out += struct.pack("<I", len(self.tensor_shapes))
        for shp in self.tensor_shapes:
            out += _pack_i64list(shp)
        return out

    @staticmethod
    def deserialize(buf: bytes, off: int = 0) -> Tuple["Response", int]:
        rt, tt, pre, post, ljr, rop, chan, trace_id, codec = \
            struct.unpack_from("<iiddiiiqi", buf, off)
        off += struct.calcsize("<iiddiiiqi")
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        names = []
        for _ in range(n):
            s, off = _unpack_str(buf, off)
            names.append(s)
        err, off = _unpack_str(buf, off)
        devices, off = _unpack_i64list(buf, off)
        sizes, off = _unpack_i64list(buf, off)
        (nshapes,) = struct.unpack_from("<I", buf, off)
        off += 4
        shapes = []
        for _ in range(nshapes):
            shp, off = _unpack_i64list(buf, off)
            shapes.append(tuple(int(d) for d in shp))
        return (
            Response(ResponseType(rt), names, err, [int(d) for d in devices],
                     sizes, DataType(tt), pre, post, ljr, shapes, rop, chan,
                     trace_id, codec),
            off,
        )


@dataclass
class ResponseList:
    """(ref: message.h ResponseList)"""

    responses: List[Response] = field(default_factory=list)
    shutdown: bool = False

    def serialize(self) -> bytes:
        out = struct.pack("<?I", self.shutdown, len(self.responses))
        for r in self.responses:
            out += r.serialize()
        return out

    @staticmethod
    def deserialize(buf: bytes) -> "ResponseList":
        shutdown, n = struct.unpack_from("<?I", buf, 0)
        off = struct.calcsize("<?I")
        resps = []
        for _ in range(n):
            r, off = Response.deserialize(buf, off)
            resps.append(r)
        return ResponseList(resps, shutdown)
