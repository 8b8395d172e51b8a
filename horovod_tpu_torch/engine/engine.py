"""The asynchronous collective engine: background thread + cycle loop
(counterpart of ``horovod_tpu/engine/engine.py``; ref: horovod/common/
operations.cc: InitializeHorovodOnce :620-666, RunLoopOnce :566-616,
PerformOperation :253-330, EnqueueTensor* :840-1068, and the torch
binding's HandleManager).

Framework threads enqueue named tensors and wait on handles. The
background thread negotiates ready tensors by name with the coordinator
(``engine/controller.py``) over the control transport, a gloo group of
its own (``engine/transport.py``), and hands each non-fence response to
the executor of the channel the coordinator assigned: one thread, one
process group (NCCL on CUDA, gloo on the CPU) and, on CUDA, one stream a
channel, made at ``hvd.init()`` in the same order on every rank, since a
group must see its collectives in one order everywhere. JOIN, BARRIER and
ERROR are fences that drain every channel first and run on the background
thread. Cycles are event-driven: an enqueue wakes the loop at once, so
HOROVOD_CYCLE_TIME is a longest coalescing delay. A world of one runs the
same loop over a local transport and local ops, with no process group.

On CUDA an enqueue records a ready event on the caller's current stream;
the channel stream waits on it before it reads the tensor, marks the
tensor as used on that stream (``record_stream``, so the caching
allocator does not hand its memory on while the channel still reads it),
packs fused responses into a persistent fusion buffer on the device (one
per channel and dtype, one copy per tensor in and out), reduces, and
records a done event. ``synchronize`` makes the caller's current stream
wait on that event and marks the output as used on it; the host never
waits for the device, and no gradient byte passes through host memory.

The metrics, tracing, goodput, health, alerts and events planes wait for
ROADMAP A8 and the autotuner for A6; the few counters ``counters()``
returns (cycles, negotiations, responses, fused tensors, bytes, cache
hits) are plain integers.
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..common import env as env_cfg
from ..common.exceptions import HorovodInternalError
from ..common.message import Request, RequestType, Response, ResponseType
from ..common.types import ReduceOp, Status, from_wire_dtype, to_wire_dtype
from ..utils.logging import get_logger
from .controller import Controller
from .operation_manager import build_default
from .tensor_queue import TensorQueue, TensorTableEntry
from .timeline import MEMCPY_IN_FUSION_BUFFER, MEMCPY_OUT_FUSION_BUFFER, Timeline

logger = get_logger()


def _scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    """Scale preserving dtype; integer tensors scale in float64 then cast
    back so AVERAGE (postscale 1/size) does not zero them out (ref:
    ScaleBuffer, collective_operations.h:89-125; the JAX ``_scale_np``).
    Floating tensors multiply by the factor rounded to their dtype."""
    if not (t.is_floating_point() or t.is_complex()):
        return (t.to(torch.float64) * factor).to(t.dtype)
    return t * float(torch.tensor(factor, dtype=t.dtype))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


class _Done:
    """A finished collective's result, and the CUDA event after which it
    is ready on the channel's stream (None on the CPU)."""

    __slots__ = ("result", "event")

    def __init__(self, result, event=None):
        self.result, self.event = result, event


def _tensors_of(result) -> List[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        return [result]
    if isinstance(result, tuple):
        return [r for r in result if isinstance(r, torch.Tensor)]
    return []


class HandleManager:
    """(ref: horovod/torch/handle_manager.{h,cc})"""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._results: Dict[int, Tuple[Status, Optional[_Done]]] = {}
        self._events: Dict[int, threading.Event] = {}

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._events[h] = threading.Event()
            return h

    def mark_done(self, handle: int, status: Status, done: Optional[_Done]):
        with self._lock:
            ev = self._events.get(handle)
            self._results[handle] = (status, done)
        if ev is not None:
            ev.set()

    def poll(self, handle: int) -> bool:
        """True once the collective has finished, on the device too."""
        with self._lock:
            if handle not in self._results:
                if handle not in self._events:
                    raise ValueError(f"unknown or already synchronized handle {handle}")
                return False
            _, done = self._results[handle]
        return done is None or done.event is None or done.event.query()

    def wait(self, handle: int, timeout: Optional[float] = None):
        ev = self._events.get(handle)
        if ev is None:
            raise ValueError(f"unknown or already synchronized handle {handle}")
        if not ev.wait(timeout):
            raise TimeoutError(f"handle {handle} did not complete")
        with self._lock:
            if handle not in self._results:
                raise ValueError(f"unknown or already synchronized handle {handle}")
            status, done = self._results.pop(handle)
            self._events.pop(handle, None)
        if not status.ok():
            raise HorovodInternalError(status.reason)
        if done is None:
            return None
        if done.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(done.event)
            for t in _tensors_of(done.result):
                if t.is_cuda:
                    t.record_stream(stream)
        return done.result


# Fence response types: executed inline on the background thread after
# every channel drains.
_FENCE_TYPES = frozenset((
    ResponseType.JOIN,
    ResponseType.BARRIER,
    ResponseType.ERROR,
))

_EXEC_STOP = object()


class Channel:
    """One executor channel's data plane: its process group over the whole
    world, this rank's index in it, the ``Comm`` the port's collectives
    take, and on CUDA its stream."""

    def __init__(self, index: int, group, rank: int, size: int, device: torch.device):
        from ..parallel.mesh import Comm

        self.index, self.group, self.rank, self.size = index, group, rank, size
        self.device = device
        self.comm = Comm(group, size, rank, tuple(range(size)))
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None


class _ChannelExecutor:
    """Per-channel response executor: a thread draining a FIFO queue.
    Every rank dispatches the same responses to the same channel in the
    same order, so matching collectives pair up across ranks."""

    def __init__(self, engine: "Engine", channel: Channel):
        self.engine = engine
        self.channel = channel
        self.queue: "queue_mod.Queue" = queue_mod.Queue()
        self.thread = threading.Thread(
            target=self._loop, name=f"hvd-exec-{channel.index}", daemon=True)
        self.thread.start()

    def _loop(self):
        eng = self.engine
        eng._bind_device()
        while True:
            resp = self.queue.get()
            if resp is _EXEC_STOP:
                break
            try:
                # After a fatal error, drain without executing.
                if eng._fatal_error is None:
                    eng._perform_operation(resp, self.channel)
            except HorovodInternalError as exc:
                eng._latch_fatal(exc)
            except BaseException as exc:  # pragma: no cover - defensive
                eng._latch_fatal(HorovodInternalError(str(exc)))
            finally:
                eng._response_done()


class Engine:
    def __init__(self, rank: int = 0, size: int = 1,
                 device: Optional[torch.device] = None, transport=None,
                 channel_groups=None, on_fatal: Optional[Callable[[], None]] = None):
        """``transport``: the control plane (``engine/transport.py``);
        ``channel_groups``: one data-plane process group per channel (None
        entries at a world of one); ``on_fatal``: called once, on the thread
        that latched it, when the first fatal error latches (``hvd.init()``
        aborts the world's process groups there, so a collective in flight
        with a dead peer ends on every channel and on the caller's own
        NCCL path instead of spinning)."""
        from .transport import LocalTransport

        self.rank = rank
        self.size = size
        self.device = device if device is not None else torch.device("cpu")
        self.transport = transport if transport is not None else LocalTransport()
        self._on_fatal = on_fatal
        groups = list(channel_groups) if channel_groups is not None \
            else [None] * env_cfg.num_channels()
        self.channels = [Channel(i, g, rank, size, self.device)
                         for i, g in enumerate(groups)]
        self.controller: Optional[Controller] = None
        self.op_manager = build_default(size)
        self.tensor_queue = TensorQueue()
        self.handles = HandleManager()
        self.timeline = (Timeline() if rank == 0 else Timeline(use_env=False))
        self.cycle_time_s = env_cfg.cycle_time_ms() / 1000.0
        self._thread: Optional[threading.Thread] = None
        self._shutdown_requested = threading.Event()
        self._initialized = threading.Event()
        self._init_error: Optional[BaseException] = None
        self._executors: Dict[int, _ChannelExecutor] = {}
        self._inflight = 0
        self._inflight_cond = threading.Condition()
        self._max_inflight = env_cfg.max_inflight_responses()
        self._fatal_error: Optional[HorovodInternalError] = None
        self._wake = threading.Event()
        self._event_cycles = env_cfg.cycle_event_driven()
        self.tensor_queue.set_wakeup(self._wake.set)
        self._op_counter = 0
        self._join_counter = 0
        self._counter_lock = threading.Lock()
        self._fusion_storage: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}
        self._stats = {"cycles": 0, "responses": 0, "fused_responses": 0,
                       "tensors": 0, "bytes": 0}
        self._stats_lock = threading.Lock()

    # ------------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self._background_loop, name="hvd-background", daemon=True)
        self._thread.start()
        self._initialized.wait()
        if self._init_error is not None:
            raise self._init_error

    def _bind_device(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _background_loop(self):
        try:
            self._bind_device()
            self.controller = Controller(self.transport, self.size, self.rank,
                                         timeline=self.timeline,
                                         num_channels=len(self.channels))
            for ch in self.channels:
                self._executors[ch.index] = _ChannelExecutor(self, ch)
        except BaseException as e:  # surface failures to start()
            self._init_error = e
            self._initialized.set()
            return
        self._initialized.set()
        try:
            while self._run_loop_once():
                pass
        except HorovodInternalError as e:
            # The control plane or a channel failed: every pending handle,
            # and every enqueue from here on, fails with the first cause.
            self._latch_fatal(e)
            first = self._fatal_error or e
            logger.error("background loop failed: %s", first)
            self.tensor_queue.finalize(Status.Aborted(str(first)))
        except BaseException as e:
            self._latch_fatal(HorovodInternalError(str(e)))
            logger.error("background loop failed: %s", e)
            self.tensor_queue.finalize(Status.UnknownError(str(e)))
        finally:
            for ex in list(self._executors.values()):
                ex.queue.put(_EXEC_STOP)
            for ex in list(self._executors.values()):
                ex.thread.join(timeout=10)
                if ex.thread.is_alive():  # pragma: no cover - wedged op
                    logger.warning("channel %d executor did not exit cleanly",
                                   ex.channel.index)
            self.timeline.shutdown()

    # ------------------------------------------------------------------
    # pipelined-execution plumbing
    def _latch_fatal(self, exc: HorovodInternalError):
        with self._inflight_cond:
            first = self._fatal_error is None
            if first:
                self._fatal_error = exc
            self._inflight_cond.notify_all()
        self._wake.set()
        if first and self._on_fatal is not None:
            try:
                self._on_fatal()
            except Exception as e:  # pragma: no cover - best effort
                logger.warning("aborting the process groups failed: %s", e)

    @property
    def failed(self) -> bool:
        """Whether a fatal error has latched: every pending and later
        collective of this engine fails."""
        return self._fatal_error is not None

    def _check_fatal(self):
        if self._fatal_error is not None:
            raise self._fatal_error

    def _response_done(self):
        with self._inflight_cond:
            self._inflight -= 1
            self._inflight_cond.notify_all()

    def _dispatch(self, resp: Response):
        """Hand a response to its channel executor, blocking while the
        in-flight window is full (backpressure)."""
        ex = self._executors[resp.channel]
        with self._inflight_cond:
            while (self._inflight >= self._max_inflight
                   and self._fatal_error is None):
                self._inflight_cond.wait(0.1)
            self._inflight += 1
        ex.queue.put(resp)

    def _drain_channels(self):
        """Fence: wait until every dispatched response has finished."""
        with self._inflight_cond:
            while self._inflight > 0 and self._fatal_error is None:
                self._inflight_cond.wait(0.1)
        self._check_fatal()

    def _cycle_wait(self):
        """Coalescing wait before a cycle: until an enqueue, at most the
        cycle time (a fixed sleep without event-driven cycles)."""
        if self._shutdown_requested.is_set() or self.cycle_time_s <= 0:
            return
        if not self._event_cycles:
            time.sleep(self.cycle_time_s)
            return
        self._wake.wait(self.cycle_time_s)
        # Clear before popping messages: an enqueue landing after the pop
        # re-sets it, so the next cycle wakes at once.
        self._wake.clear()

    # ------------------------------------------------------------------
    def _run_loop_once(self) -> bool:
        """(ref: RunLoopOnce, operations.cc:566-616)"""
        self._cycle_wait()
        self._check_fatal()
        self.timeline.mark_cycle()
        messages = self.tensor_queue.pop_messages_from_queue()
        want_shutdown = self._shutdown_requested.is_set()
        try:
            resp_list, should_shutdown = self.controller.compute_response_list(
                messages, shutdown=want_shutdown)
        except Exception as exc:
            raise HorovodInternalError(f"engine negotiation failed: {exc}") from exc
        with self._stats_lock:
            self._stats["cycles"] += 1
        # Terminal abort verdict (a stall shutdown): latch it as the first
        # cause and die without draining, so every pending handle fails
        # with the diagnosis.
        if should_shutdown:
            for resp in resp_list.responses:
                if (resp.response_type == ResponseType.ERROR
                        and not resp.tensor_names and resp.error_message):
                    exc = HorovodInternalError(resp.error_message)
                    self._latch_fatal(exc)
                    raise exc
        for resp in resp_list.responses:
            if resp.response_type in _FENCE_TYPES:
                self._drain_channels()
                self._perform_operation(resp, self.channels[0])
            else:
                self._dispatch(resp)
        if should_shutdown:
            # Clean shutdown (every rank agreed): in-flight collectives
            # complete before pending handles are finalized.
            self._drain_channels()
            self.tensor_queue.finalize(Status.Aborted("Horovod has been shut down."))
            return False
        return True

    # ------------------------------------------------------------------
    def _perform_operation(self, resp: Response, chan: Channel):
        """(ref: PerformOperation, operations.cc:253-330). On a channel
        executor for data responses, inline on the background thread for
        fences; on CUDA the channel's stream is current throughout."""
        if chan.stream is None or resp.response_type in _FENCE_TYPES:
            return self._execute_response(resp, chan)
        with torch.cuda.stream(chan.stream):
            return self._execute_response(resp, chan)

    def _ready(self, entries: List[TensorTableEntry], chan: Channel):
        """Make the channel's stream wait until each tensor is ready, and
        keep the tensors' memory from being reused until it is done."""
        if chan.stream is None:
            return
        for e in entries:
            if e.ready_event is not None:
                chan.stream.wait_event(e.ready_event)
            if e.tensor is not None and e.tensor.is_cuda:
                e.tensor.record_stream(chan.stream)

    def _done_event(self, chan: Channel):
        if chan.stream is None or self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(chan.stream)
        return ev

    def _count(self, resp: Response, entries: List[TensorTableEntry]):
        with self._stats_lock:
            self._stats["responses"] += 1
            self._stats["tensors"] += len(entries)
            self._stats["fused_responses"] += len(entries) > 1
            self._stats["bytes"] += sum(e.tensor.numel() * e.tensor.element_size()
                                        for e in entries if e.tensor is not None)

    def _execute_response(self, resp: Response, chan: Channel):
        entries = self.tensor_queue.get_tensor_entries(resp.tensor_names)
        if resp.response_type != ResponseType.ERROR:
            self._count(resp, entries)
        for e in entries:
            # The op phase opens when execution begins
            # (ref: Timeline::Start, timeline.h:106-110).
            self.timeline.start(e.tensor_name, resp.response_type.name)
        try:
            if resp.response_type == ResponseType.ERROR:
                for e in entries:
                    self._finish(e, Status.PreconditionError(resp.error_message), None)
                return
            if resp.response_type in (ResponseType.ALLREDUCE, ResponseType.ADASUM):
                self._do_allreduce(resp, entries, chan)
            elif resp.response_type == ResponseType.ALLGATHER:
                self._ready(entries, chan)
                for e in entries:
                    op = self.op_manager.select(ResponseType.ALLGATHER,
                                                device=e.tensor.device.type)
                    with self.timeline.activity(e.tensor_name, op.name):
                        out = op.execute(e.tensor, list(resp.tensor_sizes), chan)
                    self._finish(e, Status.OK(), out, self._done_event(chan))
            elif resp.response_type == ResponseType.BROADCAST:
                self._ready(entries, chan)
                for e in entries:
                    op = self.op_manager.select(ResponseType.BROADCAST,
                                                device=e.tensor.device.type)
                    with self.timeline.activity(e.tensor_name, op.name):
                        out = op.execute(e.tensor, e.root_rank, chan)
                    self._finish(e, Status.OK(), out, self._done_event(chan))
            elif resp.response_type == ResponseType.ALLTOALL:
                self._ready(entries, chan)
                for e in entries:
                    op = self.op_manager.select(ResponseType.ALLTOALL,
                                                device=e.tensor.device.type)
                    with self.timeline.activity(e.tensor_name, op.name):
                        out, recv_splits = op.execute(e.tensor, e.splits, chan)
                    self._finish(e, Status.OK(), (out, recv_splits),
                                 self._done_event(chan))
            elif resp.response_type == ResponseType.BARRIER:
                self.transport.barrier()
                for e in entries:
                    self._finish(e, Status.OK(), None)
            elif resp.response_type == ResponseType.JOIN:
                # All ranks joined; complete this rank's pending join entry
                # (the JOIN response carries no tensor names).
                for e in entries + self.tensor_queue.pop_entries_by_prefix("join."):
                    self._finish(e, Status.OK(), int(resp.last_joined_rank))
            else:
                for e in entries:
                    self._finish(
                        e, Status.UnknownError(f"bad response {resp.response_type}"), None)
        except Exception as exc:
            # A failed collective leaves the group unusable: fail these
            # entries, then let the error kill the engine, so every other
            # pending handle fails too instead of hanging.
            first = self._fatal_error
            status = Status.Aborted(str(first if first is not None else exc))
            for e in entries:
                self._finish(e, status, None)
            if isinstance(exc, HorovodInternalError):
                raise
            raise HorovodInternalError(
                f"{resp.response_type.name.lower()} failed: {exc}") from exc

    def _do_allreduce(self, resp: Response, entries: List[TensorTableEntry],
                      chan: Channel):
        adasum = resp.response_type == ResponseType.ADASUM
        kind = ResponseType.ADASUM if adasum else ResponseType.ALLREDUCE
        pre, post = resp.prescale_factor, resp.postscale_factor
        rop = ReduceOp(resp.reduce_op or int(ReduceOp.SUM))
        codec = resp.codec if self.size > 1 else 0
        if not entries:
            # This rank joined: contribute zeros of the full negotiated
            # shape (ref: JoinOp, controller.cc:220-231), through the same
            # op and codec as the contributing ranks.
            if self.size > 1:
                count = sum(_numel(shp) for shp in resp.tensor_shapes)
                zeros = torch.zeros(count, dtype=from_wire_dtype(resp.tensor_type),
                                    device=self.device)
                op = self.op_manager.select(kind, device=self.device.type)
                op.execute(zeros, rop, chan, codec)
            return
        name0 = entries[0].tensor_name
        self._ready(entries, chan)
        if len(entries) == 1:
            # An engine-owned copy, reduced in place and handed back.
            buf = entries[0].tensor.reshape(-1).clone()
            shapes = None
        else:
            # Fusion buffer (ref: MemcpyInFusionBuffer).
            with self.timeline.activity(name0, MEMCPY_IN_FUSION_BUFFER):
                shapes = [e.tensor.shape for e in entries]
                buf = self._pack_fusion(entries, chan)
        if pre != 1.0:
            buf = _scale(buf, pre)
        op = self.op_manager.select(kind, device=buf.device.type)
        with self.timeline.activity(name0, op.name):
            red = op.execute(buf, rop, chan, codec)
        if post != 1.0:
            red = _scale(red, post)
        if shapes is None:
            self._finish(entries[0], Status.OK(), red.view(entries[0].tensor.shape),
                         self._done_event(chan))
            return
        # Out of the fusion buffer: a result still in it (reduced in place,
        # no postscale or cast) is copied out, since the next pack reuses
        # it; a fresh one (scaled, cast back) is handed out in slices.
        in_buffer = red.data_ptr() == buf.data_ptr()
        with self.timeline.activity(name0, MEMCPY_OUT_FUSION_BUFFER):
            outs, off = [], 0
            for e, shape in zip(entries, shapes):
                n = _numel(shape)
                part = red[off:off + n].view(shape)
                outs.append(part.clone() if in_buffer else part)
                off += n
        ev = self._done_event(chan)
        for e, out in zip(entries, outs):
            self._finish(e, Status.OK(), out, ev)

    def _pack_fusion(self, entries: List[TensorTableEntry], chan: Channel) -> torch.Tensor:
        """Copy the entries into the channel's persistent fusion buffer for
        their dtype, on the device (grown when too small). Within a channel
        execution is serial, so reuse across cycles is race-free; the
        results are copied out before the next pack."""
        dtype = entries[0].tensor.dtype
        total = sum(e.tensor.numel() for e in entries)
        key = (chan.index, dtype)
        storage = self._fusion_storage.get(key)
        if storage is None or storage.numel() < total:
            storage = torch.empty(max(total, 1), dtype=dtype, device=entries[0].tensor.device)
            self._fusion_storage[key] = storage
        off = 0
        for e in entries:
            n = e.tensor.numel()
            storage[off:off + n].copy_(e.tensor.reshape(-1))
            off += n
        return storage[:total]

    def _finish(self, entry: TensorTableEntry, status: Status, result, event=None):
        self.timeline.end(entry.tensor_name, entry.op_name)
        if entry.callback is not None:
            entry.callback(status, _Done(result, event) if status.ok() else None)

    # ------------------------------------------------------------------
    # Enqueue API (ref: EnqueueTensor*, operations.cc:840-1068)
    def _auto_name(self, op: str, name: Optional[str]) -> str:
        """``<op>.<name>`` for a named tensor. An unnamed one takes
        ``noname.<n>`` from one counter over every collective (as the
        reference's unnamed ops take their handle), so ranks that issue
        different collectives at the same point meet under one name and
        get the coordinator's mismatch error instead of a stall; joins keep
        ``join.noname.<n>``, which the JOIN response completes by prefix."""
        if name is not None:
            return f"{op}.{name}"
        with self._counter_lock:
            if op == "join":
                self._join_counter += 1
                return f"join.noname.{self._join_counter - 1}"
            self._op_counter += 1
            return f"noname.{self._op_counter - 1}"

    def _entry(self, req_type: RequestType, tensor: Optional[torch.Tensor], name: str,
               op_name: str, root_rank: int = 0, prescale: float = 1.0,
               postscale: float = 1.0, splits: Optional[List[int]] = None,
               reduce_op: ReduceOp = ReduceOp.SUM):
        handle = self.handles.allocate()
        req = Request(
            request_rank=self.rank,
            request_type=req_type,
            tensor_type=to_wire_dtype(tensor.dtype) if tensor is not None else 0,
            tensor_name=name,
            root_rank=root_rank,
            device=-1,
            tensor_shape=tuple(tensor.shape) if tensor is not None else (),
            prescale_factor=prescale,
            postscale_factor=postscale,
            reduce_op=int(reduce_op),
        )
        if tensor is not None and self.controller is not None:
            self.controller.record_tensor_size(name, tensor.numel() * tensor.element_size())
        ready = None
        if tensor is not None and tensor.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(tensor.device))

        def callback(status: Status, done):
            self.handles.mark_done(handle, status, done)

        entry = TensorTableEntry(
            tensor_name=name, tensor=tensor, root_rank=root_rank, callback=callback,
            splits=splits, op_name=op_name,
            ready_event=ready)
        return handle, entry, req

    def _submit(self, made) -> List[int]:
        statuses = self.tensor_queue.add_many([(e, r) for _, e, r in made])
        for (handle, _, _), status in zip(made, statuses):
            if not status.ok():
                self.handles.mark_done(handle, status, None)
        return [h for h, _, _ in made]

    def _allreduce_request(self, op: ReduceOp, prescale: float, postscale: float):
        # AVERAGE lowers to SUM + postscale 1/size (ref: operations.cc:851-858).
        if op == ReduceOp.AVERAGE:
            postscale = postscale / self.size
            op = ReduceOp.SUM
        rt = RequestType.ADASUM if op == ReduceOp.ADASUM else RequestType.ALLREDUCE
        if op == ReduceOp.ADASUM and self.size & (self.size - 1):
            raise ValueError("Adasum requires a power-of-2 number of ranks")
        reduce_op = op if op in (ReduceOp.MIN, ReduceOp.MAX, ReduceOp.PRODUCT) \
            else ReduceOp.SUM
        return rt, prescale, postscale, reduce_op

    def enqueue_allreduce(self, tensor: torch.Tensor, name: Optional[str] = None,
                          op: ReduceOp = ReduceOp.SUM, prescale: float = 1.0,
                          postscale: float = 1.0) -> int:
        return self.enqueue_allreduces([tensor], [name], op, prescale, postscale)[0]

    def enqueue_allreduces(self, tensors, names, op: ReduceOp = ReduceOp.SUM,
                           prescale: float = 1.0, postscale: float = 1.0) -> List[int]:
        """Several all-reduces added to the queue at once, so they are
        negotiated in one cycle and fuse (a grouped all-reduce)."""
        rt, pre, post, rop = self._allreduce_request(op, prescale, postscale)
        return self._submit([self._entry(rt, t, self._auto_name("allreduce", n),
                                         "allreduce", 0, pre, post, reduce_op=rop)
                             for t, n in zip(tensors, names)])

    def enqueue_allgather(self, tensor: torch.Tensor, name: Optional[str] = None) -> int:
        return self._submit([self._entry(RequestType.ALLGATHER, tensor,
                                         self._auto_name("allgather", name),
                                         "allgather")])[0]

    def enqueue_broadcast(self, tensor: torch.Tensor, root_rank: int,
                          name: Optional[str] = None) -> int:
        return self._submit([self._entry(RequestType.BROADCAST, tensor,
                                         self._auto_name("broadcast", name),
                                         "broadcast", root_rank)])[0]

    def enqueue_alltoall(self, tensor: torch.Tensor, splits: Optional[List[int]],
                         name: Optional[str] = None) -> int:
        if splits is None:
            if tensor.shape[0] % self.size:
                raise ValueError("tensor dim 0 must be divisible by size when splits=None")
            splits = [tensor.shape[0] // self.size] * self.size
        if sum(splits) != tensor.shape[0]:
            raise ValueError("splits must sum to tensor dim 0")
        return self._submit([self._entry(RequestType.ALLTOALL, tensor,
                                         self._auto_name("alltoall", name), "alltoall",
                                         splits=list(splits))])[0]

    def enqueue_join(self) -> int:
        return self._submit([self._entry(RequestType.JOIN, None,
                                         self._auto_name("join", None), "join")])[0]

    def enqueue_barrier(self) -> int:
        return self._submit([self._entry(RequestType.BARRIER,
                                         torch.zeros(0, dtype=torch.uint8),
                                         self._auto_name("barrier", None), "barrier")])[0]

    # ------------------------------------------------------------------
    def counters(self) -> dict:
        """Cycles run, negotiation rounds, responses executed (fused ones
        apart), tensors and input bytes they moved, and the response
        cache's hits and misses, since the engine started."""
        with self._stats_lock:
            out = dict(self._stats)
        ctrl = self.controller
        if ctrl is not None:
            out["negotiations"] = ctrl.negotiations
            out["cache_hits"] = ctrl.response_cache.hits
            out["cache_misses"] = ctrl.response_cache.misses
            out["stall_warnings"] = ctrl.stall_inspector.warnings
        return out

    def poll(self, handle: int) -> bool:
        return self.handles.poll(handle)

    def synchronize(self, handle: int, timeout: Optional[float] = None):
        return self.handles.wait(handle, timeout)

    def shutdown(self):
        """Stop collectively: this rank's next cycle carries the shutdown
        flag, every rank's loop ends in that cycle (ref: engine.py:1660).
        After a fatal error the loop has ended, or ends at its next cycle,
        on this rank alone: nothing is waited for from the others."""
        if self._thread is None:
            return
        self._shutdown_requested.set()
        self._wake.set()
        self._thread.join(timeout=15 if self.failed else 60)
        self._thread = None
        # Let go of the process groups: a gloo group's sockets close only
        # when it is freed (its abort() closes nothing), and that is how
        # peers still blocked on this rank in a failed world learn of the
        # failure. Handles keep this engine alive, and the first error's
        # traceback keeps the frames that used the groups.
        if getattr(self.transport, "group", None) is not None:
            self.transport.group = None
        self.transport = self.controller = None
        for ch in self.channels:
            ch.group = ch.comm = None
        err = self._fatal_error
        while err is not None:
            err.__traceback__, err = None, err.__cause__ or err.__context__
