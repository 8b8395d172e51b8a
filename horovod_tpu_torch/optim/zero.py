"""ZeRO-1/2 sharded optimizer state and error feedback (counterpart of
``horovod_tpu/optim/zero.py:73-92, 126-151, 199-375, 467-500, 570-736``, the
traced plane's layout; Rajbhandari et al., "ZeRO: Memory Optimizations
Toward Training Trillion Parameter Models").

``DistributedOptimizer(opt, zero=1|2)`` stops keeping a full copy of the
inner optimizer's state on every rank of its line: the world, or with
``axis_name=`` the line of the mesh it names (one axis or a tuple such as
``("dp", "sp")``, ``parallel/mesh.py``), the ``axis_name`` of the JAX
``zero_optimizer``. Each param group's gradients are packed into one flat
buffer (f32, or f64 if a parameter is), padded to a multiple of the line's
size n (``_shard_geometry``), and the member of index r in the line owns
elements ``[r·k, (r+1)·k)``. Every member of a line holds parameters of
the same shapes (a tp or ep rank's own shards, a pp rank's own stage), so
the line shards what its members hold alike. A step:

a. reduce-scatters the flat gradient (the port's ``ops`` reducescatter:
   NCCL's ``reduce_scatter_tensor``, an all-reduce and a slice on gloo),
   each rank receiving its owned slice; with a wire cast selected
   (``HOROVOD_WIRE_COMPRESSION``) and no error feedback, the slice travels
   and sums in the narrow dtype;
b. divides by n for AVERAGE, then applies the postscale;
c. steps the owned slice with the inner optimizer rebuilt as
   ``type(opt)`` over one flat shard tensor per group, each group with its
   hyperparameters (copied from the user's groups before every step, so an
   LR scheduler still works);
d. takes the update (new shard − old shard), encodes it for the wire
   (int8, bf16 or fp16, ``_update_wire_mode``), all-gathers it, and adds
   the decoded updates to the model's parameters in place (the
   ``nn.Parameter`` objects and their storage stay the user's); at full
   width without error feedback it all-gathers the new shards and copies
   them in, so the parameters are bitwise the inner optimizer's;
e. with ``error_feedback=True``, keeps the residual ``h − decode(encode(h))``
   of the owned update shard (1/n memory) and adds it to the next step's
   update; the scatter leg then ships full width.

Stages 1 and 2 share this layout: the reduce-scatter never materialises
the full reduced gradient, so every stage is stage 2 in effect, as in the
JAX traced plane. ``zero=0, error_feedback=True`` keeps the replicated
state and corrects the all-reduce's wire cast with a full-size residual
(``EFReducer``). A parameter without a gradient counts as a zero gradient.

Only elementwise inner optimizers shard: SGD (with or without momentum),
Adam, AdamW and RMSprop. Under ZeRO the wrapper's ``state_dict()`` is the
shard's (plus the residuals and the geometry); ``state_to_global``
gathers every member's shard into the line-stacked form, ``recut_state``
re-cuts that form for another line size bitwise, and
``state_from_global`` takes one member's shard back out of it. A
parameter cut over the line's own axes (``parallel/fsdp.py``) has its
gradient reduce-scattered in backward and cannot be sharded again: both
reducers refuse it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from .. import ops
from ..common import telemetry
from ..common.types import ReduceOp
from ..ops import wire
from ..parallel.mesh import Comm, world_comm

ELEMENTWISE = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW,
               torch.optim.RMSprop)

_status_lock = threading.Lock()
_status: dict = {}


_STATE_BYTES_HELP = (
    "Optimizer-state bytes this rank holds: mode=\"sharded\" is the "
    "measured owned-shard footprint, mode=\"replicated\" is what a "
    "full-replica optimizer would hold (docs/running.md \"ZeRO sharded "
    "optimizer state\")")


def _set_state_gauges(sharded: int, replicated: int) -> None:
    """The JAX package's ``horovod_optimizer_state_bytes{mode=...}``."""
    telemetry.gauge("horovod_optimizer_state_bytes", _STATE_BYTES_HELP,
                    labels={"mode": "sharded"}).set(int(sharded))
    telemetry.gauge("horovod_optimizer_state_bytes", _STATE_BYTES_HELP,
                    labels={"mode": "replicated"}).set(int(replicated))


def _note_status(**kw) -> None:
    with _status_lock:
        _status.update(kw)
        _status["wall"] = time.time()


def status_snapshot() -> dict:
    """The ZeRO configuration and state bytes of the last ZeRO or
    error-feedback optimizer this process built (``{}`` before one)."""
    with _status_lock:
        return dict(_status)


def _shard_geometry(total: int, n: int):
    """(padding, shard length) of a flat buffer of ``total`` over n ranks."""
    pad = (-total) % n
    return pad, (total + pad) // n


def _acc_dtype(params) -> torch.dtype:
    acc = torch.float32
    for p in params:
        acc = torch.promote_types(acc, p.dtype)
    return acc


def _update_wire_mode(h: torch.Tensor) -> Optional[str]:
    """The codec of the all-gather (update) leg: the int8 lane first, then
    the bf16/fp16 cast, on the gradient side's gates (f32, at least the
    min bytes)."""
    if wire.int8_enabled(h, ReduceOp.SUM):
        return "int8"
    dt = wire.wire_dtype(h, ReduceOp.SUM)
    if dt is None:
        return None
    return "fp16" if dt == torch.float16 else "bf16"


def _encode_gather(h: torch.Tensor, comm: Comm):
    """Encode the owned update shard, all-gather it over ``comm``, decode:
    returns (the full (n·k,) updates, this rank's own decoded shard). The
    own decode is bitwise what every receiver computes for it, so the
    residual accounts exactly the error that was shipped."""
    mode = _update_wire_mode(h)
    if mode == "int8":
        q, scale = wire.int8_encode(h.to(torch.float32))
        qs = wire.all_gather_launch(q, False, comm)[1]()
        ss = wire.all_gather_launch(scale.reshape(1), False, comm)[1]()
        full = (qs.to(torch.float32) * ss).reshape(-1).to(h.dtype)
        return full, wire.int8_decode(q, scale).to(h.dtype)
    if mode is not None:
        w = h.to(torch.float16 if mode == "fp16" else torch.bfloat16)
        return (wire.all_gather_launch(w, False, comm)[1]().reshape(-1).to(h.dtype),
                w.to(h.dtype))
    return wire.all_gather_launch(h, False, comm)[1]().reshape(-1), h


def _pack(tensors: Sequence[torch.Tensor], acc: torch.dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(acc) for t in tensors])


def _grads(params) -> List[torch.Tensor]:
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


def _check_elementwise(optimizer: torch.optim.Optimizer) -> None:
    if type(optimizer) not in ELEMENTWISE:
        raise ValueError(
            f"ZeRO shards only elementwise optimizers "
            f"({', '.join(c.__name__ for c in ELEMENTWISE)}), got "
            f"{type(optimizer).__name__}")


def _check_not_presummed(params, what: str) -> None:
    """A parameter cut over the line (FSDP) already has its gradient summed
    there in backward, and its state is already this rank's shard."""
    if any(getattr(p, "fsdp", None) is not None for p in params):
        raise ValueError(f"{what} does not take parameters cut over dp (FSDP_RULES): "
                         "their gradients are reduce-scattered in backward and their "
                         "optimizer state is already sharded")


def _hyper(group: dict) -> dict:
    return {k: v for k, v in group.items() if k != "params"}


class _Group:
    """One param group's flat layout: which slices of which parameters
    make up this rank's shard ``[lo, hi)``."""

    def __init__(self, params: List[torch.Tensor], n: int, r: int):
        self.params = params
        self.sizes = [p.numel() for p in params]
        self.total = sum(self.sizes)
        self.pad, self.k = _shard_geometry(self.total, n)
        self.acc = _acc_dtype(params)
        self.lo, self.hi = r * self.k, (r + 1) * self.k
        self.pieces = []   # (param index, start, end) inside the shard
        off = 0
        for i, size in enumerate(self.sizes):
            a, b = max(self.lo, off), min(self.hi, off + size)
            if a < b:
                self.pieces.append((i, a - off, b - off))
            off += size
        self.tail = max(0, self.hi - max(self.lo, self.total))   # padding owned

    def owned_params(self) -> torch.Tensor:
        """The (k,) shard of the flat parameters, padding as zeros."""
        parts = [self.params[i].detach().reshape(-1)[a:b].to(self.acc)
                 for i, a, b in self.pieces]
        if self.tail:
            parts.append(torch.zeros(self.tail, dtype=self.acc,
                                     device=self.params[0].device))
        return torch.cat(parts)

    def _views(self, full: torch.Tensor) -> List[torch.Tensor]:
        return [u.view(p.shape).to(p.dtype)
                for u, p in zip(torch.split(full[:self.total], self.sizes), self.params)]

    def add_updates(self, full: torch.Tensor) -> None:
        """params += the full decoded updates, in each parameter's dtype."""
        torch._foreach_add_([p.data for p in self.params], self._views(full))

    def set_params(self, full: torch.Tensor) -> None:
        """params = the full flat parameters."""
        torch._foreach_copy_([p.data for p in self.params], self._views(full))


class ZeroSharder:
    """ZeRO stage 1 or 2 over the param groups of ``optimizer``; see the
    module docstring for the step."""

    def __init__(self, optimizer: torch.optim.Optimizer, stage: int,
                 error_feedback: bool, op: ReduceOp, prescale_factor: float,
                 postscale_factor: float, comm: Optional[Comm] = None):
        _check_elementwise(optimizer)
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"ZeRO reduces gradients by SUM or AVERAGE, not "
                             f"{ReduceOp(op).name}")
        _check_not_presummed([p for g in optimizer.param_groups for p in g["params"]],
                             "ZeRO")
        self.user = optimizer
        self.stage, self.error_feedback = stage, error_feedback
        self.op, self.pre, self.post = op, prescale_factor, postscale_factor
        self.comm = comm or world_comm()
        # "world" and "rank" are the line's size and this rank's index in it.
        self.world, self.rank = self.comm.size, self.comm.rank
        self.groups = [_Group([p for p in g["params"] if p.requires_grad],
                              self.world, self.rank) for g in optimizer.param_groups]
        for g in self.groups:
            if not g.params:
                raise ValueError("ZeRO needs every param group to hold a "
                                 "parameter that requires grad")
        self.shards = [torch.zeros(g.k, dtype=g.acc, device=g.params[0].device)
                       for g in self.groups]
        self.inner = type(optimizer)([{**_hyper(ug), "params": [s]} for ug, s in
                                      zip(optimizer.param_groups, self.shards)])
        self.residuals = [torch.zeros(g.k, dtype=g.acc, device=s.device)
                          if error_feedback else None
                          for g, s in zip(self.groups, self.shards)]
        _note_status(enabled=True, plane="torch", stage=stage, world=self.world,
                     error_feedback=error_feedback,
                     shard_elems=[g.k for g in self.groups],
                     total_elems=[g.total for g in self.groups])

    # -- the step ----------------------------------------------------------
    def _scatter(self, g: _Group) -> torch.Tensor:
        """(a) and (b): this rank's slice of the reduced gradient."""
        with ops.span("hvd.flatten"):
            flat = ops._scale(_pack(_grads(g.params), g.acc), self.pre)
            if g.pad:
                flat = torch.cat([flat, flat.new_zeros(g.pad)])
        dt = None if self.error_feedback else wire.wire_dtype(flat, self.op)
        shard = ops._reducescatter(flat if dt is None else flat.to(dt),
                                   ReduceOp.SUM, self.comm).to(g.acc)
        if self.op == ReduceOp.AVERAGE:
            shard = shard / self.world
        return ops._scale(shard, self.post)

    @torch.no_grad()
    def step(self) -> None:
        for ug, ig in zip(self.user.param_groups, self.inner.param_groups):
            ig.update(_hyper(ug))
        olds = []
        for g, shard in zip(self.groups, self.shards):
            grad = self._scatter(g)
            with ops.span("hvd.flatten"):
                old = g.owned_params()
            shard.copy_(old)
            shard.grad = grad
            olds.append(old)
        self.inner.step()
        for i, (g, shard, old) in enumerate(zip(self.groups, self.shards, olds)):
            shard.grad = None
            if not self.error_feedback and _update_wire_mode(shard) is None:
                # Full width: gather the new shards themselves, so every rank
                # holds the inner optimizer's values bitwise (old + (new − old)
                # rounds where new and old are not within a factor of 2).
                full = wire.all_gather_launch(shard, False, self.comm)[1]().reshape(-1)
                with ops.span("hvd.unflatten"):
                    g.set_params(full)
                continue
            h = shard - old
            if self.error_feedback:
                h = h + self.residuals[i]
            full, own = _encode_gather(h, self.comm)
            if self.error_feedback:
                self.residuals[i] = h - own
            with ops.span("hvd.unflatten"):
                g.add_updates(full)
        sizes = self.state_bytes()
        _set_state_gauges(sizes["sharded_state_bytes"], sizes["replicated_state_bytes"])
        _note_status(**sizes)

    # -- state ---------------------------------------------------------------
    def state_bytes(self) -> Dict[str, int]:
        """Optimizer-state bytes this rank holds (``sharded``: the owned
        moments plus the residual) and what a full replica would hold
        (``replicated``: the same per-element state over every element)."""
        sharded = replicated = 0
        for g, shard, res in zip(self.groups, self.shards, self.residuals):
            per_elem = sum(t.element_size() for t in self.inner.state.get(shard, {}).values()
                           if torch.is_tensor(t) and t.dim() == 1 and t.numel() == g.k)
            sharded += per_elem * g.k + (0 if res is None else res.numel() * res.element_size())
            replicated += per_elem * g.total
        return {"sharded_state_bytes": sharded, "replicated_state_bytes": replicated}

    def shard_state(self) -> dict:
        """This rank's state: per group, the inner optimizer's tensors over
        the shard and the residual."""
        groups = []
        for shard, res in zip(self.shards, self.residuals):
            st = {k: v for k, v in self.inner.state.get(shard, {}).items()
                  if torch.is_tensor(v)}
            if res is not None:
                st["residual"] = res
            groups.append(st)
        return {"world": self.world, "rank": self.rank, "groups": groups}

    def load_shard_state(self, state: dict) -> None:
        if (state["world"], state["rank"]) != (self.world, self.rank):
            raise ValueError(
                f"a shard of rank {state['rank']} of {state['world']} does not fit "
                f"rank {self.rank} of {self.world}; re-cut it with recut_state")
        if len(state["groups"]) != len(self.groups):
            raise ValueError(f"{len(state['groups'])} groups of state for "
                             f"{len(self.groups)} param groups")
        for i, (g, shard, st) in enumerate(zip(self.groups, self.shards, state["groups"])):
            st = dict(st)
            res = st.pop("residual", None)
            if self.error_feedback:
                if res is None:
                    raise ValueError("error feedback needs a residual in the state")
                self.residuals[i] = res.to(device=shard.device, dtype=g.acc).clone()
            cur = self.inner.state[shard]
            for key, val in st.items():
                if val.dim() == 0:   # torch keeps step counts as 0-d f32 tensors
                    dev = cur[key].device if key in cur else (
                        shard.device if self.inner.param_groups[i].get("capturable")
                        or self.inner.param_groups[i].get("fused") else "cpu")
                    cur[key] = val.detach().to(device=dev, dtype=torch.float32).clone()
                else:
                    if val.shape != (g.k,):
                        raise ValueError(f"state {key!r} of shape {tuple(val.shape)}, "
                                         f"the shard holds {g.k}")
                    cur[key] = val.detach().to(device=shard.device, dtype=g.acc).clone()

    def state_dict(self) -> dict:
        sd = self.inner.state_dict()
        sd["zero"] = {"stage": self.stage, "world": self.world, "rank": self.rank,
                      "totals": [g.total for g in self.groups],
                      "residuals": self.residuals}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        sd = dict(sd)
        z = sd.pop("zero", None)
        if z is None or (z["world"], z["rank"]) != (self.world, self.rank):
            raise ValueError("not a ZeRO state dict of this rank and world; "
                             "re-cut the global state with recut_state")
        self.inner.load_state_dict(sd)
        for ug, ig in zip(self.user.param_groups, self.inner.param_groups):
            ug.update(_hyper(ig))
        if self.error_feedback:
            self.residuals = [r.to(s.device).clone() for r, s in zip(z["residuals"], self.shards)]


class EFReducer:
    """Error feedback without ZeRO (stage 0): the replicated optimizer, and
    a full-size residual per param group that corrects the all-reduce's
    wire cast. e = prescaled gradients + residual is encoded, the ranks
    reduce the encoded values, and the new residual is e − decode(encode(e)),
    so the shipped values telescope to the true sum."""

    def __init__(self, optimizer: torch.optim.Optimizer, op: ReduceOp,
                 prescale_factor: float, postscale_factor: float,
                 comm: Optional[Comm] = None):
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"error feedback reduces by SUM or AVERAGE, not "
                             f"{ReduceOp(op).name}")
        _check_not_presummed([p for g in optimizer.param_groups for p in g["params"]],
                             "error feedback")
        self.op, self.pre, self.post = op, prescale_factor, postscale_factor
        self.comm = comm or world_comm()
        groups = ([p for p in g["params"] if p.requires_grad]
                  for g in optimizer.param_groups)
        self.groups = [ps for ps in groups if ps]
        self.residuals = [torch.zeros(sum(p.numel() for p in ps), dtype=_acc_dtype(ps),
                                      device=ps[0].device) for ps in self.groups]
        _note_status(enabled=True, plane="torch", stage=0, world=self.comm.size,
                     error_feedback=True)

    @torch.no_grad()
    def synchronize(self) -> None:
        n = self.comm.size
        for i, params in enumerate(self.groups):
            res = self.residuals[i]
            e = ops._scale(_pack(_grads(params), res.dtype), self.pre) + res
            if wire.int8_enabled(e, self.op):
                red = wire.int8_allreduce_launch(e, False, self.comm)[1]()
                own = wire.int8_decode(*wire.int8_encode(e))
            else:
                dt = wire.wire_dtype(e, self.op)
                own = e if dt is None else e.to(dt)
                buf = own.clone()
                if not self.comm.trivial:
                    torch.distributed.all_reduce(buf, group=self.comm.group)
                red, own = buf.to(e.dtype), own.to(e.dtype)
            self.residuals[i] = e - own
            if self.op == ReduceOp.AVERAGE:
                red = red / n
            red = ops._scale(red, self.post)
            for p, r in zip(params, torch.split(red, [p.numel() for p in params])):
                p.grad = r.view(p.shape).to(p.dtype)


# ---------------------------------------------------------------------------
# The line-stacked form: every member's shard state, leaves (n, k) or (n,)
# ("world" is the line's size n).
def state_to_global(optimizer) -> dict:
    """Gather every member's shard state of a ZeRO ``DistributedOptimizer``
    over its line into the stacked form every member then holds: per
    group, each (k,) leaf as (n, k) and each scalar as (n,), plus the
    line's size and each group's element count (collective: every member
    of the line calls it)."""
    sharder = optimizer._zero
    if not isinstance(sharder, ZeroSharder):
        raise ValueError("state_to_global needs a DistributedOptimizer(zero=1|2)")
    groups = []
    for st, shard in zip(sharder.shard_state()["groups"], sharder.shards):
        out = {}
        for key in sorted(st):
            val = st[key].to(shard.device)
            stacked = wire.all_gather_launch(val.reshape(-1) if val.dim() else val.reshape(1),
                                             False, sharder.comm)[1]()
            out[key] = stacked if val.dim() else stacked.reshape(-1)
        groups.append(out)
    return {"world": sharder.world, "totals": [g.total for g in sharder.groups],
            "groups": groups}


def state_from_global(state: dict, rank: int) -> dict:
    """Rank ``rank``'s shard state out of the stacked form, for
    ``DistributedOptimizer.load_shard_state``."""
    n = state["world"]
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    return {"world": n, "rank": rank,
            "groups": [{k: v[rank] for k, v in g.items()} for g in state["groups"]]}


def recut_state(state: dict, new_world: int) -> dict:
    """Re-cut the stacked form from world n to ``new_world``: each (n, k)
    leaf is flattened, cut to the group's element count, padded with zeros
    to a multiple of ``new_world`` and stacked again; each scalar leaf
    (the step count, the same on every shard) takes shard 0's value. The
    content is preserved bitwise; only the zero padding is resized."""
    n = state["world"]
    groups = []
    for total, g in zip(state["totals"], state["groups"]):
        _, k = _shard_geometry(total, n)
        pad_m, k2 = _shard_geometry(total, new_world)
        out = {}
        for key, leaf in g.items():
            if leaf.shape == (n,):
                out[key] = leaf[:1].expand(new_world).clone()
            elif leaf.dim() == 2 and leaf.shape == (n, k):
                flat = leaf.reshape(-1)[:total]
                out[key] = torch.cat([flat, flat.new_zeros(pad_m)]).view(new_world, k2)
            else:
                raise ValueError(
                    f"unrecognized ZeRO state leaf {key!r} of shape {tuple(leaf.shape)} "
                    f"for world {n} / shard {k}: only elementwise optimizers "
                    "(leaves (n, k) or (n,)) re-cut")
        groups.append(out)
    return {"world": new_world, "totals": list(state["totals"]), "groups": groups}
