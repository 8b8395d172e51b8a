"""DistributedOptimizer, DistributedGradientTape and
distributed_value_and_grad (counterpart of
``horovod_tpu/optim/distributed.py``).

``DistributedOptimizer`` wraps a ``torch.optim.Optimizer`` and averages the
gradients across ranks before the inner optimizer steps, with AVERAGE as
SUM then 1/size and the pre/postscale factors of the JAX package. With
``compression`` each gradient is compressed first, all-reduced in the
compressed dtype (a bf16 sum for ``Compression.fp16``, as the JAX package
sums) and then decompressed. Three paths:

* **overlapped** (ref: the hooks of horovod/torch/optimizer.py:32-207): at
  construction every parameter gets a post-accumulate-grad hook, and the
  parameters, in reverse registration order (about the order backward
  produces their gradients), are cut into buckets of one wire dtype up to
  ``HOROVOD_FUSION_THRESHOLD`` bytes (``fuse=False``: one gradient a
  bucket; ``fuse=None``, the default, is True for every op but Adasum).
  A hook holds its gradient; a bucket whose gradients have all landed is
  packed into its buffer in one copy and all-reduced asynchronously while
  backward goes on, buckets always launching in index order, so every rank
  launches the same collectives in the same order.
  ``step()`` gives the parameters that got no gradient zeros, launches what
  is left in that order, waits for every bucket, and writes the reduced
  gradients to ``.grad``. As in Horovod, the reduction overwrites ``.grad``:
  code that edits the gradients (clipping) calls ``synchronize()`` first;
* **ZeRO** (``zero=1|2``) and **error feedback** (``error_feedback=True``):
  ``optim/zero.py``, over the same line as the all-reduce. ``zero=None``
  defers to ``HOROVOD_ZERO_SHARDING``;
* **Adasum** (``op=Adasum``): after backward, the gradients combined by
  ``ops/adasum.py`` in one grouped buffer. At the default (``fuse=None``)
  and with ``fuse=False`` each gradient is combined on its own, its own
  dot and norms over its range of the buffer, as the JAX
  ``DistributedOptimizer`` (``fuse=False`` by default) combines leaf by
  leaf; ``fuse=True`` combines the buffer as one vector, as the JAX fused
  path does (``grouped_allreduce``).

On every path a parameter that requires grad but got none on this rank
(a branch this rank's batch did not take, an MoE expert without tokens)
counts as a zero gradient, as in Horovod and the JAX package: every rank
writes the reduced value to every ``.grad``, so the replicas stay equal.

A parameter cut over the line's axes (FSDP, ``parallel/fsdp.py``) has its
gradient summed over the line in backward, by the reduce-scatter of its
gather. The optimizer skips the line for it and applies only the op's
scale (1/n for AVERAGE) and the pre- and postscale; ZeRO, error feedback,
Adasum, compression and ``backward_passes_per_step`` > 1 refuse such a
parameter.

``synchronize()`` is the explicit form of the reduction; a ``step()`` after
it only steps the inner optimizer. The ranks' gradient signatures (count,
sizes, op, scale factors) are checked against each other once, on the
first reduction; after that the step reads nothing back to the host.

``backward_passes_per_step=k`` follows ``optax.MultiSteps``, which the JAX
wrapper uses: ``step()`` is called after every backward pass, the wrapper
keeps the running mean of the k gradients, and on every k-th call it
all-reduces that mean (overlapped: the hooks of the k-th pass launch it)
and lets the inner optimizer step; on the other calls the parameters do
not change.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Mapping, Optional

import torch

from .. import ops
from ..common import env
from ..common.exceptions import HorovodInternalError, comm_failures_raise_internal
from ..common.types import ReduceOp
from ..ops.compression import Compression
from ..parallel.mesh import Comm, current_mesh, resolve_comm
from . import zero as zero_mod

_GRAD_OPS = (ReduceOp.AVERAGE, ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX,
             ReduceOp.PRODUCT, ReduceOp.ADASUM)


def _check_op(op: ReduceOp):
    if op not in _GRAD_OPS:
        raise NotImplementedError(f"reduce op {ReduceOp(op).name} is not ported yet")


def _check_grad_signature(label: str, dtype: torch.dtype, sizes: List[int],
                          op: ReduceOp, prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          comm: Optional[Comm] = None) -> None:
    """Every rank of ``comm`` reduces the same gradient layout with the same
    op and factors, else ``HorovodInternalError`` on every rank; two int64
    all-gathers and two host reads past one rank, so a caller runs it once."""
    heads = ops._exchange_header(label, label, dtype, (len(sizes),), op,
                                 prescale_factor, postscale_factor, extra=sizes,
                                 comm=comm)
    ops._check_same_shape(label, heads)
    for r, (_, counts) in enumerate(heads):
        if counts != heads[0][1]:
            raise HorovodInternalError(
                f"{label}: gradient sizes mismatch, rank 0 has {list(heads[0][1])}, "
                f"rank {r} has {list(counts)}")


def _widest(tensors: List[torch.Tensor]) -> torch.dtype:
    widest = tensors[0].dtype
    for t in tensors[1:]:
        widest = torch.promote_types(widest, t.dtype)
    return widest


def _allreduce_grads(grads: List[torch.Tensor], op: ReduceOp,
                     prescale_factor: float, postscale_factor: float,
                     compression, fuse: bool, comm: Optional[Comm] = None
                     ) -> List[torch.Tensor]:
    """Compress, all-reduce (one grouped collective when ``fuse``, else one
    per gradient) and decompress (ref: the JAX ``_allreduce_grads``), with
    no header: the callers check their signature once. Adasum without
    ``fuse`` runs in one grouped buffer too, each gradient combined on its
    own (``ops/adasum.py``), not one exchange a gradient."""
    comp = compression or Compression.none
    packed = [comp.compress(g) for g in grads]
    wire = [c for c, _ in packed]
    if fuse or op == ReduceOp.ADASUM:
        red = ops._grouped_allreduce(wire, op=op, prescale_factor=prescale_factor,
                                     postscale_factor=postscale_factor, comm=comm,
                                     per_tensor=not fuse)
    else:
        red = [ops._allreduce(c, op=op, prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor, comm=comm)
               for c in wire]
    return [comp.decompress(r, ctx) for r, (_, ctx) in zip(red, packed)]


class _Bucket:
    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.itemsize = torch.empty(0, dtype=dtype).element_size()
        self.params: List[torch.Tensor] = []
        self.sizes: List[int] = []
        self.numel = 0
        self.buf: Optional[torch.Tensor] = None
        self.parts: List[Optional[torch.Tensor]] = []   # the gradients, as they land
        self.pending = 0
        self.launched = None   # (work, finish) once launched

    def add(self, p: torch.Tensor) -> None:
        self.params.append(p)
        self.sizes.append(p.numel())
        self.numel += p.numel()

    def flatten(self) -> torch.Tensor:
        """The landed gradients packed into the bucket's buffer, one copy."""
        if self.buf is None:
            self.buf = torch.empty(self.numel, dtype=self.dtype,
                                   device=self.params[0].device)
        torch.cat([t.reshape(-1) for t in self.parts], out=self.buf)
        self.parts = [None] * len(self.params)
        return self.buf


def _hook(ref):
    """A post-accumulate-grad hook that holds its optimizer weakly, so the
    hook does not keep a dropped optimizer alive."""
    def hook(p):
        opt = ref()
        if opt is not None:
            opt._on_grad(p)
    return hook


# When the replicated path reduces: "hooks" overlapped with backward (what
# every user gets); "buckets", the same buckets launched in step() and
# "grouped", one grouped all-reduce in step(), are the after-backward
# references the tests and chip_smoke.py hold the overlap against.
_SCHEDULES = ("hooks", "buckets", "grouped")


class DistributedOptimizer(torch.optim.Optimizer):
    """Wraps ``optimizer``; ``param_groups`` are the inner optimizer's own,
    so schedulers see through, and so are ``state`` and ``state_dict`` on
    the replicated paths. Under ZeRO ``state`` and ``state_dict()`` are the
    shard optimizer's (``optim/zero.py``; ``zero.state_to_global`` gathers
    the whole).

    ``axis_name`` (one mesh axis or a tuple, ``parallel/mesh.py``) reduces
    over this rank's line along those axes of the mesh current at
    construction, instead of the world (inside a ``wrap_step`` body None
    binds its axis);
    the training step reduces over ``("dp", "sp")``. ZeRO and error
    feedback shard over that line too."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 compression=None, zero=None, error_feedback=None,
                 fuse: Optional[bool] = None, axis_name=None, _schedule: str = "hooks"):
        _check_op(op)
        if _schedule not in _SCHEDULES:
            raise ValueError(f"_schedule must be one of {_SCHEDULES}, got {_schedule!r}")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        zero = env.zero_sharding_default() if zero is None else int(zero)
        if zero not in (0, 1, 2):
            raise ValueError(f"zero stage must be 0, 1 or 2, got {zero!r}")
        error_feedback = bool(error_feedback)
        if (zero or error_feedback) and compression is not None:
            raise ValueError("compression= does not combine with zero= or "
                             "error_feedback=: their wire cast is "
                             "HOROVOD_WIRE_COMPRESSION")
        # No Optimizer.__init__: the wrapper owns no parameters of its own.
        self._inner = optimizer
        self.axis_name = axis_name
        self._mesh = current_mesh() if axis_name is not None else None
        self.op = op
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.compression = compression
        # Sum, mean, min, max and product keep their buckets; Adasum combines
        # each gradient apart, as the JAX default does.
        self.fuse = op != ReduceOp.ADASUM if fuse is None else bool(fuse)
        self.backward_passes_per_step = backward_passes_per_step
        self._passes = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}
        self._synchronized = False
        self._signature_checked = False
        # ZeRO and error feedback shard over the line of axis_name, or the
        # world (resolved after their own argument checks).
        line = self._comm() if axis_name is not None else None
        self._zero = (zero_mod.ZeroSharder(optimizer, zero, error_feedback, op,
                                           prescale_factor, postscale_factor, line)
                      if zero else None)
        self._ef = (zero_mod.EFReducer(optimizer, op, prescale_factor, postscale_factor,
                                       line)
                    if error_feedback and not zero else None)
        self._presummed = {p for p in self._params() if getattr(p, "fsdp", None) is not None}
        if self._presummed:
            self._check_presummed(self._comm())
        self._buckets: Optional[List[_Bucket]] = None
        self._hooks = []
        if (_schedule != "grouped" and not zero and not error_feedback
                and op != ReduceOp.ADASUM):
            self._build_buckets(hooks=_schedule == "hooks")

    # The inner optimizer's groups, state and defaults, shared not copied.
    @property
    def param_groups(self):
        return self._inner.param_groups

    @property
    def state(self):
        return self._zero.inner.state if self._zero else self._inner.state

    @property
    def defaults(self):
        return self._inner.defaults

    def state_dict(self):
        return self._zero.state_dict() if self._zero else self._inner.state_dict()

    def load_state_dict(self, state_dict):
        if self._zero:
            self._zero.load_state_dict(state_dict)
        else:
            self._inner.load_state_dict(state_dict)

    def shard_state(self) -> dict:
        """Under ZeRO, this rank's shard of the state (``optim/zero.py``)."""
        return self._require_zero().shard_state()

    def load_shard_state(self, state: dict) -> None:
        self._require_zero().load_shard_state(state)

    def _require_zero(self):
        if self._zero is None:
            raise ValueError("the optimizer state is not sharded (zero=0)")
        return self._zero

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds: the moments (per
        parameter element on the replicated paths, per shard element under
        ZeRO) and the error-feedback residual."""
        if self._zero:
            return self._zero.state_bytes()["sharded_state_bytes"]
        held = sum(t.numel() * t.element_size()
                   for g in self.param_groups for p in g["params"]
                   for t in self._inner.state.get(p, {}).values()
                   if torch.is_tensor(t) and t.shape == p.shape and t.dim() > 0)
        if self._ef:
            held += sum(r.numel() * r.element_size() for r in self._ef.residuals)
        return held

    def zero_grad(self, set_to_none: bool = True):
        self._inner.zero_grad(set_to_none=set_to_none)

    def __repr__(self):
        return f"DistributedOptimizer({self._inner!r}, op={self.op.name})"

    def __del__(self):
        for h in getattr(self, "_hooks", ()):
            h.remove()

    def _params(self) -> List[torch.Tensor]:
        seen, out = set(), []
        for g in self.param_groups:
            for p in g["params"]:
                if p.requires_grad and id(p) not in seen:
                    seen.add(id(p))
                    out.append(p)
        return out

    def _reduced(self) -> List[torch.Tensor]:
        """The parameters whose gradients this optimizer reduces."""
        return [p for p in self._params() if p not in self._presummed]

    # -- parameters whose gradients backward already summed (FSDP) -----------
    def _check_presummed(self, comm: Comm) -> None:
        if self.op not in (ReduceOp.SUM, ReduceOp.AVERAGE) or self.compression is not None:
            raise ValueError("parameters cut over dp (FSDP_RULES) have their gradients "
                             "reduce-scattered in backward: the op must be SUM or AVERAGE, "
                             "with no compression")
        if self.backward_passes_per_step > 1:
            raise NotImplementedError(
                "backward_passes_per_step > 1 with parameters cut over dp is not ported "
                "(ROADMAP A3: FSDP with sp, ep, pp, MoE, gradient accumulation "
                "or the BERT encoder)")
        for p in self._presummed:
            if p.fsdp.comm.ranks != comm.ranks:
                raise ValueError(
                    f"a parameter cut over dp has its gradient summed over ranks "
                    f"{p.fsdp.comm.ranks} in backward; the optimizer reduces over "
                    f"{comm.ranks}: pass the model's dp line as axis_name")

    @torch.no_grad()
    def _scale_presummed(self) -> None:
        """The op's scale and the pre- and postscale on the summed gradients
        (zeros for a parameter without one)."""
        factor = self.prescale_factor * self.postscale_factor
        if self.op == ReduceOp.AVERAGE:
            factor /= self._comm().size
        for p in self._presummed:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif factor != 1.0:
                p.grad.mul_(factor)

    def _comm(self) -> Comm:
        if self._mesh is not None:
            return self._mesh.comm(self.axis_name)
        return resolve_comm(self.axis_name)

    def _check_signature(self, dtype: torch.dtype, sizes: List[int]) -> None:
        """Once, on the first reduction (``_check_grad_signature``)."""
        if not self._signature_checked:
            _check_grad_signature("DistributedOptimizer", dtype, sizes, self.op,
                                  self.prescale_factor, self.postscale_factor,
                                  self._comm())
            self._signature_checked = True

    # -- the overlapped path -------------------------------------------------
    def _build_buckets(self, hooks: bool) -> None:
        comp = self.compression or Compression.none
        threshold = env.fusion_threshold_bytes() if self.fuse else 0
        self._buckets, self._slot = [], {}
        for p in reversed(self._reduced()):
            dt = comp.compress(torch.empty(0, dtype=p.dtype, device=p.device))[0].dtype
            last = self._buckets[-1] if self._buckets else None
            if (last is None or last.dtype != dt
                    or (last.numel + p.numel()) * last.itemsize > threshold):
                last = _Bucket(dt)
                self._buckets.append(last)
            self._slot[p] = (len(self._buckets) - 1, len(last.params))
            last.add(p)
        self._reset_buckets()
        if hooks:
            ref = weakref.ref(self)
            self._hooks = [p.register_post_accumulate_grad_hook(_hook(ref))
                           for p in self._reduced()]

    def _check_bucket_signature(self) -> None:
        # Before the first bucket launches: every rank fires its first hook.
        if not self._signature_checked and self._buckets:
            self._check_signature(self._buckets[0].dtype,
                                  [p.numel() for b in self._buckets for p in b.params])

    def _reset_buckets(self) -> None:
        for b in self._buckets:
            b.pending, b.launched = len(b.params), None
            b.parts = [None] * len(b.params)
        self._ctx: Dict[torch.Tensor, object] = {}
        self._filled = set()
        self._next_launch = 0

    def _on_grad(self, p: torch.Tensor) -> None:
        """A gradient landed: accumulate it, or (on the pass that reduces)
        put it into its bucket and launch what is ready."""
        self._check_bucket_signature()
        if p in self._filled:
            raise RuntimeError(
                "a gradient was produced twice in one backward pass before "
                "step(); call step() after every backward pass")
        self._filled.add(p)
        g = p.grad
        k = self.backward_passes_per_step
        if k > 1:
            acc = self._acc.get(p)
            if acc is None:
                self._acc[p] = acc = g.detach().clone()
            else:
                acc.add_(g)
            if self._passes < k - 1:
                return
            g = self._acc.pop(p).div_(k)
        self._fill(p, g)

    def _fill(self, p: torch.Tensor, g: Optional[torch.Tensor]) -> None:
        """Hold ``p``'s gradient (zeros for none) in its bucket; once a
        bucket and every one before it are whole, pack and launch them."""
        b_idx, i = self._slot[p]
        bucket = self._buckets[b_idx]
        if g is None:
            g = torch.zeros_like(p)
        bucket.parts[i], self._ctx[p] = (self.compression or Compression.none).compress(g)
        bucket.pending -= 1
        while (self._next_launch < len(self._buckets)
               and self._buckets[self._next_launch].pending == 0):
            b = self._buckets[self._next_launch]
            with ops.span("hvd.flatten"):
                buf = b.flatten()
            b.launched = ops._reduce_launch(ops._scale(buf, self.prescale_factor),
                                            self.op, self.postscale_factor, b.dtype, True,
                                            self._comm())
            self._next_launch += 1

    @torch.no_grad()
    def _finish_overlap(self) -> bool:
        """Fill what the hooks did not, wait for every bucket and write the
        reduced gradients; False on a pass that only accumulates."""
        for p in self._reduced():
            if p not in self._filled and p.grad is not None:
                self._on_grad(p)
        if self._passes < self.backward_passes_per_step - 1:
            self._passes += 1
            self._filled = set()
            return False
        self._scale_presummed()
        self._check_bucket_signature()
        for p in self._reduced():
            if p not in self._filled:
                acc = self._acc.pop(p, None)
                self._filled.add(p)
                self._fill(p, None if acc is None else acc.div_(self.backward_passes_per_step))
        comp = self.compression or Compression.none
        for b in self._buckets:
            work, finish = b.launched
            if work is not None:
                work.wait()
            with ops.span("hvd.unflatten"):
                dst, src = [], []
                for p, part in zip(b.params, torch.split(finish(), b.sizes)):
                    val = comp.decompress(part.view(p.shape), self._ctx[p])
                    if p.grad is None:
                        p.grad = val.to(p.dtype, copy=True)
                    else:
                        dst.append(p.grad)
                        src.append(val)
                if dst:
                    torch._foreach_copy_(dst, src)
        self._passes = 0
        self._reset_buckets()
        return True

    # -- the step ------------------------------------------------------------
    def _accumulate(self) -> bool:
        """The after-backward paths' MultiSteps: False on a pass that only
        accumulates, else the running mean is in ``.grad``."""
        k = self.backward_passes_per_step
        if k == 1:
            return True
        self._passes += 1
        for p in self._params():
            if p.grad is None:
                continue
            acc = self._acc.get(p)
            if acc is None:
                self._acc[p] = p.grad.detach().clone()
            else:
                acc.add_(p.grad)
        if self._passes % k:
            return False
        for p, acc in self._acc.items():
            p.grad = acc.div_(k)
        self._acc = {}
        return True

    @torch.no_grad()
    def _reduce(self) -> None:
        """All-reduce every gradient after backward (zeros for a parameter
        without one) into ``.grad``."""
        if self._ef:
            self._ef.synchronize()
            return
        self._scale_presummed()
        params = self._reduced()
        if not params:
            return
        grads = zero_mod._grads(params)
        self._check_signature(_widest(grads), [g.numel() for g in grads])
        reduced = _allreduce_grads(grads, self.op, self.prescale_factor,
                                   self.postscale_factor, self.compression, self.fuse,
                                   self._comm())
        with ops.span("hvd.unflatten"):
            for p, r in zip(params, reduced):
                if p.grad is None:
                    p.grad = r.to(p.dtype, copy=True)
                else:
                    p.grad.copy_(r)

    @comm_failures_raise_internal
    def synchronize(self) -> None:
        """Reduce the gradients now; the next ``step()`` only steps the
        inner optimizer (ref: horovod/torch/optimizer.py synchronize)."""
        if self._zero:
            raise ValueError("under ZeRO the reduction is part of step()")
        if self._buckets is not None:
            done = self._finish_overlap()
        else:
            done = self._accumulate()
            if done:
                self._reduce()
        self._synchronized = done or None

    @comm_failures_raise_internal
    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("step(closure) is not supported")
        if self._synchronized is None:     # synchronize() saw a pass that accumulates
            self._synchronized = False
            return None
        if not self._synchronized:
            if self._zero:
                if not self._accumulate():
                    return None
                if not self._signature_checked:
                    self._check_signature(torch.float32,
                                          [g.total for g in self._zero.groups])
                return self._zero.step()
            if self._buckets is not None:
                if not self._finish_overlap():
                    return None
            else:
                if not self._accumulate():
                    return None
                self._reduce()
        self._synchronized = False
        return self._inner.step()


# ---------------------------------------------------------------------------
# The functional spelling: gradients of fun(params, *args) with respect to a
# dict of tensors, the torch form of jax.value_and_grad.
def _value_and_grad(fun: Callable, has_aux: bool, params: Mapping[str, torch.Tensor],
                    *args, **kwargs):
    """``fun(params, *args, **kwargs)`` and its gradients with respect to
    ``params``, a dict of name -> tensor (a model's ``named_parameters`` or
    ``state_dict``, fed to ``torch.func.functional_call`` inside ``fun``).
    The value (and aux) come back detached, the gradients as a dict of the
    same keys; a tensor the value does not depend on gets zeros."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        out = fun(leaves, *args, **kwargs)
        value, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(value, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    value = value.detach()
    return ((value, aux) if has_aux else value), grads


class _GradReducer:
    """The all-reduce of a gradient transform. The ranks' signatures
    (count, sizes, op) are checked on the first call and again only when
    this rank's changes, so a steady training loop pays no host read."""

    def __init__(self, label: str, op: ReduceOp, compression, fuse: bool, axis_name):
        self.mesh = None
        if axis_name is not None:
            resolve_comm(axis_name)    # no mesh, or an axis not in it, raises here
            self.mesh = current_mesh()
        self.label, self.op, self.compression, self.fuse = label, op, compression, fuse
        self.axis_name = axis_name
        self.checked = None

    def __call__(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        vals = list(grads.values())
        if not vals:
            return {}
        comm = (self.mesh.comm(self.axis_name) if self.mesh is not None
                else resolve_comm(self.axis_name))
        sig = (_widest(vals), [g.numel() for g in vals], comm.ranks)
        if sig != self.checked:
            _check_grad_signature(self.label, *sig[:2], self.op, comm=comm)
            self.checked = sig
        red = _allreduce_grads(vals, self.op, 1.0, 1.0, self.compression, self.fuse, comm)
        return dict(zip(grads, red))


class DistributedGradientTape:
    """TF's DistributedGradientTape in the JAX package's shape
    (ref: horovod/tensorflow/__init__.py:507-572): ``gradient(params,
    *args)`` returns ``fun``'s value and its gradients with respect to
    ``params``, each gradient all-reduced on its own (no fusion)."""

    def __init__(self, fun: Callable, op: ReduceOp = ReduceOp.AVERAGE,
                 compression=None, axis_name: Optional[str] = None,
                 has_aux: bool = False):
        _check_op(op)
        self._fun = fun
        self._has_aux = has_aux
        self._reduce = _GradReducer("DistributedGradientTape", op, compression, False,
                                    axis_name)

    def gradient(self, *args, **kwargs):
        val, grads = _value_and_grad(self._fun, self._has_aux, *args, **kwargs)
        return val, self._reduce(grads)


def distributed_value_and_grad(fun: Callable, op: ReduceOp = ReduceOp.AVERAGE,
                               axis_name: Optional[str] = None,
                               has_aux: bool = False, fuse: bool = True,
                               compression=None) -> Callable:
    """``jax.value_and_grad`` plus the gradient all-reduce in one transform:
    the returned function takes ``(params, *args)`` and returns
    ``(value, grads)``, the gradients all-reduced in one grouped collective
    when ``fuse`` is set, else one each."""
    _check_op(op)
    reduce = _GradReducer("distributed_value_and_grad", op, compression, fuse, axis_name)

    def wrapped(*args, **kwargs):
        val, grads = _value_and_grad(fun, has_aux, *args, **kwargs)
        return val, reduce(grads)

    return wrapped
