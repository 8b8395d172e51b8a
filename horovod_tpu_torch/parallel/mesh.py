"""The device mesh (counterpart of ``horovod_tpu/parallel/mesh.py``).

One rank per card; the mesh names the world's ranks along the JAX
package's axes, outer to inner (``AXIS_ORDER``):

    pp   pipeline stages        (GPipe, ``parallel/pipeline.py``,
                                 ``models/pipelined.py``)
    dp   data parallel          (gradient all-reduce)
    ep   expert parallel        (Switch-MoE experts, ``models/transformer.py``)
    sp   sequence parallel      (ring and Ulysses attention, ``parallel/ring.py``,
                                 ``parallel/ulysses.py``)
    tp   tensor parallel        (column- and row-parallel layers, the vocab-
                                 parallel embedding, head and cross-entropy,
                                 ``parallel/tensor.py``)

A rank's coordinates are its index unravelled row-major over the axes in
that order, the layout ``np.asarray(devices).reshape(shape)`` gives the
JAX mesh, so port rank i holds the shard of JAX device i; tp is the
innermost axis, so consecutive ranks form a tp line. A *line* along
one axis, or along a tuple of axes, is the set of ranks that differ only
in those coordinates; ``Mesh.comm(axes)`` gives this rank's line as a
``Comm`` (the process group, its size, this rank's index in it, and the
members' global ranks in line order). Every line's group is created at
``create_mesh``, by every rank, in the same order, since
``torch.distributed.new_group`` is collective; a line of one rank has no
group and its collectives are identities. The most recently created mesh
is the *current* one, against which ``axis_name=`` resolves in
``horovod_tpu_torch.ops`` and the optimizers.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..common import basics

# Canonical axis order, outer -> inner, as in the JAX package.
AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class Comm:
    """A communicator: ``group`` is None for the world's default group (and
    for a line of one rank, which needs none); ``rank`` is this rank's
    index in ``ranks``, the members' global ranks in line order."""

    group: Optional[object]
    size: int
    rank: int
    ranks: Tuple[int, ...]
    world: bool = False

    @property
    def trivial(self) -> bool:
        """One member that is not the whole world: no collective to run."""
        return self.size == 1 and not self.world


def world_comm() -> Comm:
    n = basics.size()
    return Comm(None, n, basics.rank(), tuple(range(n)), world=True)


def _factor_devices(n: int, requested: Dict[str, int]) -> Dict[str, int]:
    """Fill in a -1 entry so the product of axis sizes equals n (the JAX
    function, line for line)."""
    sizes = dict(requested)
    known = 1
    free = [a for a, s in sizes.items() if s == -1]
    for a, s in sizes.items():
        if s != -1:
            known *= s
    if n % known != 0:
        raise ValueError(f"mesh axes {sizes} do not divide device count {n}")
    rest = n // known
    if not free:
        if known != n:
            raise ValueError(f"mesh axes {sizes} do not cover device count {n}")
        return sizes
    if len(free) == 1:
        sizes[free[0]] = rest
        return sizes
    raise ValueError("at most one axis size may be -1")


def axis_names_in_order(names) -> Tuple[str, ...]:
    """Known axes in ``AXIS_ORDER``, unknown ones after them in their given
    order, as the JAX ``create_mesh`` sorts them."""
    return tuple(sorted(names, key=lambda a: AXIS_ORDER.index(a)
                        if a in AXIS_ORDER else len(AXIS_ORDER)))


def coords_of(rank: int, names: Sequence[str], shape: Dict[str, int]) -> Dict[str, int]:
    """``rank`` unravelled row-major over ``names``."""
    out = {}
    for a in reversed(names):
        out[a] = rank % shape[a]
        rank //= shape[a]
    return {a: out[a] for a in names}


def rank_of(coords: Dict[str, int], names: Sequence[str], shape: Dict[str, int]) -> int:
    r = 0
    for a in names:
        r = r * shape[a] + coords[a]
    return r


def line_ranks(rank: int, axes: Sequence[str], names: Sequence[str],
               shape: Dict[str, int]) -> Tuple[int, ...]:
    """The global ranks of ``rank``'s line along ``axes``, in line order:
    row-major over ``axes`` taken in mesh order."""
    base = coords_of(rank, names, shape)
    axes = [a for a in names if a in axes]
    out = []
    for idx in itertools.product(*(range(shape[a]) for a in axes)):
        c = dict(base, **dict(zip(axes, idx)))
        out.append(rank_of(c, names, shape))
    return tuple(out)


def _axes_key(axes: Axes, names: Sequence[str]) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in names:
            raise ValueError(f"axis_name {axes!r}: axis {a!r} is not in the mesh "
                             f"{tuple(names)}")
    return tuple(a for a in names if a in axes)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names (in mesh order) and sizes, this rank's coordinates and
    device, and the communicators of its lines."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    _comms: Dict[Tuple[str, ...], Comm] = dataclasses.field(repr=False)

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def axis_size(self, axes: Axes) -> int:
        n = 1
        for a in _axes_key(axes, self.axis_names):
            n *= self.shape[a]
        return n

    def comm(self, axes: Axes) -> Comm:
        """This rank's line along ``axes`` (one axis name or a tuple; a
        ``Comm`` names itself)."""
        if isinstance(axes, Comm):
            return axes
        key = _axes_key(axes, self.axis_names)
        if not key:
            return Comm(None, 1, 0, (basics.rank(),))
        return self._comms[key]

    def axes_of(self, comm: Comm) -> Optional[Tuple[str, ...]]:
        """The axes of size above one along which ``comm`` is this rank's
        line; None for a communicator that is no line of the mesh."""
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        for k in range(len(live) + 1):
            for axes in itertools.combinations(live, k):
                if self.comm(axes).ranks == comm.ranks:
                    return axes
        return None

    def group(self, axes: Axes):
        """The process group of this rank's line along ``axes`` (None for
        the world's default group or a line of one rank)."""
        return self.comm(axes).group


_current: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The most recently created mesh, or None."""
    return _current


def create_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """Build the mesh over the initialised world and make it current. ``-1``
    fills one axis with whatever the world leaves; ``None`` means
    ``{"dp": size()}``. Collective: every rank calls it with the same
    sizes."""
    global _current
    n = basics.size()
    sizes = _factor_devices(n, dict(axis_sizes or {"dp": n}))
    names = axis_names_in_order(sizes)
    me = basics.rank()
    comms: Dict[Tuple[str, ...], Comm] = {}
    # Every subset of the axes, in one fixed order; lines over the same
    # non-trivial axes share one communicator.
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            live = tuple(a for a in axes if sizes[a] > 1)
            if live in comms:
                comms[axes] = comms[live]
                continue
            mine = line_ranks(me, axes, names, sizes)
            if len(mine) == n:
                comm = world_comm()
            elif len(mine) == 1:
                comm = Comm(None, 1, 0, mine)
            else:
                group = None
                seen = set()
                for r in range(n):   # every line's group, on every rank
                    members = line_ranks(r, axes, names, sizes)
                    if members in seen:
                        continue
                    seen.add(members)
                    g = dist.new_group(list(members))
                    if members == mine:
                        group = g
                comm = Comm(group, len(mine), mine.index(me), mine)
            comms[axes] = comm
            if live not in comms:
                comms[live] = comm
    mesh = Mesh(axis_names=names, shape=sizes, coords=coords_of(me, names, sizes),
                device=basics.device(), _comms=comms)
    _current = mesh
    return mesh


def create_hybrid_mesh(ici_axis_sizes: Dict[str, int],
                       dcn_axis_sizes: Dict[str, int]) -> Mesh:
    """The JAX function's merged fallback (``horovod_tpu/parallel/mesh.py:
    114-116``): each axis the product of its ICI and DCN sizes. NCCL picks
    its own paths between cards and hosts, so the split names nothing more."""
    names = axis_names_in_order(list(ici_axis_sizes) + list(dcn_axis_sizes))
    merged = {a: ici_axis_sizes.get(a, 1) * dcn_axis_sizes.get(a, 1) for a in names}
    return create_mesh(merged)


# The axis ``axis_name=None`` binds to inside a ``wrap_step`` body.
_default_axis: contextvars.ContextVar = contextvars.ContextVar(
    "horovod_tpu_torch_default_axis", default=None)


@contextlib.contextmanager
def default_axis(axis_name: Axes, mesh: Optional[Mesh] = None):
    """While the block runs, collectives and optimizers given no
    ``axis_name`` bind to ``axis_name`` on ``mesh`` (the current mesh by
    default)."""
    token = _default_axis.set((axis_name, mesh))
    try:
        yield
    finally:
        _default_axis.reset(token)


def resolve_comm(axis_name: Optional[Axes]) -> Comm:
    """The communicator ``axis_name`` names on the current mesh (a ``Comm``
    names itself). None is the axis of the enclosing ``default_axis`` block,
    else the world."""
    if isinstance(axis_name, Comm):
        return axis_name
    mesh = _current
    if axis_name is None:
        bound = _default_axis.get()
        if bound is None:
            return world_comm()
        axis_name, mesh = bound[0], bound[1] or _current
    if mesh is None:
        raise ValueError(f"axis_name={axis_name!r}: no mesh; call create_mesh first")
    return mesh.comm(axis_name)
