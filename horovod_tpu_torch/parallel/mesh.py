"""The device mesh (counterpart of ``horovod_tpu/parallel/mesh.py``).

The port has one axis so far: ``dp``, data parallel, one rank per card
over the world process group. The JAX package's pp/ep/sp/tp axes raise
``NotImplementedError`` until their slices are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..common import basics

# Canonical axis order, outer -> inner, as in the JAX package.
AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")
SUPPORTED_AXES = ("dp",)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, this rank's coordinates and its device. While
    dp is the only axis, its collectives run over the world group."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def create_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """Build the mesh over the initialised world; ``-1`` fills an axis with
    whatever the world leaves. ``None`` means ``{"dp": size()}``."""
    n = basics.size()
    sizes = dict(axis_sizes or {"dp": n})
    for ax in sizes:
        if ax not in SUPPORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {ax!r} is not ported yet (the port has {SUPPORTED_AXES})")
    if sizes["dp"] == -1:
        sizes["dp"] = n
    if sizes["dp"] != n:
        raise ValueError(f"mesh axes {sizes} do not cover a world of {n}")
    return Mesh(axis_names=("dp",), shape=sizes, coords={"dp": basics.rank()},
                device=basics.device())
