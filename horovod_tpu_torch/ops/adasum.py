"""Adasum: the scaling-insensitive combination of the ranks' gradients
(counterpart of ``horovod_tpu/ops/adasum.py``; ref:
horovod/common/ops/adasum/adasum.h:100-280).

Each of log2(n) rounds exchanges the rank's current vector with its XOR
partner (``dist.batch_isend_irecv``, one send and one receive) and both
partners apply the pair combination

    result = (1 - dot/(2·|a|²))·a + (1 - dot/(2·|b|²))·b

with the lower rank's vector as ``a``, so both compute bitwise the same
value; after the last round every rank holds the same result. dot and the
squared norms accumulate in f32 (the reference uses f64; the JAX package
f32 at HIGHEST precision). A zero norm skips its projection term, as the
reference does. The world must be a power of two
(ref: horovod/torch/mpi_ops.py:93-113). ``adasum_numpy`` is the same
recursion in f64 numpy, the tests' oracle.

With ``sizes`` the vector is a grouped buffer of tensors of those sizes,
and each tensor's range takes its own dot, norms and coefficients, as
Horovod's fused Adasum keeps per-tensor counts (ref: adasum.h:166-280):
the result is each tensor combined on its own, at one exchange a round
for the whole buffer.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common import basics


def _coefficients(dot, na, nb):
    one = torch.ones((), dtype=torch.float32, device=dot.device)
    ca = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, one)), one)
    cb = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, one)), one)
    return ca, cb


def _combine(a: torch.Tensor, b: torch.Tensor,
             sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The pair combination (ref: adasum.h:100-140), over the whole vector
    or, with ``sizes``, over each of its ranges apart."""
    af = a.reshape(-1).to(torch.float32)
    bf = b.reshape(-1).to(torch.float32)
    if sizes is None:
        ca, cb = _coefficients(torch.dot(af, bf), torch.dot(af, af), torch.dot(bf, bf))
        return (ca * af + cb * bf).reshape(a.shape).to(a.dtype)
    pa, pb = af.split(sizes), bf.split(sizes)
    ca, cb = _coefficients(*(torch.stack([torch.dot(x, y) for x, y in pairs])
                             for pairs in (zip(pa, pb), zip(pa, pa), zip(pb, pb))))
    out = torch.empty_like(af)
    for o, x, y, c1, c2 in zip(out.split(sizes), pa, pb, ca.unbind(), cb.unbind()):
        torch.mul(x, c1, out=o).addcmul_(y, c2)
    return out.reshape(a.shape).to(a.dtype)


def adasum_allreduce(tensor: torch.Tensor, comm=None,
                     sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Adasum of the ranks' ``tensor`` over the world (the dp group), or
    over the members of ``comm`` (``parallel/mesh.py``); their number must
    be a power of two. With ``sizes`` (summing to its numel) each range of
    the flat tensor is combined on its own. Returns a new tensor."""
    if comm is None:
        n, r, ranks = basics.size(), basics.rank(), None
    else:
        n, r, ranks = comm.size, comm.rank, comm.ranks
    if n & (n - 1):
        raise ValueError(f"Adasum requires a power-of-2 world size, got {n} "
                         "(ref: horovod/torch/mpi_ops.py:93-113)")
    if not tensor.is_floating_point():
        raise TypeError(f"Adasum combines floating tensors, got {tensor.dtype}")
    if sizes is not None:
        sizes = [int(n) for n in sizes]
        if sum(sizes) != tensor.numel():
            raise ValueError(f"sizes {sizes} do not sum to the tensor's {tensor.numel()} "
                             "elements")
    group = None if comm is None else comm.group
    x = tensor.contiguous()
    for k in range(int(math.log2(n))):
        stride = 1 << k
        peer = r ^ stride if ranks is None else ranks[r ^ stride]
        recv = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer, group),
                                           dist.P2POp(dist.irecv, recv, peer, group)]):
            req.wait()
        x = _combine(x, recv, sizes) if r & stride == 0 else _combine(recv, x, sizes)
    return x.clone() if x is tensor else x


def adasum_numpy(tensors):
    """The same recursion over a list of per-rank arrays, in f64; returns
    each rank's result in its input's dtype."""
    n = len(tensors)
    if n & (n - 1):
        raise ValueError("power-of-2 ranks required")
    vals = [np.asarray(t, dtype=np.float64) for t in tensors]
    for k in range(int(math.log2(n))):
        stride = 1 << k
        new = [None] * n
        for i in range(n):
            j = i ^ stride
            a, b = (vals[i], vals[j]) if (i & stride) == 0 else (vals[j], vals[i])
            af, bf = a.ravel(), b.ravel()
            dot, na, nb = float(af @ bf), float(af @ af), float(bf @ bf)
            ca = 1.0 - dot / (2.0 * na) if na > 0 else 1.0
            cb = 1.0 - dot / (2.0 * nb) if nb > 0 else 1.0
            new[i] = ca * a + cb * b
        vals = new
    return [v.astype(np.asarray(t).dtype) for v, t in zip(vals, tensors)]
