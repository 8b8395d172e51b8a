"""Ring attention: blockwise context parallelism over the sp mesh axis
(counterpart of ``horovod_tpu/parallel/ring.py``).

The sequence is sharded across the line's n members; K/V blocks (and the
key mask with them) rotate around the ring by ``ppermute`` while each
member folds them into a streaming-softmax state (o, m, l), step for step
as the JAX function: global query and key positions, explicit zeroing of
invalid probabilities, and the ``1e-30`` clamp on the normaliser. It runs
no kernel, as in JAX (plain einsums). Differentiable: autograd runs through
the ``ppermute`` of ``parallel/collectives.py``, whose backward is the
inverse rotation. Each block update is recomputed in the backward rather
than saved (``torch.utils.checkpoint``), so a layer keeps n copies of the
(o, m, l) state and of the K/V blocks for its backward instead of n
(B, H, S/n, S/n) score and probability blocks; the result is the same.
The last rotation, whose blocks JAX's scan carries out and drops, is not
sent.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .collectives import as_comm, ppermute

NEG_INF = -1e30


def _flash_block_update(o, m, l, q, k, v, qpos, kpos, scale: float, causal: bool,
                        kmask: Optional[torch.Tensor] = None):
    """Fold one K/V block into the streaming-softmax state.

    o: (B, Sq, H, D) f32 accumulated (unnormalised) output; m, l: (B, H, Sq)
    f32 running max and normaliser; kmask: optional (B, Sk) key validity
    (1 = attend). Invalid probabilities are zeroed, not just pushed to
    -1e30 in the scores, so an all-padding block leaves the state exact."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    valid = None
    if causal:
        valid = (kpos[None, :] <= qpos[:, None])[None, None]    # (1, 1, Sq, Sk)
    if kmask is not None:
        km = kmask.bool()[:, None, None, :]                     # (B, 1, 1, Sk)
        valid = km if valid is None else valid & km
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    m_blk = s.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    p = torch.exp(s - m_new[..., None])
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name,
                   causal: bool = True, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over the global sequence with q/k/v sharded on dim 1 across
    the line ``axis_name`` names (an axis, a tuple of axes or a ``Comm``).
    Returns the local output block (B, S/n, H, D) in q.dtype. ``mask`` is
    this member's (B, S/n) key-validity block, 1 = attend; it rotates with
    its K/V block. Fully padded query rows give zeros."""
    comm = as_comm(axis_name)
    n, idx = comm.size, comm.rank
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qpos = idx * Sq + torch.arange(Sq, device=dev)
    o = torch.zeros(B, Sq, H, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, Sq, dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    km = None if mask is None else mask.float()
    for t in range(n):
        # After t rotations this member holds the block that started at
        # member (idx - t) mod n.
        src = (idx - t) % n
        kpos = src * Sk + torch.arange(Sk, device=dev)
        if torch.is_grad_enabled():
            o, m, l = checkpoint(_flash_block_update, o, m, l, q, k, v, qpos, kpos, scale,
                                 causal, km, use_reentrant=False)
        else:
            o, m, l = _flash_block_update(o, m, l, q, k, v, qpos, kpos, scale, causal, km)
        if t + 1 < n:
            k = ppermute(k, comm, perm, name="hvd.sp.ppermute")
            v = ppermute(v, comm, perm, name="hvd.sp.ppermute")
            if km is not None:
                km = ppermute(km, comm, perm, name="hvd.sp.ppermute")
    l_safe = l.clamp_min(1e-30)
    out = o / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def dense_attention(q, k, v, causal: bool = True,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-device reference attention (same layout, no sharding), step
    for step as the JAX function: scores in q.dtype then f32, softmax in
    f32, masked probabilities zeroed so fully masked rows give 0."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    valid = None
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        valid = (torch.arange(Sk, device=q.device)[None, :]
                 <= torch.arange(Sq, device=q.device)[:, None])[None, None]
    if mask is not None:
        km = mask.bool()[:, None, None, :]
        valid = km if valid is None else valid & km
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype)).to(q.dtype)
