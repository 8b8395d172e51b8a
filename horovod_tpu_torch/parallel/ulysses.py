"""Ulysses sequence parallelism: the all-to-all head/sequence exchange
(counterpart of ``horovod_tpu/parallel/ulysses.py``).

q/k/v arrive sharded on the sequence dim; one all-to-all re-shards them on
the head dim with the whole sequence local, attention runs per head group,
and a second all-to-all restores sequence sharding. With ``use_flash`` the
per-head-group attention is the port's ``flash_attention`` (the CUDA
kernels K1 and K2 on the card, their plain version on the CPU): after the
exchange the (B, S, H/n, D) blocks are contiguous, the layout the kernels'
tensor maps read.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import flash_attention
from .collectives import all_gather, all_to_all, as_comm
from .ring import dense_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_name,
                      causal: bool = True, mask: Optional[torch.Tensor] = None,
                      use_flash: bool = False) -> torch.Tensor:
    """q/k/v: local blocks (B, S/n, H, D), H divisible by the line's size n.
    Returns (B, S/n, H, D). ``mask`` is this member's (B, S/n) key-validity
    block; the head-sharded attention needs the whole sequence's, so it is
    all-gathered along the line."""
    comm = as_comm(axis_name)
    n = comm.size
    H = q.shape[2]
    if H % n != 0:
        raise ValueError(f"n_heads={H} must be divisible by sp={n}")

    def seq_to_heads(x):
        # (B, S/n, H, D) -> (B, S, H/n, D): split heads, gather sequence.
        return all_to_all(x, comm, split_dim=2, concat_dim=1, name="hvd.sp.all_to_all")

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    full_mask = None
    if mask is not None:
        full_mask = all_gather(mask.detach(), comm, dim=1, name="hvd.sp.all_gather")
    if use_flash:
        out = flash_attention(qh, kh, vh, full_mask, causal=causal)
    else:
        out = dense_attention(qh, kh, vh, causal=causal, mask=full_mask)
    return all_to_all(out, comm, split_dim=1, concat_dim=2, name="hvd.sp.all_to_all")
