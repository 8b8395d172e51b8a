"""The engine's control-plane transport: the coordinator's gather and
broadcast of bytes, bitwise word all-reduces and a barrier, over a process
group of its own (counterpart of the ``ControllerTransport`` the JAX
package's TCP backend provides, ``horovod_tpu/engine/controller.py:89-111``).

The group is a gloo group on the CPU, made at ``hvd.init()`` beside the
world's default group, and used by the engine's background thread alone:
a process group must see its collectives in the same order on every rank,
and only that thread negotiates. Messages are a few hundred bytes; a
payload of unknown length travels as its length first, then the bytes.
``LocalTransport`` is a world of one: no group, no collective.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .controller import ControllerTransport

_MASK = (1 << 64) - 1


def _signed(word: int) -> int:
    word &= _MASK
    return word - (1 << 64) if word >> 63 else word


class LocalTransport(ControllerTransport):
    """A world of one (the JAX package's ``LocalBackend`` role)."""

    rank, size = 0, 1

    def gather_bytes(self, payload: bytes) -> Optional[List[bytes]]:
        return [payload]

    def bcast_bytes(self, payload: Optional[bytes]) -> bytes:
        return payload

    def allreduce_words(self, words: List[int], op: str) -> List[int]:
        return list(words)

    def barrier(self):
        pass


class GlooTransport(ControllerTransport):
    """The control plane over ``group``, a gloo group of the whole world."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def _lengths(self, n: int) -> List[int]:
        mine = torch.tensor([n], dtype=torch.int64)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        return [int(p) for p in parts]

    def gather_bytes(self, payload: bytes) -> Optional[List[bytes]]:
        lengths = self._lengths(len(payload))
        longest = max(lengths)
        buf = torch.zeros(longest, dtype=torch.uint8)
        if payload:
            buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        if self.rank == 0:
            parts = [torch.empty_like(buf) for _ in range(self.size)]
            dist.gather(buf, parts, dst=0, group=self.group)
            return [p[:n].numpy().tobytes() for p, n in zip(parts, lengths)]
        dist.gather(buf, None, dst=0, group=self.group)
        return None

    def bcast_bytes(self, payload: Optional[bytes]) -> bytes:
        n = torch.tensor([len(payload) if self.rank == 0 else 0], dtype=torch.int64)
        dist.broadcast(n, src=0, group=self.group)
        if self.rank == 0:
            buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8) if payload \
                else torch.empty(0, dtype=torch.uint8)
        else:
            buf = torch.empty(int(n), dtype=torch.uint8)
        if buf.numel():
            dist.broadcast(buf, src=0, group=self.group)
        return payload if self.rank == 0 else buf.numpy().tobytes()

    def allreduce_words(self, words: List[int], op: str) -> List[int]:
        red = {"and": dist.ReduceOp.BAND, "or": dist.ReduceOp.BOR}[op]
        t = torch.tensor([_signed(w) for w in words], dtype=torch.int64)
        dist.all_reduce(t, op=red, group=self.group)
        return [int(w) & _MASK for w in t.tolist()]

    def barrier(self):
        dist.barrier(group=self.group)
