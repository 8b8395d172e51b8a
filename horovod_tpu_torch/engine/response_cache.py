"""Response cache: skip re-negotiation for steady-state tensors
(counterpart of ``horovod_tpu/engine/response_cache.py``).

The reference's bit-vector response cache
(ref: horovod/common/response_cache.{h,cc}:44-167). Each cached Response
gets a stable cache bit; each cycle, ranks AND their hit bit-vectors (so a
tensor short-circuits negotiation only when *every* rank has it queued and
cached) and OR their invalid bits. Capacity default 1024
(ref: global_state.h:88), LRU eviction. The cached object is the whole
negotiated Response, so its channel and wire codec replay with it on every
rank. Hits, misses and invalidations are the JAX package's telemetry
counters (``horovod_response_cache_*_total``).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Set, Tuple

from ..common import telemetry
from ..common.message import Request, Response


def _request_key(req: Request) -> Tuple:
    return (
        req.tensor_name,
        int(req.request_type),
        int(req.tensor_type),
        tuple(req.tensor_shape),
        req.root_rank,
        req.prescale_factor,
        req.postscale_factor,
        req.reduce_op,
    )


class CacheState:
    MISS = 0
    HIT = 1
    INVALID = 2


class ResponseCache:
    def __init__(self, capacity: int = 1024, registry=None):
        if registry is None:
            registry = telemetry.default_registry()
        self._m_hits = registry.counter(
            "horovod_response_cache_hits_total",
            "Negotiations short-circuited by the response cache")
        self._m_misses = registry.counter(
            "horovod_response_cache_misses_total",
            "Requests with no usable cache entry")
        self._m_invalid = registry.counter(
            "horovod_response_cache_invalidations_total",
            "Cache entries dropped because the request signature changed")
        self.capacity = capacity
        # name -> (bit, key, response)
        self._by_name: Dict[str, Tuple[int, Tuple, Response]] = {}
        self._by_bit: Dict[int, str] = {}
        self._lru = collections.OrderedDict()  # name -> None, most recent last
        self._next_bit = 0
        self._free_bits: List[int] = []

    def cached(self, req: Request) -> int:
        ent = self._by_name.get(req.tensor_name)
        if ent is None:
            self._m_misses.inc()
            return CacheState.MISS
        bit, key, _ = ent
        if key == _request_key(req):
            # NOT counted as a hit yet: the cross-rank AND pass may still
            # requeue this request into full negotiation (peers not
            # ready). The controller calls count_hit() only when the
            # cached response is actually emitted, so the hit rate
            # measures fast-path responses served, not optimistic local
            # lookups.
            return CacheState.HIT
        self._m_invalid.inc()
        return CacheState.INVALID

    def count_hit(self):
        """One response actually served from the cache fast path."""
        self._m_hits.inc()

    def put(self, req: Request, resp: Response):
        if req.tensor_name in self._by_name:
            bit = self._by_name[req.tensor_name][0]
        elif self._free_bits:
            bit = self._free_bits.pop()
        elif len(self._by_name) < self.capacity:
            bit = self._next_bit
            self._next_bit += 1
        else:
            evict_name, _ = self._lru.popitem(last=False)
            bit = self._by_name.pop(evict_name)[0]
            self._by_bit.pop(bit, None)
        self._by_name[req.tensor_name] = (bit, _request_key(req), resp)
        self._by_bit[bit] = req.tensor_name
        self._lru.pop(req.tensor_name, None)
        self._lru[req.tensor_name] = None

    def has_bit(self, bit: int) -> bool:
        return bit in self._by_bit

    def peek_bit(self, name: str) -> Optional[int]:
        ent = self._by_name.get(name)
        return ent[0] if ent else None

    def get_response_by_bit(self, bit: int) -> Response:
        name = self._by_bit[bit]
        self._lru.pop(name, None)
        self._lru[name] = None
        return self._by_name[name][2]

    def erase(self, name: str):
        ent = self._by_name.pop(name, None)
        if ent:
            self._by_bit.pop(ent[0], None)
            self._free_bits.append(ent[0])
            self._lru.pop(name, None)

    def erase_bit(self, bit: int):
        name = self._by_bit.get(bit)
        if name is not None:
            self.erase(name)

    def bits_to_vector(self, bits: Set[int], nwords: int) -> List[int]:
        """Pack bit set into 64-bit words (ref: response_cache.h bitvector
        layout — 2 words per 64 entries)."""
        words = [0] * nwords
        for b in bits:
            words[b // 64] |= 1 << (b % 64)
        return words

    @staticmethod
    def vector_to_bits(words: List[int]) -> Set[int]:
        out = set()
        for wi, w in enumerate(words):
            while w:
                low = w & -w
                out.add(wi * 64 + low.bit_length() - 1)
                w ^= low
        return out

    def num_bits(self) -> int:
        return self._next_bit
