"""Host parsing and rank/slot assignment (counterpart of
``horovod_tpu/runner/hosts.py``; ref: horovod/runner/common/util/
hosts.py:106-155 — hosts packed in order into SlotInfo{rank, local_rank,
cross_rank, sizes}).

The JAX package's ``discover_tpu_hosts`` has no counterpart: with no host
given, the launcher runs on ``localhost`` with one slot per card
(``default_hosts``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(host_string: str) -> "HostInfo":
        if ":" in host_string:
            hostname, slots = host_string.strip().rsplit(":", 1)
            return HostInfo(hostname, int(slots))
        return HostInfo(host_string.strip(), 1)


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_response_string(self) -> str:
        # The elastic rendezvous row (ref: runner/elastic/rendezvous.py:40-52).
        return ",".join(str(v) for v in (
            self.rank, self.size, self.local_rank, self.local_size,
            self.cross_rank, self.cross_size))


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """"h1:2,h2:4" -> [HostInfo]."""
    return [HostInfo.from_string(s) for s in hosts_string.split(",") if s]


def parse_hostfile(path: str) -> List[HostInfo]:
    """mpirun-style hostfile: ``host slots=N`` or ``host:N`` a line."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "slots=" in line:
                name, _, slots = line.partition("slots=")
                out.append(HostInfo(name.strip(), int(slots)))
            else:
                out.append(HostInfo.from_string(line))
    return out


def default_hosts(np_: Optional[int] = None) -> List[HostInfo]:
    """``localhost`` with ``np_`` slots, or one a card when ``np_`` is None
    (at least one: a CPU-only host runs one process)."""
    if np_ is None:
        import torch

        np_ = max(torch.cuda.device_count(), 1)
    return [HostInfo("localhost", np_)]


def get_host_assignments(
    hosts: List[HostInfo], min_np: int, max_np: Optional[int] = None
) -> List[SlotInfo]:
    """Pack hosts in order into global/local/cross ranks (ref:
    hosts.py:106-155). Raises if fewer than min_np slots exist; stops at
    max_np slots when given."""
    rank = 0
    assignments: List[List[SlotInfo]] = []
    for host in hosts:
        local: List[SlotInfo] = []
        for local_rank in range(host.slots):
            if max_np is not None and rank >= max_np:
                break
            local.append(SlotInfo(hostname=host.hostname, rank=rank,
                                  local_rank=local_rank,
                                  cross_rank=len(assignments), size=0,
                                  local_size=0, cross_size=0))
            rank += 1
        if local:
            assignments.append(local)
    world = rank
    if world < min_np:
        raise ValueError(
            f"requested {min_np} processes but hosts provide only {world} "
            f"slots: {[f'{h.hostname}:{h.slots}' for h in hosts]}")
    slots = [s for host_slots in assignments for s in host_slots]
    local_sizes = {i: len(hs) for i, hs in enumerate(assignments)}
    cross_sizes: Dict[int, int] = {}
    for s in slots:
        cross_sizes[s.local_rank] = cross_sizes.get(s.local_rank, 0) + 1
    for s in slots:
        s.size = world
        s.local_size = local_sizes[s.cross_rank]
        s.cross_size = cross_sizes[s.local_rank]
    return slots
