"""Gap-aware ring buffer index algebra (SS IV-C of the paper), the port of
`repro/core/ring.py`, on int tensors.

AXLE's DMA region is a pair of fixed-size ring buffers (metadata +
payload).  Out-of-order consumption needs a *gap-aware* head: the head
only advances over the longest contiguous consumed prefix, while any slot
in (head, tail) may already be consumed.  The producer (CCM) manages
credits against a *stale* head: conservative, never unsafe.

The state is functional, as in the reference: every operation returns a
new `RingState`.  `merge_wire_bytes_per_shard` and `WireLedger` are the
host-side accounting of the bytes the mesh decode puts on the wire.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

Index = Union[int, torch.Tensor]


def _i32(x: Index) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32)


@dataclasses.dataclass
class RingState:
    """capacity = consumed.shape[0].  Every index is monotonic (never
    wrapped); logical index i lives in physical slot i % capacity."""
    consumed: torch.Tensor     # (capacity,) bool: physical slot consumed
    head: torch.Tensor         # () int32: longest contiguous consumed prefix
    tail: torch.Tensor         # () int32: next slot to allocate
    stale_head: torch.Tensor   # () int32: the producer's last known head


def make_ring(capacity: int) -> RingState:
    zero = torch.zeros((), dtype=torch.int32)
    return RingState(consumed=torch.zeros((capacity,), dtype=torch.bool),
                     head=zero, tail=zero.clone(), stale_head=zero.clone())


def capacity(ring: RingState) -> int:
    return ring.consumed.shape[0]


def free_slots_producer(ring: RingState) -> torch.Tensor:
    """Credits from the producer's (stale, conservative) point of view."""
    return capacity(ring) - (ring.tail - ring.stale_head)


def can_allocate(ring: RingState, n: Index) -> torch.Tensor:
    return _i32(n) <= free_slots_producer(ring)


def allocate(ring: RingState, n: Index) -> Tuple[RingState, torch.Tensor]:
    """Allocate n slots (the caller checked `can_allocate`).  Returns the
    new state and the first logical index."""
    return dataclasses.replace(ring, tail=ring.tail + _i32(n)), ring.tail


def consume(ring: RingState, idx: Index) -> RingState:
    """Mark logical slot `idx` consumed (out of order allowed), then
    advance the head over the longest contiguous consumed prefix, clearing
    the slots it passes."""
    cap = capacity(ring)
    consumed = ring.consumed.clone()
    consumed[int(idx) % cap] = True
    head, tail = int(ring.head), int(ring.tail)
    while head < tail and bool(consumed[head % cap]):
        consumed[head % cap] = False
        head += 1
    return dataclasses.replace(ring, consumed=consumed, head=_i32(head))


def flow_control_update(ring: RingState) -> RingState:
    """Deliver the consumer's head to the producer (the CXL.mem store)."""
    return dataclasses.replace(
        ring, stale_head=torch.maximum(ring.stale_head, ring.head))


def invariants_ok(ring: RingState) -> torch.Tensor:
    """The paper's consistency invariants (SS IV-C): stale_head <= head <=
    tail and tail - head <= capacity; the indexes are monotonic by
    construction."""
    return ((ring.stale_head <= ring.head) & (ring.head <= ring.tail)
            & (ring.tail - ring.head <= capacity(ring)))


# --------------------------------------------------------------------------
# AXLE wire accounting: bytes the mesh decode moves between shards
# --------------------------------------------------------------------------

def merge_wire_bytes_per_shard(n_shards: int, rows: int, heads_local: int,
                               head_dim: int, itemsize: int = 4) -> int:
    """Bytes ONE shard puts on the wire for ONE partial-attention merge: its
    (acc, m, l) statistics, rows * heads_local * (head_dim + 2) elements,
    sent to each of the n - 1 peers (ring hops and a gather move the same
    payload on different schedules).  Zero for a single shard."""
    if n_shards <= 1:
        return 0
    return (n_shards - 1) * rows * heads_local * (head_dim + 2) * itemsize


@dataclasses.dataclass
class WireLedger:
    """Host-side wire accounting of the mesh-sharded serve loop.

    A decode segment's merge structure is fixed (one head-group merge per
    attention sublayer a decode step, one per verified position a verify
    forward), so the host charges the ledger at dispatch without reading
    anything back: `charge_merges(n)` after dispatching a segment that
    merges n times.  `wire_bytes_per_shard` is what one shard sent,
    `wire_bytes_total` the whole mesh's traffic."""
    n_shards: int
    rows_local: int
    heads_local: int
    head_dim: int
    itemsize: int = 4
    merges: int = 0
    segments: int = 0

    @property
    def bytes_per_merge(self) -> int:
        return merge_wire_bytes_per_shard(
            self.n_shards, self.rows_local, self.heads_local,
            self.head_dim, self.itemsize)

    @property
    def wire_bytes_per_shard(self) -> int:
        return self.merges * self.bytes_per_merge

    @property
    def wire_bytes_total(self) -> int:
        return self.wire_bytes_per_shard * self.n_shards

    def charge_merges(self, n_merges: int) -> None:
        assert n_merges >= 0
        self.merges += int(n_merges)
        self.segments += 1

    def per_segment(self) -> float:
        """Mean wire bytes a dispatched segment (0.0 before any)."""
        if not self.segments:
            return 0.0
        return self.wire_bytes_per_shard / self.segments
