"""Protocol definitions and latency/bandwidth constants for CCM offloading.

Faithful to AXLE Table III (simulation setup) and the CXL 3.0 latency
numbers the paper adopts.  All times are in *nanoseconds*, bandwidths in
*bytes per nanosecond* (== GB/s), sizes in bytes.
"""
from __future__ import annotations

import dataclasses
import enum


class Protocol(enum.Enum):
    """Partial-offloading mechanisms compared in the paper (Table II)."""

    RP = "remote_polling"        # device-centric, CXL.io mailbox + remote polling
    BS = "bulk_synchronous"      # memory-centric, synchronous CXL.mem store/load (M2NDP)
    AXLE = "axle"                # asynchronous back-streaming (this paper)
    AXLE_INTERRUPT = "axle_interrupt"  # AXLE variant: interrupt-based notification


class SchedPolicy(enum.Enum):
    """Task scheduling policy, applied symmetrically to CCM and host (SS V-E)."""

    RR = "round_robin"   # task i -> execution slot (i mod n_slots)
    FIFO = "fifo"        # next task in index order -> earliest-free slot


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    """Host + CCM + CXL configuration (Table III)."""

    # Host: 32 processing units x 2 uthreads @ 3 GHz.
    host_units: int = 32
    host_uthreads: int = 2
    # CCM: 16 processing units x 16 uthreads @ 2 GHz (M2NDP fine-grained MT).
    ccm_units: int = 16
    ccm_uthreads: int = 16

    # CXL protocol round-trip latencies (ns).
    cxl_mem_rtt_ns: float = 70.0
    cxl_io_rtt_ns: float = 350.0

    # Link bandwidth for bulk data (CXL.mem loads and CXL.io DMA writes).
    # x16 PCIe5-class link.
    cxl_link_bw: float = 64.0      # B/ns == GB/s

    # RP: remote polling interval over CXL.io (1 us in Table III).
    rp_poll_interval_ns: float = 1_000.0

    # AXLE: DMA preparation latency per request; interrupt handling latency.
    dma_prep_ns: float = 500.0
    interrupt_handling_ns: float = 50_000.0

    # AXLE: local poll = one uncached DRAM read of the metadata tail
    # (DMA region is pinned cache-bypass, SS IV-C), ~150 ns on DDR5.
    local_poll_cost_ns: float = 150.0
    # Asynchronous store issue cost (flow control / kernel launch messages).
    async_store_issue_ns: float = 40.0

    @property
    def ccm_slots(self) -> int:
        return self.ccm_units * self.ccm_uthreads   # 256

    @property
    def host_slots(self) -> int:
        return self.host_units * self.host_uthreads  # 64

    @property
    def mem_oneway_ns(self) -> float:
        return self.cxl_mem_rtt_ns / 2.0

    @property
    def io_oneway_ns(self) -> float:
        return self.cxl_io_rtt_ns / 2.0


@dataclasses.dataclass(frozen=True)
class AxleConfig:
    """AXLE system parameters (Table III + SS IV-C)."""

    # Local polling interval (PF). Paper sweeps 50 ns (p1), 500 ns (p10), 5 us (p100).
    poll_interval_ns: float = 500.0
    # Streaming factor (SF): minimum pending result bytes that triggers a DMA
    # back-stream.  The DMA request then carries *all* pending payloads
    # (self-pacing batching, SS IV-B step 2).
    streaming_factor_bytes: int = 32
    # Ring-buffer slot size (== single DMA slot size).
    slot_bytes: int = 32
    # Payload ring capacity in slots (Table III: 50000 => effectively abundant
    # for the evaluated workloads; fig16 sweeps fractions of one iteration).
    dma_slot_capacity: int = 50_000
    # Metadata record size (one record per task result).
    metadata_bytes: int = 32
    # Out-of-order streaming (SS IV-C).  When disabled the DMA executor only
    # transmits the contiguous prefix of results in task-offset order.
    ooo_streaming: bool = True
    # Scheduling policy applied to both CCM and host schedulers.
    sched: SchedPolicy = SchedPolicy.RR


# Convenience polling-factor aliases used throughout the paper's figures.
POLL_P1 = 50.0
POLL_P10 = 500.0
POLL_P100 = 5_000.0

DEFAULT_HW = HardwareConfig()
