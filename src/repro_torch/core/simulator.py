"""Discrete-event simulator of CCM partial-offloading protocols.

Reproduces the paper's evaluation methodology (SS V): an application is a
sequence of iterations, each with a set of CCM tasks whose results feed a
set of dependent host tasks.  Three protocols schedule the same task graph:

  RP   - device-centric: CXL.mem descriptor write, CXL.io enqueue, remote
         polling of the device mailbox (1 us interval, each poll paying the
         CXL.io round trip), CXL.io dequeue, then a bulk synchronous
         CXL.mem load of all results, then host tasks.  Fully serialized.
  BS   - memory-centric (M2NDP): a synchronous CXL.mem store launches the
         kernel and its response signals completion (host stalls for the
         whole CCM runtime), then the bulk result load, then host tasks.
  AXLE - asynchronous back-streaming: the launch store is asynchronous; a
         DMA executor on the CCM monitors completed results and, whenever
         pending bytes >= SF (or at iteration flush), back-streams *all*
         pending payloads + per-result metadata over CXL.io DMA into host-
         local payload/metadata ring buffers; the host polls the local
         metadata tail every PF ns, moves ready records into the ready
         pool, dispatches dependent host tasks, and returns consumed head
         indexes via asynchronous CXL.mem flow-control stores.  The CCM
         uses its (possibly stale, always conservative) view of the head
         for credit management.  OoO streaming optionally relaxes result
         transmission to completion order with a gap-aware payload head.

Metrics follow the paper: end-to-end runtime, component-level CCM/host
idle time (wall time during which the component runs no task), host core
stall time (cycles spent on CXL/local memory operations of the offload
interaction), back-pressure cycles, and deadlock detection (fig. 16).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.protocol import (
    AxleConfig, HardwareConfig, Protocol, SchedPolicy, DEFAULT_HW)
from repro_torch.core.workloads import WorkloadProfile


# --------------------------------------------------------------------------
# Deterministic task-duration jitter (heterogeneity).
# --------------------------------------------------------------------------

def _hash01(i: int) -> float:
    """Deterministic hash of a task index into [0, 1)."""
    x = (i * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    return x / 2.0 ** 32


def task_duration(mean_ns: float, het: float, index: int) -> float:
    """Mean duration +- het, deterministic per task index."""
    return mean_ns * (1.0 + het * (2.0 * _hash01(index) - 1.0))


# --------------------------------------------------------------------------
# List scheduling (used for the serialized RP/BS makespans and for CCM/host
# slot assignment inside the event simulator).
# --------------------------------------------------------------------------

def schedule_tasks(durations: Sequence[float], n_slots: int,
                   policy: SchedPolicy) -> Tuple[List[float], float]:
    """Return (finish_time per task relative to 0, makespan)."""
    finish = [0.0] * len(durations)
    if policy == SchedPolicy.RR:
        slot_time = [0.0] * n_slots
        for i, d in enumerate(durations):
            s = i % n_slots
            slot_time[s] += d
            finish[i] = slot_time[s]
    else:  # FIFO: earliest-free slot, tasks in index order
        heap = [0.0] * n_slots
        heapq.heapify(heap)
        for i, d in enumerate(durations):
            t0 = heapq.heappop(heap)
            finish[i] = t0 + d
            heapq.heappush(heap, finish[i])
    return finish, (max(finish) if finish else 0.0)


# --------------------------------------------------------------------------
# Result record.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    protocol: Protocol
    workload: str
    runtime_ns: float
    ccm_busy_ns: float
    host_busy_ns: float
    host_stall_ns: float
    data_moved_bytes: int
    n_dma_requests: int = 0
    backpressure_ns: float = 0.0
    deadlock: bool = False

    @property
    def ccm_idle_ns(self) -> float:
        return max(0.0, self.runtime_ns - self.ccm_busy_ns)

    @property
    def host_idle_ns(self) -> float:
        return max(0.0, self.runtime_ns - self.host_busy_ns)

    @property
    def ccm_idle_ratio(self) -> float:
        return self.ccm_idle_ns / self.runtime_ns if self.runtime_ns else 0.0

    @property
    def host_idle_ratio(self) -> float:
        return self.host_idle_ns / self.runtime_ns if self.runtime_ns else 0.0

    @property
    def host_stall_ratio(self) -> float:
        return min(1.0, self.host_stall_ns / self.runtime_ns) if self.runtime_ns else 0.0


# --------------------------------------------------------------------------
# Serialized protocols: RP and BS (analytic per-iteration flow).
# --------------------------------------------------------------------------

def _iteration_makespans(wl: WorkloadProfile, hw: HardwareConfig,
                         policy: SchedPolicy) -> Tuple[List[float], List[float]]:
    """Per-iteration CCM and host makespans under the given scheduler."""
    t_c, t_h = [], []
    for it in range(wl.n_iters):
        cd = [task_duration(wl.t_ccm_ns, wl.het, it * wl.n_ccm_tasks + i)
              for i in range(wl.n_ccm_tasks)]
        hd = [task_duration(wl.t_host_ns, wl.het, 7919 + it * wl.n_host_tasks + i)
              for i in range(wl.n_host_tasks)]
        t_c.append(schedule_tasks(cd, hw.ccm_slots, policy)[1])
        t_h.append(schedule_tasks(hd, hw.host_slots, policy)[1])
    return t_c, t_h


def simulate_rp(wl: WorkloadProfile, hw: HardwareConfig = DEFAULT_HW,
                policy: SchedPolicy = SchedPolicy.RR) -> SimResult:
    t_c, t_h = _iteration_makespans(wl, hw, policy)
    t = 0.0
    stall = 0.0
    moved = 0
    for it in range(wl.n_iters):
        # Kernel descriptor write (CXL.mem) + enqueue command (CXL.io).
        t += hw.cxl_mem_rtt_ns + hw.cxl_io_rtt_ns
        stall += hw.cxl_mem_rtt_ns + hw.cxl_io_rtt_ns
        # CCM executes; host polls the remote mailbox every interval, each
        # poll paying the CXL.io round trip.
        n_polls = max(1, math.ceil(t_c[it] / hw.rp_poll_interval_ns))
        t += n_polls * hw.rp_poll_interval_ns  # detection quantization
        stall += n_polls * hw.cxl_io_rtt_ns
        # Dequeue command (CXL.io).
        t += hw.cxl_io_rtt_ns
        stall += hw.cxl_io_rtt_ns
        # Bulk synchronous result load via CXL.mem.
        t_d = wl.iter_result_bytes / hw.cxl_link_bw + hw.cxl_mem_rtt_ns
        t += t_d
        stall += t_d
        moved += wl.iter_result_bytes
        # Host tasks.
        t += t_h[it]
    return SimResult(Protocol.RP, wl.key, t, sum(t_c), sum(t_h), stall, moved)


def simulate_bs(wl: WorkloadProfile, hw: HardwareConfig = DEFAULT_HW,
                policy: SchedPolicy = SchedPolicy.RR) -> SimResult:
    t_c, t_h = _iteration_makespans(wl, hw, policy)
    t = 0.0
    stall = 0.0
    moved = 0
    for it in range(wl.n_iters):
        # Synchronous CXL.mem store: response returns at kernel completion
        # (hardware barrier); the host processing unit stalls throughout.
        t += hw.cxl_mem_rtt_ns + t_c[it]
        stall += hw.cxl_mem_rtt_ns + t_c[it]
        # Bulk synchronous result load via CXL.mem.
        t_d = wl.iter_result_bytes / hw.cxl_link_bw + hw.cxl_mem_rtt_ns
        t += t_d
        stall += t_d
        moved += wl.iter_result_bytes
        t += t_h[it]
    return SimResult(Protocol.BS, wl.key, t, sum(t_c), sum(t_h), stall, moved)


# --------------------------------------------------------------------------
# AXLE: event-driven asynchronous back-streaming.
# --------------------------------------------------------------------------

class _BusyTracker:
    """Tracks union-of-intervals busy time for one component."""

    def __init__(self) -> None:
        self.active = 0
        self.busy = 0.0
        self._start = 0.0

    def inc(self, now: float) -> None:
        if self.active == 0:
            self._start = now
        self.active += 1

    def dec(self, now: float) -> None:
        self.active -= 1
        if self.active == 0:
            self.busy += now - self._start


@dataclasses.dataclass
class _CcmTask:
    gid: int            # global task id (== global offset order)
    iteration: int
    duration: float
    bytes: int
    slots: int          # payload ring slots occupied by its result


@dataclasses.dataclass
class _HostTask:
    gid: int
    iteration: int
    duration: float
    deps: Tuple[int, ...]       # global CCM task ids
    dispatched: bool = False


class AxleSimulator:
    """Event-driven simulation of the asynchronous back-streaming protocol."""

    def __init__(self, wl: WorkloadProfile, hw: HardwareConfig = DEFAULT_HW,
                 cfg: Optional[AxleConfig] = None,
                 interrupt_notification: bool = False,
                 adaptive_sf: bool = False) -> None:
        self.wl = wl
        self.hw = hw
        self.cfg = cfg or AxleConfig()
        self.interrupt = interrupt_notification
        # Adaptive streaming factor (beyond paper; §V-E hints at it for
        # multi-tenant use): AIMD on the DMA-preparation overhead ratio.
        # The live SF starts at the configured value and is retuned at
        # every iteration launch so per-request prep cost stays amortized
        # without batching away the pipeline overlap.
        self.adaptive_sf = adaptive_sf
        self.sf = self.cfg.streaming_factor_bytes
        self._last_dma_count = 0
        self._last_ccm_busy = 0.0
        self._seq = itertools.count()
        self.events: List[Tuple[float, int, str, object]] = []
        self.now = 0.0
        # --- task graph -----------------------------------------------------
        self.ccm_tasks: List[_CcmTask] = []
        self.host_tasks: List[_HostTask] = []
        slot_b = self.cfg.slot_bytes
        for it in range(wl.n_iters):
            for i in range(wl.n_ccm_tasks):
                gid = it * wl.n_ccm_tasks + i
                self.ccm_tasks.append(_CcmTask(
                    gid, it, task_duration(wl.t_ccm_ns, wl.het, gid),
                    wl.bytes_per_task,
                    max(1, math.ceil(wl.bytes_per_task / slot_b))))
            for j in range(wl.n_host_tasks):
                hgid = it * wl.n_host_tasks + j
                deps = tuple(it * wl.n_ccm_tasks + j * wl.fanin + k
                             for k in range(wl.fanin))
                self.host_tasks.append(_HostTask(
                    hgid, it, task_duration(wl.t_host_ns, wl.het, 7919 + hgid),
                    deps))
        # --- CCM execution state ---------------------------------------------
        n_ccm = hw.ccm_slots
        self.ccm_queues: List[List[_CcmTask]] = [[] for _ in range(n_ccm)]
        self.ccm_fifo: List[_CcmTask] = []
        self.ccm_slot_busy = [False] * n_ccm
        self.ccm_remaining_in_iter = [wl.n_ccm_tasks] * wl.n_iters
        self.launched_iters = 0
        # --- DMA executor state ----------------------------------------------
        self.pending: List[_CcmTask] = []     # completed, not yet streamed
        self.dma_busy = False
        self.next_inorder_gid = 0             # for OoO-disabled transmission
        self.ring_tail = 0                    # payload slots allocated (monotonic)
        self.ring_head = 0                    # host-side: max contiguous consumed
        self.ccm_stale_head = 0               # CCM's last known head (flow control)
        self.consumed_upto: Dict[int, int] = {}   # slot idx -> consumed marker
        self.slot_ranges: Dict[int, Tuple[int, int]] = {}  # ccm gid -> (slot0, nslots)
        self.backpressure_since: Optional[float] = None
        self.backpressure_ns = 0.0
        self.n_dma_requests = 0
        self.data_moved = 0
        # --- host state -------------------------------------------------------
        self.arrived: set = set()             # detected result gids
        self.ready_pool: List[_HostTask] = []
        self.host_free = hw.host_slots
        self.host_remaining_in_iter = [wl.n_host_tasks] * wl.n_iters
        self.host_done = 0
        self.last_interrupt_done = 0.0
        self.interrupt_outstanding = False
        # --- metrics ----------------------------------------------------------
        self.ccm_tracker = _BusyTracker()
        self.host_tracker = _BusyTracker()
        self.deadlock = False

    # -- event machinery ------------------------------------------------------
    def _push(self, t: float, kind: str, payload: object = None) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    # -- CCM scheduling ---------------------------------------------------------
    def _retune_sf(self) -> None:
        """AIMD SF controller: keep DMA prep overhead in [1%, 5%] of the
        CCM busy time since the last retune."""
        d_req = self.n_dma_requests - self._last_dma_count
        busy = (self.ccm_tracker.busy - self._last_ccm_busy)
        self._last_dma_count = self.n_dma_requests
        self._last_ccm_busy = self.ccm_tracker.busy
        if busy <= 0 or d_req == 0:
            return
        overhead = d_req * self.hw.dma_prep_ns / busy
        if overhead > 0.05:
            self.sf = min(self.sf * 2, max(32, self.wl.iter_result_bytes // 4))
        elif overhead < 0.01:
            self.sf = max(32, self.sf // 2)

    def _launch_iteration(self, it: int) -> None:
        """CCM receives the (asynchronous) kernel-launch store for iteration it."""
        if self.adaptive_sf and it > 0:
            self._retune_sf()
        tasks = self.ccm_tasks[it * self.wl.n_ccm_tasks:(it + 1) * self.wl.n_ccm_tasks]
        self._enqueue_ccm_tasks(tasks, it)
        self.launched_iters = max(self.launched_iters, it + 1)

    def _launch_group(self, it: int, group: int) -> None:
        """Group-granularity launch: CCM tasks of `group` in iteration `it`."""
        base = it * self.wl.n_ccm_tasks + group * self.wl.fanin
        tasks = self.ccm_tasks[base:base + self.wl.fanin]
        self._enqueue_ccm_tasks(tasks, it)
        self.launched_iters = max(self.launched_iters, it + 1)

    def _enqueue_ccm_tasks(self, tasks: List[_CcmTask], it: int) -> None:
        if self.cfg.sched == SchedPolicy.RR:
            new_q: List[List[_CcmTask]] = [[] for _ in range(self.hw.ccm_slots)]
            for task in tasks:
                new_q[task.gid % self.hw.ccm_slots].append(task)
            # The paper's RR scheduler requeues tasks whose inputs are not
            # yet ready ("moved to the back of the queue", SS V-E), which
            # heavily scrambles completion order w.r.t. result offsets.  We
            # model this with a deterministic per-slot rotation of the
            # execution order (makespan-preserving, order-scrambling).
            for s in range(self.hw.ccm_slots):
                q = new_q[s]
                if len(q) > 1 and self.wl.sched_scramble > 0.0:
                    r = int(_hash01(s * 7919 + it) * len(q)
                            * self.wl.sched_scramble)
                    new_q[s] = q[r:] + q[:r]
                self.ccm_queues[s].extend(new_q[s])
            for s in range(self.hw.ccm_slots):
                self._maybe_start_ccm_slot(s)
        else:
            self.ccm_fifo.extend(tasks)
            for s in range(self.hw.ccm_slots):
                self._maybe_start_ccm_slot(s)

    def _maybe_start_ccm_slot(self, s: int) -> None:
        if self.ccm_slot_busy[s]:
            return
        task: Optional[_CcmTask] = None
        if self.cfg.sched == SchedPolicy.RR:
            if self.ccm_queues[s]:
                task = self.ccm_queues[s].pop(0)
        else:
            if self.ccm_fifo:
                task = self.ccm_fifo.pop(0)
        if task is None:
            return
        self.ccm_slot_busy[s] = True
        self.ccm_tracker.inc(self.now)
        self._push(self.now + task.duration, "ccm_finish", (s, task))

    # -- DMA executor -----------------------------------------------------------
    def _free_ring_slots(self) -> int:
        return self.cfg.dma_slot_capacity - (self.ring_tail - self.ccm_stale_head)

    def _selectable(self) -> List[_CcmTask]:
        """Results the DMA executor may transmit now, honoring OoO setting
        and the (stale-head) credit limit."""
        if self.cfg.ooo_streaming:
            order = self.pending  # completion order
        else:
            # Only the contiguous run of offsets starting at next_inorder_gid.
            by_gid = {t.gid: t for t in self.pending}
            order = []
            g = self.next_inorder_gid
            while g in by_gid:
                order.append(by_gid[g])
                g += 1
        out, free = [], self._free_ring_slots()
        for t in order:
            if t.slots > free:
                break
            out.append(t)
            free -= t.slots
        return out

    def _flush_due(self) -> bool:
        """True if some launched iteration has fully finished CCM-side but
        still has unstreamed results (end-of-iteration flush)."""
        pend_iters = {t.iteration for t in self.pending}
        return any(self.ccm_remaining_in_iter[it] == 0 for it in pend_iters)

    def _trigger_dma(self) -> None:
        if self.dma_busy or not self.pending:
            return
        # Interrupt-based notification: the device coalesces doorbells -- it
        # does not raise a new DMA+interrupt while one is still unhandled
        # (otherwise the 50 us handler would be swamped; SS V-B models the
        # per-request handling delay).
        if self.interrupt and self.interrupt_outstanding:
            return
        batch = self._selectable()
        batch_bytes = sum(t.bytes for t in batch)
        if not batch:
            # Credits exhausted (or head-of-line blocked with OoO disabled):
            # results are pending but none can be transmitted.
            if self.backpressure_since is None:
                self.backpressure_since = self.now
            return
        if batch_bytes < self.sf and not self._flush_due():
            return
        if self.backpressure_since is not None:
            self.backpressure_ns += self.now - self.backpressure_since
            self.backpressure_since = None
        # Allocate payload ring slots and transmit.
        for t in batch:
            self.slot_ranges[t.gid] = (self.ring_tail, t.slots)
            self.ring_tail += t.slots
            self.pending.remove(t)
            if not self.cfg.ooo_streaming:
                self.next_inorder_gid = t.gid + 1
        wire_bytes = batch_bytes + len(batch) * self.cfg.metadata_bytes
        self.data_moved += wire_bytes
        self.n_dma_requests += 1
        self.dma_busy = True
        if self.interrupt:
            self.interrupt_outstanding = True
        done = self.now + self.hw.dma_prep_ns + wire_bytes / self.hw.cxl_link_bw
        self._push(done, "dma_done", tuple(t.gid for t in batch))

    # -- host side ----------------------------------------------------------------
    def _detection_time(self, arrival: float) -> float:
        if self.interrupt:
            # Serialized interrupt handling: one handler, 50 us per request.
            self.last_interrupt_done = (max(arrival, self.last_interrupt_done)
                                        + self.hw.interrupt_handling_ns)
            return self.last_interrupt_done
        pf = self.cfg.poll_interval_ns
        k = math.floor(arrival / pf)
        tick = k * pf
        return tick if tick >= arrival else (k + 1) * pf

    def _dispatch_host(self) -> None:
        while self.host_free > 0 and self.ready_pool:
            task = self.ready_pool.pop(0)
            self.host_free -= 1
            self.host_tracker.inc(self.now)
            self._push(self.now + task.duration, "host_finish", task)

    def _check_ready(self) -> None:
        for task in self.host_tasks:
            if not task.dispatched and all(d in self.arrived for d in task.deps):
                task.dispatched = True
                self.ready_pool.append(task)
        self._dispatch_host()

    def _consume(self, task: _HostTask) -> None:
        """Free payload ring slots for the task's deps (gap-aware head)."""
        for d in task.deps:
            s0, n = self.slot_ranges[d]
            for s in range(s0, s0 + n):
                self.consumed_upto[s] = 1
        while self.consumed_upto.get(self.ring_head):
            del self.consumed_upto[self.ring_head]
            self.ring_head += 1

    # -- main loop -------------------------------------------------------------------
    def run(self) -> SimResult:
        wl, hw = self.wl, self.hw
        # The host issues asynchronous kernel-launch stores via CXL.mem.
        if wl.iter_dependent:
            self._push(hw.mem_oneway_ns, "launch", 0)
        else:
            for it in range(wl.n_iters):
                self._push(hw.mem_oneway_ns, "launch", it)
        total_host = len(self.host_tasks)
        while self.events and self.host_done < total_host:
            self.now, _, kind, payload = heapq.heappop(self.events)
            if kind == "launch":
                self._launch_iteration(payload)
            elif kind == "launch_group":
                self._launch_group(*payload)
            elif kind == "ccm_finish":
                s, task = payload
                self.ccm_slot_busy[s] = False
                self.ccm_tracker.dec(self.now)
                self.ccm_remaining_in_iter[task.iteration] -= 1
                self.pending.append(task)
                self._maybe_start_ccm_slot(s)
                self._trigger_dma()
            elif kind == "dma_done":
                self.dma_busy = False
                self._push(self.now + hw.io_oneway_ns, "arrive", payload)
                self._trigger_dma()
            elif kind == "arrive":
                self._push(self._detection_time(self.now), "detect", payload)
            elif kind == "detect":
                self.arrived.update(payload)
                if self.interrupt:
                    self.interrupt_outstanding = False
                    self._trigger_dma()
                self._check_ready()
            elif kind == "host_finish":
                task = payload
                self.host_free += 1
                self.host_tracker.dec(self.now)
                self.host_done += 1
                self._consume(task)
                # Flow-control store (asynchronous CXL.mem head update).
                self._push(self.now + hw.mem_oneway_ns, "flow_control",
                           self.ring_head)
                self.host_remaining_in_iter[task.iteration] -= 1
                if wl.iter_dependent and task.iteration + 1 < wl.n_iters:
                    if wl.dep_granularity == "group":
                        group = task.gid - task.iteration * wl.n_host_tasks
                        self._push(self.now + hw.mem_oneway_ns, "launch_group",
                                   (task.iteration + 1, group))
                    elif self.host_remaining_in_iter[task.iteration] == 0:
                        self._push(self.now + hw.mem_oneway_ns, "launch",
                                   task.iteration + 1)
                self._dispatch_host()
            elif kind == "flow_control":
                self.ccm_stale_head = max(self.ccm_stale_head, payload)
                self._trigger_dma()
        runtime = self.now
        if self.host_done < total_host:
            self.deadlock = True
        if self.backpressure_since is not None:
            self.backpressure_ns += runtime - self.backpressure_since
        # Host core stall (fig. 13): the dedicated polling routine's local
        # uncached reads of the metadata tail, plus the per-worker-thread
        # asynchronous store issue costs (flow control + kernel launches),
        # normalized to a single representative core as in the RP/BS cases
        # (where the single offloading core's stall is reported).
        if self.interrupt:
            stall_poll = 0.0
        else:
            pf_eff = max(self.cfg.poll_interval_ns, hw.local_poll_cost_ns)
            stall_poll = runtime / pf_eff * hw.local_poll_cost_ns
        stall = (stall_poll
                 + ((self.host_done + self.launched_iters)
                    * hw.async_store_issue_ns) / hw.host_slots)
        proto = Protocol.AXLE_INTERRUPT if self.interrupt else Protocol.AXLE
        return SimResult(proto, wl.key, runtime,
                         self.ccm_tracker.busy, self.host_tracker.busy,
                         min(stall, runtime), self.data_moved,
                         self.n_dma_requests, self.backpressure_ns,
                         self.deadlock)


# --------------------------------------------------------------------------
# Public entry points.
# --------------------------------------------------------------------------

def simulate(wl: WorkloadProfile, protocol: Protocol,
             hw: HardwareConfig = DEFAULT_HW,
             cfg: Optional[AxleConfig] = None) -> SimResult:
    cfg = cfg or AxleConfig()
    if protocol == Protocol.RP:
        return simulate_rp(wl, hw, cfg.sched)
    if protocol == Protocol.BS:
        return simulate_bs(wl, hw, cfg.sched)
    if protocol == Protocol.AXLE:
        return AxleSimulator(wl, hw, cfg).run()
    if protocol == Protocol.AXLE_INTERRUPT:
        return AxleSimulator(wl, hw, cfg, interrupt_notification=True).run()
    raise ValueError(protocol)


def compare_protocols(wl: WorkloadProfile, hw: HardwareConfig = DEFAULT_HW,
                      cfg: Optional[AxleConfig] = None) -> Dict[str, SimResult]:
    return {p.name: simulate(wl, p, hw, cfg)
            for p in (Protocol.RP, Protocol.BS, Protocol.AXLE)}
