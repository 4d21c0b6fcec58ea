"""The paper's protocol simulator in the port (`repro_torch/core/protocol.py`,
`workloads.py`, `simulator.py`, copies of the JAX package's with their
imports rewritten) and the ported quickstart.

The port's `compare_protocols` equals the JAX package's field for field,
exactly, on every workload; the engine invariants of
tests/test_simulator.py hold as parametrised cases at its small sizes
(the JAX package's file draws them with hypothesis); the quickstart runs
on the CPU and prints AXLE's runtime reduction.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import protocol as jprotocol                   # noqa: E402
from repro.core import simulator as jsimulator                 # noqa: E402
from repro_torch.core.protocol import (DEFAULT_HW, AxleConfig,  # noqa: E402
                                       HardwareConfig, Protocol,
                                       SchedPolicy)
from repro_torch.core.simulator import (AxleSimulator,          # noqa: E402
                                        compare_protocols, schedule_tasks,
                                        simulate, task_duration)
from repro_torch.core.workloads import WORKLOADS, WorkloadProfile  # noqa: E402
from repro_torch.examples import quickstart                    # noqa: E402


def small_wl(**kw):
    base = dict(key="t", domain="test", application="test", characteristics="",
                n_iters=3, n_ccm_tasks=64, t_ccm_ns=2000.0, bytes_per_task=64,
                n_host_tasks=64, t_host_ns=500.0, fanin=1, het=0.2,
                iter_dependent=True)
    base.update(kw)
    return WorkloadProfile(**base)


def _named(dc):
    """A dataclass's fields, enums by name (the two packages' enums are
    different classes)."""
    return {k: getattr(v, "name", v) for k, v in dataclasses.asdict(dc).items()}


# ------------------------------------------------------ against the JAX copy

@pytest.mark.parametrize("key", sorted(WORKLOADS))
def test_compare_protocols_equals_the_jax_package(key):
    """Every field of every protocol's result equals the JAX package's
    exactly; and AXLE <= BS <= RP as tests/test_simulator.py holds them."""
    from repro.core.workloads import WORKLOADS as JWORKLOADS
    assert dataclasses.asdict(WORKLOADS[key]) == \
        dataclasses.asdict(JWORKLOADS[key])
    got = compare_protocols(WORKLOADS[key])
    want = jsimulator.compare_protocols(JWORKLOADS[key])
    assert got.keys() == want.keys() == {"RP", "BS", "AXLE"}
    for name in got:
        assert _named(got[name]) == _named(want[name]), (key, name)
    assert got["BS"].runtime_ns <= got["RP"].runtime_ns * 1.001
    assert got["AXLE"].runtime_ns <= got["BS"].runtime_ns * 1.05


def test_configs_equal_the_jax_package():
    assert _named(DEFAULT_HW) == _named(jprotocol.DEFAULT_HW)
    assert _named(AxleConfig()) == _named(jprotocol.AxleConfig())
    assert [(p.name, p.value) for p in Protocol] == \
        [(p.name, p.value) for p in jprotocol.Protocol]


# --------------------------------------------------------------- scheduling

SCHEDULES = [[1.0], [5.0, 1.0, 1.0, 1.0], [3.0] * 7,
             [float(1 + (i * 7919) % 97) for i in range(200)],
             [1e6, 1.0, 2.0, 3e5, 7.5]]


@pytest.mark.parametrize("durations", SCHEDULES)
@pytest.mark.parametrize("n_slots", [1, 3, 64])
@pytest.mark.parametrize("policy", list(SchedPolicy))
def test_schedule_tasks_invariants(durations, n_slots, policy):
    finish, makespan = schedule_tasks(durations, n_slots, policy)
    assert makespan == max(finish)
    assert makespan >= max(durations) - 1e-9
    assert makespan >= sum(durations) / n_slots - 1e-6
    assert makespan <= sum(durations) + 1e-6
    if policy == SchedPolicy.FIFO:    # Graham's bound
        lb = max(max(durations), sum(durations) / n_slots)
        assert makespan <= 2.0 * lb + 1e-6


@pytest.mark.parametrize("i,het,mean", [(0, 0.0, 1.0), (7, 0.2, 500.0),
                                        (10_000_000, 0.5, 1e6),
                                        (12345, 0.35, 2000.0)])
def test_task_duration_bounds(i, het, mean):
    d = task_duration(mean, het, i)
    assert mean * (1 - het) - 1e-6 <= d <= mean * (1 + het) + 1e-6
    assert d == task_duration(mean, het, i)


# ---------------------------------------------------------------- protocols

@pytest.mark.parametrize("proto", list(Protocol))
def test_protocols_complete(proto):
    r = simulate(small_wl(), proto)
    assert not r.deadlock
    assert r.runtime_ns > 0
    assert r.ccm_busy_ns > 0 and r.host_busy_ns > 0
    assert r.ccm_busy_ns <= r.runtime_ns + 1e-6
    assert r.host_busy_ns <= r.runtime_ns + 1e-6


@pytest.mark.parametrize("proto", [Protocol.RP, Protocol.BS, Protocol.AXLE])
def test_runtime_lower_bounds(proto):
    r = simulate(small_wl(), proto)
    assert r.runtime_ns >= r.ccm_busy_ns - 1e-6
    if proto != Protocol.AXLE:        # serialized: busy_c + busy_h
        assert r.runtime_ns >= r.ccm_busy_ns + r.host_busy_ns - 1e-6


def test_axle_all_results_transferred():
    wl = small_wl()
    sim = AxleSimulator(wl)
    r = sim.run()
    assert r.data_moved_bytes == wl.n_iters * wl.iter_result_bytes \
        + wl.n_iters * wl.n_ccm_tasks * 32                  # + metadata
    assert sim.host_done == wl.n_iters * wl.n_host_tasks
    assert not sim.pending
    assert sim.ring_head == sim.ring_tail
    assert not sim.consumed_upto
    assert sim.ccm_stale_head <= sim.ring_head


@pytest.mark.parametrize("bytes_per_task,capacity", [(96, 64), (64, 32),
                                                     (200, 128)])
def test_axle_conservative_credits_never_exceeded(bytes_per_task, capacity):
    sim = AxleSimulator(small_wl(bytes_per_task=bytes_per_task),
                        cfg=AxleConfig(dma_slot_capacity=capacity))
    orig = sim._trigger_dma
    occ = [0]

    def traced():
        orig()
        occ[0] = max(occ[0], sim.ring_tail - sim.ring_head)
    sim._trigger_dma = traced
    assert not sim.run().deadlock
    assert occ[0] <= capacity


def test_poll_interval_monotonicity():
    wl = WORKLOADS["b"]
    runtimes = [simulate(wl, Protocol.AXLE,
                         cfg=AxleConfig(poll_interval_ns=p)).runtime_ns
                for p in (50.0, 500.0, 5000.0)]
    assert runtimes[0] <= runtimes[1] * 1.001 <= runtimes[2] * 1.002


@pytest.mark.parametrize("het", [0.0, 0.4])
def test_in_order_streaming_sends_in_offset_order(het):
    sim = AxleSimulator(small_wl(het=het), cfg=AxleConfig(ooo_streaming=False))
    order = []
    orig_push = sim._push

    def push(t, kind, payload=None):
        if kind == "dma_done":
            order.extend(payload)
        orig_push(t, kind, payload)
    sim._push = push
    assert not sim.run().deadlock
    assert order == sorted(order)


def test_flush_delivers_below_sf_results():
    r = AxleSimulator(small_wl(n_iters=2),
                      cfg=AxleConfig(streaming_factor_bytes=10 ** 9)).run()
    assert not r.deadlock


@pytest.mark.parametrize("n_iters,fanin,ooo,dep,pf", [
    (1, 1, True, True, 50.0), (2, 3, False, True, 500.0),
    (4, 8, True, False, 5000.0), (3, 2, False, False, 50.0),
    (4, 1, True, True, 500.0)])
def test_axle_no_deadlock_with_abundant_ring(n_iters, fanin, ooo, dep, pf):
    wl = small_wl(n_iters=n_iters, n_ccm_tasks=32 * fanin, n_host_tasks=32,
                  fanin=fanin, iter_dependent=dep)
    concurrent = 1 if dep else n_iters
    slots = concurrent * math.ceil(wl.iter_result_bytes / 32) + 32
    r = AxleSimulator(wl, cfg=AxleConfig(poll_interval_ns=pf,
                                         ooo_streaming=ooo,
                                         dma_slot_capacity=slots)).run()
    assert not r.deadlock
    assert r.runtime_ns >= r.ccm_busy_ns - 1e-6


def test_hw_scaling_host_units():
    wl = WORKLOADS["h"]
    small = simulate(wl, Protocol.AXLE,
                     hw=HardwareConfig(host_units=4, ccm_units=8))
    assert small.runtime_ns > simulate(wl, Protocol.AXLE).runtime_ns


# --------------------------------------------------------------- quickstart

def test_quickstart_runs_on_the_cpu(capsys):
    out = quickstart.main(device="cpu")
    text = capsys.readouterr().out
    assert f"AXLE reduces end-to-end runtime by {out['axle_reduction'] * 100:.1f}%" \
        in text
    assert 0.0 < out["axle_reduction"] < 1.0
    assert out["max_err"] < 1e-5
