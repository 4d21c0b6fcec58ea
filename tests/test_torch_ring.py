"""Parity of the port's ring index algebra and wire accounting
(`repro_torch.core.ring`) with `repro.core.ring`: drawn allocate /
out-of-order consume / flow-control scripts run through both, state for
state (every field exact: they are integers and flags), the per-merge
wire bytes on drawn shapes, and the `WireLedger`'s charges."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis",
                    reason="drawn ring scripts need hypothesis")

import jax.numpy as jnp                                       # noqa: E402
from hypothesis import given, settings, strategies as st     # noqa: E402

from repro.core import ring as jring                         # noqa: E402
from repro_torch.core import ring                            # noqa: E402


def _same(port, ref):
    """Every field of the two states equal."""
    assert np.array_equal(port.consumed.numpy(), np.asarray(ref.consumed))
    for f in ("head", "tail", "stale_head"):
        assert int(getattr(port, f)) == int(getattr(ref, f)), f
    assert bool(ring.invariants_ok(port)) == bool(jring.invariants_ok(ref))


@given(st.integers(2, 12).flatmap(
    lambda cap: st.permutations(list(range(cap)))))
@settings(max_examples=25, deadline=None)
def test_out_of_order_consume_state_for_state(order):
    cap = len(order)
    r, jr = ring.make_ring(cap), jring.make_ring(cap)
    r, start = ring.allocate(r, cap)
    jr, jstart = jring.allocate(jr, jnp.asarray(cap, jnp.int32))
    assert int(start) == int(jstart) == 0
    _same(r, jr)
    for idx in order:
        r = ring.consume(r, idx)
        jr = jring.consume(jr, jnp.asarray(idx, jnp.int32))
        _same(r, jr)
    assert int(r.head) == cap


@given(st.lists(st.tuples(st.integers(1, 4), st.integers(0, 7),
                          st.booleans()), min_size=1, max_size=30))
@settings(max_examples=25, deadline=None)
def test_interleaved_script_state_for_state(script):
    """allocate (when the producer's stale credits allow), consume an
    outstanding slot picked by the draw, deliver the head or not: both
    rings agree after every operation, credits included."""
    cap = 8
    r, jr = ring.make_ring(cap), jring.make_ring(cap)
    outstanding = []
    for n, pick, deliver in script:
        ok = bool(ring.can_allocate(r, n))
        assert ok == bool(jring.can_allocate(jr, jnp.asarray(n, jnp.int32)))
        if ok:
            r, start = ring.allocate(r, n)
            jr, _ = jring.allocate(jr, jnp.asarray(n, jnp.int32))
            outstanding.extend(range(int(start), int(start) + n))
        if outstanding:
            idx = outstanding.pop(pick % len(outstanding))
            r = ring.consume(r, idx)
            jr = jring.consume(jr, jnp.asarray(idx, jnp.int32))
        if deliver:
            r = ring.flow_control_update(r)
            jr = jring.flow_control_update(jr)
        _same(r, jr)
        assert int(ring.free_slots_producer(r)) == \
            int(jring.free_slots_producer(jr))
        assert bool(ring.invariants_ok(r))


def test_consume_does_not_free_producer_credits_until_delivered():
    r = ring.make_ring(4)
    r, _ = ring.allocate(r, 3)
    assert int(ring.free_slots_producer(r)) == 1
    r = ring.consume(r, 0)
    assert int(r.head) == 1 and int(ring.free_slots_producer(r)) == 1
    r = ring.flow_control_update(r)
    assert int(ring.free_slots_producer(r)) == 2
    r = ring.consume(r, 2)                 # out of order: head stays
    assert int(r.head) == 1 and bool(r.consumed[2])
    r = ring.consume(r, 1)                 # the gap closes: head jumps
    assert int(r.head) == 3 and not bool(r.consumed.any())


@given(n=st.integers(1, 16), rows=st.integers(1, 64),
       heads=st.integers(1, 48), hd=st.integers(1, 256),
       itemsize=st.sampled_from([2, 4]))
@settings(max_examples=50, deadline=None)
def test_merge_wire_bytes_equal_the_reference(n, rows, heads, hd, itemsize):
    assert ring.merge_wire_bytes_per_shard(n, rows, heads, hd, itemsize) \
        == jring.merge_wire_bytes_per_shard(n, rows, heads, hd, itemsize)


@given(n=st.integers(1, 8), rows=st.integers(1, 16),
       heads=st.integers(1, 8), hd=st.integers(1, 128),
       charges=st.lists(st.integers(0, 64), max_size=20))
@settings(max_examples=40, deadline=None)
def test_wire_ledger_charges_like_the_reference(n, rows, heads, hd,
                                                charges):
    led = ring.WireLedger(n_shards=n, rows_local=rows, heads_local=heads,
                          head_dim=hd)
    jled = jring.WireLedger(n_shards=n, rows_local=rows,
                            heads_local=heads, head_dim=hd)
    for c in charges:
        led.charge_merges(c)
        jled.charge_merges(c)
    assert led.wire_bytes_per_shard == jled.wire_bytes_per_shard \
        == sum(charges) * (0 if n == 1 else
                           (n - 1) * rows * heads * (hd + 2) * 4)
    assert led.wire_bytes_total == jled.wire_bytes_total
    assert (led.merges, led.segments) == (jled.merges, jled.segments)
    assert led.per_segment() == jled.per_segment()


def test_starcoder2_wire_at_1x2():
    """The full-width starcoder2_3b serve of chip_smoke.py's mesh phase:
    4 rows, 24 heads split in two groups of 12, hd 128: 24,960 bytes a
    merge, 30 merges a decode step."""
    led = ring.WireLedger(n_shards=2, rows_local=4, heads_local=12,
                          head_dim=128)
    assert led.bytes_per_merge == 24_960
    led.charge_merges(30)
    assert led.wire_bytes_per_shard == 30 * 24_960
    with pytest.raises(AssertionError):
        led.charge_merges(-1)
