"""The port's `stream_offload` (`repro_torch.core.backstream`) and its KNN
offload example (`repro_torch.examples.knn_offload`) against the JAX
package, on the CPU.

Tolerances:
  * the toy folds of tests/test_backstream.py: the port's carries equal
    the JAX `stream_offload`'s within rel = 1e-6 (float32 sums of the
    same values in the same order; XLA may fuse the squares) and are
    bitwise equal across BS, RP and AXLE inside the port;
  * the KNN example: its top-K distances equal the JAX example's
    `stream_offload` run within 1e-4, as the JAX example asserts, and its
    chunk-local ids equal the JAX run's except where two candidate
    distances lie within that 1e-4 (a near tie).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import backstream as jbs                      # noqa: E402
from repro.kernels import ops as jops                         # noqa: E402
from repro_torch.core import backstream as bs                 # noqa: E402
from repro_torch.examples import knn_offload                  # noqa: E402
from repro_torch.kernels import build as kbuild               # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402

PROTOCOLS = ["bs", "rp", "axle"]


def _jax_fold(producer, consumer, init, n, proto, depth):
    p = jbs.OffloadProtocol(proto)
    with jbs.use_offload(jbs.OffloadConfig(protocol=p, ring_depth=depth)):
        return jbs.stream_offload(producer, consumer, init, n, protocol=p)


def _port_fold(producer, consumer, init, n, proto, depth):
    p = bs.OffloadProtocol(proto)
    with bs.use_offload(bs.OffloadConfig(protocol=p, ring_depth=depth)):
        return bs.stream_offload(producer, consumer, init, n, protocol=p)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_stream_offload_sum_of_squares(depth):
    data = np.random.default_rng(0).standard_normal((8, 16)).astype(
        np.float32)
    jdata, tdata = jnp.asarray(data), torch.from_numpy(data)
    want = float(jnp.sum((jdata * 2.0) ** 2))
    outs = {}
    for proto in PROTOCOLS:
        got_j = _jax_fold(lambda i: jdata[i] * 2.0,
                          lambda c, p: c + jnp.sum(p ** 2), jnp.zeros(()), 8,
                          proto, depth)
        outs[proto] = _port_fold(lambda i: tdata[i] * 2.0,
                                 lambda c, p: c + torch.sum(p ** 2),
                                 torch.zeros(()), 8, proto, depth)
        assert outs[proto].item() == pytest.approx(float(got_j), rel=1e-6)
        assert outs[proto].item() == pytest.approx(want, rel=1e-5)
    assert all(torch.equal(outs[p], outs["bs"]) for p in PROTOCOLS)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_stream_offload_order_sensitive_consumer(depth):
    """2c + p over p = 0..5 is exact in f32 and differs for any other
    order of consumption."""
    outs = {}
    for proto in PROTOCOLS:
        got_j = _jax_fold(lambda i: i.astype(jnp.float32),
                          lambda c, p: c * 2.0 + p, jnp.zeros(()), 6, proto,
                          depth)
        outs[proto] = _port_fold(lambda i: torch.tensor(float(i)),
                                 lambda c, p: c * 2.0 + p, torch.zeros(()),
                                 6, proto, depth)
        assert outs[proto].item() == float(got_j) == 57.0
    assert all(torch.equal(outs[p], outs["bs"]) for p in PROTOCOLS)


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
@pytest.mark.parametrize("proto", PROTOCOLS)
def test_stream_offload_schedule(proto, depth):
    """Each chunk is produced once; BS produces all before the first fold,
    RP alternates, AXLE issues producer(i + max(1, depth - 1)) before
    consumer(i)."""
    events = []

    def producer(i):
        events.append(("p", i))
        return i

    def consumer(carry, p):
        events.append(("c", p))
        return carry + [p]

    n = 5
    assert _port_fold(producer, consumer, [], n, proto, depth) == \
        list(range(n))
    assert sorted(i for kind, i in events if kind == "p") == list(range(n))
    at = {e: k for k, e in enumerate(events)}
    ahead = {"bs": n, "rp": 0, "axle": max(1, depth - 1)}[proto]
    for i in range(n):
        for j in range(n):
            produced_first = at[("p", j)] < at[("c", i)]
            assert produced_first == (j <= i + ahead), (i, j, events)


def test_axle_on_cpu_tensors_takes_no_side_stream(monkeypatch):
    """The side stream follows the carry's device, not the host's GPU: a
    CPU fold under AXLE runs the plain loop even where CUDA is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_stream(device):
        raise AssertionError("a side stream for a CPU carry")

    monkeypatch.setattr(bs, "_side_stream", no_stream)
    got = _port_fold(lambda i: torch.tensor(float(i)),
                     lambda c, p: c * 2.0 + p, torch.zeros(()), 6, "axle", 2)
    assert got.item() == 57.0


def _jax_example_run(queries, db, proto):
    """The JAX example's producer and consumer (examples/knn_offload.py),
    on the given inputs."""
    chunks = db.reshape(knn_offload.CHUNKS, -1, db.shape[1])
    k = knn_offload.K

    def producer(i):
        return jops.knn_distances(queries, chunks[i], blk_q=64, blk_n=64)

    def consumer(carry, dists):
        top_d, top_i = carry
        neg, local = jax.lax.top_k(-dists, k)
        merged_d = jnp.concatenate([top_d, -neg], axis=1)
        merged_i = jnp.concatenate([top_i, local], axis=1)
        best = jnp.argsort(merged_d, axis=1)[:, :k]
        return (jnp.take_along_axis(merged_d, best, 1),
                jnp.take_along_axis(merged_i, best, 1))

    init = (jnp.full((queries.shape[0], k), jnp.inf),
            jnp.zeros((queries.shape[0], k), jnp.int32))
    out = _jax_fold(producer, consumer, init, knn_offload.CHUNKS, proto, 2)
    return np.asarray(out[0]), np.asarray(out[1])


def test_knn_offload_example_matches_jax_example():
    rng = np.random.default_rng(0)
    queries = rng.standard_normal((knn_offload.Q, knn_offload.D)).astype(
        np.float32)
    db = rng.standard_normal((knn_offload.N, knn_offload.D)).astype(
        np.float32)
    tq, tx = torch.from_numpy(queries), torch.from_numpy(db)
    want_d, want_i = _jax_example_run(jnp.asarray(queries), jnp.asarray(db),
                                      "axle")
    outs = {}
    for proto in PROTOCOLS:
        p = bs.OffloadProtocol(proto)
        with bs.use_offload(bs.OffloadConfig(protocol=p, ring_depth=2)):
            outs[proto] = knn_offload.knn_stream(
                tq, tx, knn_offload.K, knn_offload.CHUNKS, p)
    got_d, got_i = outs["axle"]
    for proto in PROTOCOLS:
        assert torch.equal(outs[proto][0], got_d)
        assert torch.equal(outs[proto][1], got_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-4, rtol=0)
    # ids: equal unless the JAX run's candidate at that place lies within
    # 1e-4 of the port's (a near tie, decided by the last bits)
    size = knn_offload.N // knn_offload.CHUNKS
    full = ops.knn_distances(tq, tx).numpy()
    for r, c in zip(*np.nonzero(got_i.numpy() != want_i)):
        cand = [full[r, ch * size + want_i[r, c]]
                for ch in range(knn_offload.CHUNKS)]
        assert min(abs(x - got_d[r, c].item()) for x in cand) <= 1e-4


def test_knn_stream_global_ids_give_the_top_k_of_the_whole_db():
    rng = np.random.default_rng(3)
    tq = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    tx = torch.from_numpy(rng.standard_normal((400, 32)).astype(np.float32))
    dists, ids = knn_offload.knn_stream(tq, tx, 5, 4, bs.OffloadProtocol.AXLE,
                                        global_ids=True)
    want_d, want_i = ops.knn_topk(tq, tx, 5)
    torch.testing.assert_close(dists, want_d, atol=1e-4, rtol=0)
    assert torch.equal(ids, want_i)


def test_knn_stream_refuses_uneven_chunks():
    with pytest.raises(ValueError, match="equal chunks"):
        knn_offload.knn_stream(torch.zeros((2, 4)), torch.zeros((10, 4)), 1,
                               4, bs.OffloadProtocol.BS)


def test_knn_offload_example_runs_on_the_cpu(capsys):
    before = dict(kbuild.LAUNCHES)
    outs = knn_offload.main(["--device", "cpu"])
    assert set(outs) == set(bs.OffloadProtocol)
    assert "all protocols agree" in capsys.readouterr().out
    assert kbuild.LAUNCHES == before


def test_knn_offload_example_needs_a_gpu_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        knn_offload.main([])
