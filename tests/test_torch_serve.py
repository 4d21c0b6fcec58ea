"""Slice parity of the port's serving main path with the JAX server, on
the `decode_stream.stream` workload of benchmarks/decode_stream.py: smoke
starcoder2_3b, 2 slots, max_seq 64, seg_len 8, 4 greedy requests of
max_new 16, prompts drawn as there.  The port serves the JAX server's own
weights, crossed through `repro_torch.interop`; tokens must be equal (the
two run the same bf16 arithmetic up to summation order, and at this size
no step lands on a near tie).  Inside the port, streamed == per-token and
paged (shuffled tables) == identity tables, bit for bit."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve                      # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402

ARCH = "starcoder2_3b"
SLOTS, MAX_SEQ, SEG_LEN, N_REQ, MAX_NEW = 2, 64, 8, 4, 16


def _workload(make, vocab, stops=()):
    """benchmarks/decode_stream.py's request draw."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(N_REQ):
        plen = int(rng.integers(3, 7))
        out.append(make(i, rng.integers(1, vocab, plen).astype(np.int32),
                        stops))
    return out


def _jax_server(protocol, stops=()):
    srv = jserve.BatchedServer(ARCH, smoke=True, batch_slots=SLOTS,
                               max_seq=MAX_SEQ, protocol=protocol,
                               stream=True, seg_len=SEG_LEN)
    sampling = jserve.SamplingParams(stop_tokens=stops) if stops else None
    for r in _workload(lambda i, p, s: jserve.Request(
            i, p, MAX_NEW, sampling=sampling), srv.cfg.vocab):
        srv.submit(r)
    srv.run_until_drained()
    return srv


_PARAMS = {}


def _params():
    """The JAX server's weights (jax.random.key(0)), crossed over once."""
    if not _PARAMS:
        srv = jserve.BatchedServer(ARCH, smoke=True, batch_slots=1,
                                   max_seq=16)
        _PARAMS["p"] = interop.params_from_jax(
            jax.tree.map(np.asarray, srv.params), "cpu")
    return _PARAMS["p"]


class _LedgerChecked(tserve.BatchedServer):
    """Asserts the page ledger after every consumed segment."""

    def _consume_segment(self, *a, **kw):
        super()._consume_segment(*a, **kw)
        self.assert_ledger()
        self.ledger_checks = getattr(self, "ledger_checks", 0) + 1


def _port_server(protocol="bs", stream=True, stops=(), shuffle=False,
                 page_size=None):
    srv = _LedgerChecked(ARCH, smoke=True, device="cpu", batch_slots=SLOTS,
                         max_seq=MAX_SEQ, protocol=protocol, stream=stream,
                         seg_len=SEG_LEN, page_size=page_size,
                         params=_params())
    if shuffle:
        pt = srv.cache["page_table"]
        rng = np.random.default_rng(13)
        srv.cache["page_table"] = torch.from_numpy(np.stack(
            [rng.permutation(pt.shape[1]) for _ in range(pt.shape[0])]
        ).astype(np.int32))
    for r in _workload(lambda i, p, s: tserve.Request(
            i, p, MAX_NEW, stop_tokens=s), srv.cfg.vocab, stops):
        srv.submit(r)
    srv.run_until_drained()
    return srv


def _tokens(srv):
    return {r.rid: list(r.generated) for r in srv.completed}


@pytest.mark.parametrize("protocol", ["bs", "rp"])
def test_stream_slice_matches_jax_server(protocol):
    jsrv = _jax_server(protocol)
    tsrv = _port_server(protocol)
    assert _tokens(tsrv) == _tokens(jsrv)
    n_tok = sum(len(t) for t in _tokens(tsrv).values())
    assert n_tok == N_REQ * MAX_NEW
    # BENCH_decode.json's decode_stream.stream row
    assert tsrv.decode_syncs / n_tok == 0.0625
    assert tsrv.decode_syncs == jsrv.decode_syncs
    assert tsrv.host_syncs == jsrv.host_syncs
    assert tsrv.ledger_checks == tsrv.decode_syncs
    assert tsrv.pages_allocated == tsrv.pages_freed > 0
    assert tsrv.pages_resident == 0
    assert tsrv.pages_resident_peak == jsrv.pages_resident_peak


def test_stop_tokens_match_jax_server():
    """The write-masked variant: requests that stop at a token they emit
    (the first generated token of request 0) end as the JAX server's do."""
    free = _tokens(_port_server("axle"))
    stop = (free[0][3],)
    jsrv = _jax_server("axle", stops=stop)
    tsrv = _port_server("axle", stops=stop)
    assert _tokens(tsrv) == _tokens(jsrv)
    assert _tokens(tsrv)[0][-1] == stop[0]
    assert tsrv.pages_allocated == tsrv.pages_freed


@pytest.mark.parametrize("stops", [(), "emitted"])
def test_streamed_equals_per_token_bitwise(stops):
    if stops:
        stops = (_tokens(_port_server("bs"))[1][5],)
    streamed = _port_server("bs", stream=True, stops=stops)
    per_token = _port_server("bs", stream=False, stops=stops)
    assert _tokens(streamed) == _tokens(per_token)
    assert per_token.decode_syncs > streamed.decode_syncs


@pytest.mark.parametrize("protocol", ["bs", "rp"])
def test_shuffled_page_tables_equal_identity_bitwise(protocol):
    """8-position pages placed by a shuffled table give the identity
    table's tokens exactly."""
    assert _tokens(_port_server(protocol, page_size=8, shuffle=True)) \
        == _tokens(_port_server(protocol, page_size=8))


def test_server_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.BatchedServer(ARCH)
