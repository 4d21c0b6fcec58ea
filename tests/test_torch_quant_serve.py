"""Slice parity of the port's quantized serving with the JAX server: smoke
starcoder2_3b, 2 slots, max_seq 64, page 16, seg_len 8, 4 greedy requests
of max_new 16 (64 tokens, streamed), under (q8_0 weights, int8 KV), (q4_k,
fp KV) and (fp, int8 KV); and smoke mamba2_370m under q8_0.  Both servers
serve the weights of jax.random.key(0): the JAX server quantizes its own,
the port quantizes them after they cross through `repro_torch.interop`,
and the two quantized trees are checked equal bit for bit.

Greedy tokens must agree except at a near tie: where a request's streams
part, the two best logits of the port's own prefill of the common prefix
lie within 0.1 of each other (the gate of tests/test_quant.py).  Inside
the port: streamed == per-token bitwise, `rp` == `axle` under int8, the
ledger closed after every segment, and the int8 pools (quants plus
scales) at most 0.55 of the bf16 pools' bytes."""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.launch import steps as jsteps                       # noqa: E402
from repro.models import transformer as JT                     # noqa: E402
from repro_torch import interop                                # noqa: E402
from repro_torch.kernels.quant import QTensor                  # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.launch import steps as tsteps                 # noqa: E402
from repro_torch.models import transformer as T                # noqa: E402

ARCH, MAMBA = "starcoder2_3b", "mamba2_370m"
SLOTS, MAX_SEQ, PAGE, SEG_LEN, N_REQ, MAX_NEW = 2, 64, 16, 8, 4, 16
NEAR_TIE = 0.1
CONFIGS = [("q8_0", "int8"), ("q4_k", None), (None, "int8")]
CPU = torch.device("cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, int(rng.integers(3, 7))).astype(np.int32)
            for _ in range(N_REQ)]


def _page(arch):
    return PAGE if arch == ARCH else None


@pytest.fixture(scope="module")
def jax_server():
    """One drained JAX server per (arch, weights, kv), built once."""
    runs = {}

    def get(arch, weights, kv):
        key = (arch, weights, kv)
        if key not in runs:
            srv = jserve.BatchedServer(
                arch, smoke=True, batch_slots=SLOTS, max_seq=MAX_SEQ,
                protocol="axle", stream=True, seg_len=SEG_LEN,
                page_size=_page(arch),
                quant=jsteps.QuantConfig(weights=weights, kv=kv))
            for i, p in enumerate(_prompts(srv.cfg.vocab)):
                srv.submit(jserve.Request(i, p, MAX_NEW))
            srv.run_until_drained()
            runs[key] = srv
        return runs[key]

    return get


@functools.lru_cache(maxsize=None)
def _fp_params(arch):
    """The JAX server's fp weights (jax.random.key(0)), crossed over."""
    jp = JT.init_params(jax_smoke_config(arch), jax.random.key(0))
    return interop.params_from_jax(jax.tree.map(np.asarray, jp), CPU)


class _LedgerChecked(tserve.BatchedServer):
    """Asserts the page ledger after every consumed segment."""

    def _consume_segment(self, *a, **kw):
        super()._consume_segment(*a, **kw)
        self.assert_ledger()
        self.ledger_checks = getattr(self, "ledger_checks", 0) + 1


def _port_server(weights, kv, arch=ARCH, protocol="axle", stream=True):
    srv = _LedgerChecked(arch, smoke=True, device="cpu", batch_slots=SLOTS,
                         max_seq=MAX_SEQ, protocol=protocol, stream=stream,
                         seg_len=SEG_LEN, page_size=_page(arch),
                         params=_fp_params(arch),
                         quant=tsteps.QuantConfig(weights=weights, kv=kv))
    for i, p in enumerate(_prompts(srv.cfg.vocab)):
        srv.submit(tserve.Request(i, p, MAX_NEW))
    srv.run_until_drained()
    return srv


def _tokens(srv):
    return {r.rid: list(r.generated) for r in srv.completed}


def _assert_near_tie_agree(tsrv, jsrv, arch=ARCH):
    """Equal streams, or streams that part at a near tie of the port's
    prefill logits on the common prefix (the prefill attends over fp K/V
    whatever the cache holds)."""
    prompts = _prompts(tsrv.cfg.vocab)
    got, want = _tokens(tsrv), _tokens(jsrv)
    assert got.keys() == want.keys()
    for rid, toks in got.items():
        if toks == want[rid]:
            continue
        t = next(i for i, (a, b) in enumerate(zip(toks, want[rid])) if a != b)
        seq = np.concatenate([prompts[rid], np.asarray(toks[:t], np.int32)])
        cache = T.init_cache(tsrv.cfg, 1, MAX_SEQ, device=CPU,
                             page_size=_page(arch))
        logits, _ = T.prefill_into_cache(tsrv.cfg, tsrv.params, cache,
                                         torch.from_numpy(seq), 0, len(seq))
        gap = (logits[toks[t]] - logits[want[rid][t]]).abs().item()
        assert gap < NEAR_TIE, (rid, t, gap)


def _kv_bytes(cache):
    return sum(v.numel() * v.element_size() for k, v in cache.items()
               if k[0] in "kv" and k[1:].isdigit()
               or k[:6] in ("kscale", "vscale"))


def _assert_same_quantized_weights(tsrv, jsrv):
    """The port quantized the crossed fp weights into the JAX server's
    quantized tree, bit for bit."""
    jq = interop.params_from_jax(jax.tree.map(np.asarray, jsrv.params), CPU)
    for sub in ("attn", "ffn"):
        for name, leaf in tsrv.params["blocks"][0][sub].items():
            want = jq["blocks"][0][sub][name]
            assert isinstance(leaf, QTensor) == isinstance(want, QTensor)
            if isinstance(leaf, QTensor):
                for a, b in ((leaf.scales, want.scales),
                             (leaf.quants, want.quants),
                             (leaf.mins, want.mins)):
                    assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("weights,kv", CONFIGS)
def test_quantized_stream_matches_jax_server(jax_server, weights, kv):
    jsrv = jax_server(ARCH, weights, kv)
    tsrv = _port_server(weights, kv)
    _assert_near_tie_agree(tsrv, jsrv)
    n_tok = sum(len(t) for t in _tokens(tsrv).values())
    assert n_tok == N_REQ * MAX_NEW
    assert tsrv.decode_syncs / n_tok == 0.0625
    assert (tsrv.decode_syncs, tsrv.host_syncs) == \
        (jsrv.decode_syncs, jsrv.host_syncs)
    assert tsrv.ledger_checks == tsrv.decode_syncs
    assert tsrv.pages_allocated == tsrv.pages_freed > 0
    assert tsrv.pages_resident == 0
    assert tsrv.pages_resident_peak == jsrv.pages_resident_peak
    if weights:
        _assert_same_quantized_weights(tsrv, jsrv)
    else:
        assert not any(isinstance(w, QTensor)
                       for w in tsrv.params["blocks"][0]["attn"].values())
    assert T.cache_kv_quant(tsrv.cache) == kv
    if kv:
        assert all(tsrv.cache[k].dtype == torch.int8 for k in ("k0", "v0"))
        fp = T.init_cache(tsrv.cfg, SLOTS, MAX_SEQ, device=CPU,
                          page_size=PAGE)
        assert _kv_bytes(tsrv.cache) <= 0.55 * _kv_bytes(fp)


@pytest.mark.parametrize("weights,kv", CONFIGS)
def test_quantized_streamed_equals_per_token_bitwise(weights, kv):
    streamed = _port_server(weights, kv, stream=True)
    per_token = _port_server(weights, kv, stream=False)
    assert _tokens(streamed) == _tokens(per_token)
    assert per_token.decode_syncs > streamed.decode_syncs


@pytest.mark.parametrize("weights", ["q8_0", None])
def test_rp_equals_axle_under_int8(weights):
    """The chunked schedule (pools dequantized up front) gives the fused
    int8 schedule's tokens."""
    assert _tokens(_port_server(weights, "int8", protocol="rp")) \
        == _tokens(_port_server(weights, "int8", protocol="axle"))


def test_mamba_q8_0_matches_jax_server(jax_server):
    """mamba2_370m under q8_0: w_z, w_x and out_proj quantized (the
    small B / C / dt projections stay fp), tokens as the JAX server's."""
    jsrv = jax_server(MAMBA, "q8_0", None)
    tsrv = _port_server("q8_0", None, arch=MAMBA)
    mamba = tsrv.params["blocks"][0]["mamba"]
    assert all(isinstance(mamba[k], QTensor)
               for k in ("w_z", "w_x", "out_proj"))
    assert not any(isinstance(mamba[k], QTensor)
                   for k in ("w_B", "w_C", "w_dt"))
    _assert_near_tie_agree(tsrv, jsrv, MAMBA)
    assert tsrv.decode_syncs == jsrv.decode_syncs
    assert tsrv.pages_allocated == tsrv.pages_freed > 0


def test_cli_serves_quantized(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--device", "cpu", "--stream", "--requests", "2",
        "--slots", "2", "--max-seq", "64", "--quant-weights", "q4_k",
        "--quant-kv", "int8"])
    assert tserve.main() == 0
    out = capsys.readouterr().out
    assert "quant=q4_k/int8" in out and "requests=2" in out


def test_quant_config_refuses_unknown_formats():
    with pytest.raises(ValueError):
        tsteps.QuantConfig(weights="q2_k")
    with pytest.raises(ValueError):
        tsteps.QuantConfig(kv="fp8")
