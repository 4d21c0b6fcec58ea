"""gemma3_12b's sliding window through the routes where it meets other
code, held to the JAX server: an int8 KV cache (per-page scales under a
moving window, the fused decode's int8 branch) and the `rp` schedule (the
chunked partials under the window's validity mask, over the fp cache and
over the int8 cache dequantized up front).

Smoke gemma3 (6 layers: five "local" of window 32 to one "full", head dim
16), 2 slots, max_seq 128 in pages of 16, seg_len 8, `rp` in 4 chunks of
32 rows (so whole chunks fall outside a window), the weights of
jax.random.key(0) crossed over through `repro_torch.interop`.  Prompts
from a numpy seed: two of 40-70 tokens (past the window) and one of 20
whose 24 new tokens decode across position 32.

Bars: in f32 arithmetic (both packages' configs in float32) the tokens
equal the JAX server's under (int8 KV, axle), (fp KV, rp) and (int8 KV,
rp); in bf16 they agree but where a stream parts at a near tie (the two
choices' logits within 0.1 in the port's prefill of the common prefix,
the gate of tests/test_quant.py).  Inside the port: streamed == per-token
and rp == axle under int8, bitwise; with every layer "full" the int8
serve's tokens change (the window bites)."""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve                       # noqa: E402
from repro.launch import steps as jsteps                       # noqa: E402
from repro_torch import interop                                # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.launch import steps as tsteps                 # noqa: E402
from repro_torch.models import transformer as T                # noqa: E402

ARCH = "gemma3_12b"
SLOTS, MAX_SEQ, PAGE, SEG_LEN, CHUNKS, MAX_NEW = 2, 128, 16, 8, 4, 24
NEAR_TIE = 0.1
CPU = torch.device("cpu")
CASES = [("int8", "axle"), (None, "rp"), ("int8", "rp")]
IDS = ["int8-axle", "fp-rp", "int8-rp"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: faster at smoke size, and it leaves the cores
    to the other test processes.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    lens = [int(rng.integers(40, 65)), int(rng.integers(40, 65)), 20]
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


@contextlib.contextmanager
def _dtype(dtype):
    """Both packages' smoke configs in `dtype` ("float32"), or as they
    are (None)."""
    with pytest.MonkeyPatch.context() as mp:
        if dtype is not None:
            for mod in (jserve, tserve):
                orig = mod.get_smoke_config
                mp.setattr(mod, "get_smoke_config", lambda a, _o=orig:
                           dataclasses.replace(_o(a), dtype=dtype))
        yield


def _tokens(srv):
    return {r.rid: list(r.generated) for r in srv.completed}


def _jax_server(kv, protocol):
    srv = jserve.BatchedServer(
        ARCH, smoke=True, batch_slots=SLOTS, max_seq=MAX_SEQ,
        protocol=protocol, chunks_per_shard=CHUNKS, stream=True,
        seg_len=SEG_LEN, page_size=PAGE, quant=jsteps.QuantConfig(kv=kv))
    for i, p in enumerate(_prompts(srv.cfg.vocab)):
        srv.submit(jserve.Request(i, p, MAX_NEW))
    srv.run_until_drained()
    return srv


def _port_server(params, kv, protocol, stream=True, cfg=None):
    srv = tserve.BatchedServer(
        ARCH, smoke=True, device="cpu", batch_slots=SLOTS, max_seq=MAX_SEQ,
        protocol=protocol, chunks_per_shard=CHUNKS, stream=stream,
        seg_len=SEG_LEN, page_size=PAGE, params=params, cfg=cfg,
        quant=tsteps.QuantConfig(kv=kv))
    for i, p in enumerate(_prompts(srv.cfg.vocab)):
        srv.submit(tserve.Request(i, p, MAX_NEW))
    srv.run_until_drained()
    assert srv.pages_allocated == srv.pages_freed > 0
    assert srv.pages_resident == 0
    return srv


@pytest.fixture(scope="module")
def servers():
    """Drained servers, built once: ("jax" | "port", dtype, kv, protocol),
    and the port's per-token and all-"full" twins in bf16."""
    runs = {}

    def get(side, dtype, kv, protocol, stream=True, full=False):
        key = (side, dtype, kv, protocol, stream, full)
        if key not in runs:
            with _dtype(dtype):
                if side == "jax":
                    runs[key] = _jax_server(kv, protocol)
                else:
                    jsrv = get("jax", dtype, kv, protocol)
                    params = interop.params_from_jax(
                        jax.tree.map(np.asarray, jsrv.params), CPU)
                    cfg = None
                    if full:
                        cfg = tserve.get_smoke_config(ARCH)
                        cfg = dataclasses.replace(cfg, block_pattern=(
                            "full",) * len(cfg.block_pattern))
                    runs[key] = _port_server(params, kv, protocol, stream,
                                             cfg)
        return runs[key]

    return get


def test_workload_crosses_the_window():
    """The prompts pass the smoke window, and the short one decodes across
    it: the window masks in the prefill and moves in the decode."""
    cfg = tserve.get_smoke_config(ARCH)
    w = cfg.sliding_window
    lens = [len(p) for p in _prompts(cfg.vocab)]
    assert w == 32 and cfg.block_pattern.count("local") == 5
    assert all(n > w for n in lens[:2])
    assert lens[2] < w < lens[2] + MAX_NEW
    assert max(lens) + MAX_NEW <= MAX_SEQ and MAX_SEQ % (CHUNKS * w) == 0


@pytest.mark.parametrize("kv,protocol", CASES, ids=IDS)
def test_tokens_equal_jax_in_f32(servers, kv, protocol):
    tsrv = servers("port", "float32", kv, protocol)
    jsrv = servers("jax", "float32", kv, protocol)
    assert tsrv.cfg.dtype == jsrv.cfg.dtype == "float32"
    assert T.cache_kv_quant(tsrv.cache) == kv
    got, want = _tokens(tsrv), _tokens(jsrv)
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == want
    assert (tsrv.decode_syncs, tsrv.host_syncs) == \
        (jsrv.decode_syncs, jsrv.host_syncs)
    assert tsrv.pages_resident_peak == jsrv.pages_resident_peak


@pytest.mark.parametrize("kv,protocol", CASES, ids=IDS)
def test_tokens_bf16_near_tie_gate(servers, kv, protocol):
    tsrv = servers("port", None, kv, protocol)
    jsrv = servers("jax", None, kv, protocol)
    assert tsrv.cfg.dtype == "bfloat16"
    got, want = _tokens(tsrv), _tokens(jsrv)
    prompts = _prompts(tsrv.cfg.vocab)
    assert got.keys() == want.keys()
    for rid, a in got.items():
        b = want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[rid], np.asarray(a[:t], np.int32)])
        cache = T.init_cache(tsrv.cfg, 1, MAX_SEQ, device=CPU,
                             page_size=PAGE)
        lg, _ = T.prefill_into_cache(tsrv.cfg, tsrv.params, cache,
                                     torch.from_numpy(seq), 0, len(seq))
        gap = (lg[a[t]] - lg[b[t]]).abs().item()
        assert gap < NEAR_TIE, (rid, t, gap)


@pytest.mark.parametrize("protocol", ["axle", "rp"])
def test_int8_streamed_equals_per_token_bitwise(servers, protocol):
    streamed = servers("port", None, "int8", protocol)
    per_token = servers("port", None, "int8", protocol, stream=False)
    assert _tokens(streamed) == _tokens(per_token)
    assert per_token.decode_syncs > streamed.decode_syncs


def test_int8_rp_equals_axle(servers):
    """The chunked schedule over the dequantized pools gives the fused
    int8 schedule's tokens, as for starcoder2_3b
    (tests/test_torch_quant_serve.py)."""
    assert _tokens(servers("port", None, "int8", "rp")) \
        == _tokens(servers("port", None, "int8", "axle"))


def test_int8_pools_and_scales_under_055_of_bf16(servers):
    srv = servers("port", None, "int8", "axle")
    int8 = sum(v.numel() * v.element_size() for k, v in srv.cache.items()
               if k[0] in "kv")
    fp = T.init_cache(srv.cfg, SLOTS, MAX_SEQ, device=CPU, page_size=PAGE)
    bf16 = sum(v.numel() * v.element_size() for k, v in fp.items()
               if k[0] in "kv")
    assert srv.cache["k0"].dtype == torch.int8
    assert int8 <= 0.55 * bf16


def test_the_window_bites_under_int8(servers):
    """The same weights with every layer "full" serve other tokens."""
    windowed = servers("port", None, "int8", "axle")
    full = servers("port", None, "int8", "axle", full=True)
    assert set(full.cfg.block_pattern) == {"full"}
    assert _tokens(full) != _tokens(windowed)
