"""Parity of the port's mamba2_370m serve path with the JAX package at
smoke size (SMOKE: 2 layers, d 64, d_inner 128, 8 SSM heads of P 16,
state N 16, conv width 4), with the JAX weights crossed over through
`repro_torch.interop`: the config, the conv and SSD-step layers, the
prefill's recurrent states, greedy decode, and the server on the
`decode_stream.stream.mamba2_370m` workload of
benchmarks/decode_stream.py (2 slots, max_seq 64, seg_len 8, 4 greedy
requests of max_new 16).

Tolerances: float32 runs (`dtype="float32"` in both packages) hold
logits and states to atol = 1e-4 — the frameworks order their f32 sums
differently, through two layers.  bf16 decode: greedy tokens agree
except at a near tie (the two best logits within 0.1, the gate of
tests/test_quant.py).  The bf16 server's tokens must equal the JAX
server's (the same bf16 arithmetic up to summation order; at this size
no step lands on a near tie).  Inside the port, streamed == per-token
and the protocol choice are bitwise."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_config as jax_get_config        # noqa: E402
from repro.configs import get_smoke_config as jax_smoke       # noqa: E402
from repro.launch import serve as jserve                      # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro.models import transformer as JT                    # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels import ssd as kssd                   # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402
from repro_torch.models import transformer as T              # noqa: E402

ARCH = "mamba2_370m"
ATOL = 1e-4
CPU = torch.device("cpu")
SLOTS, MAX_SEQ, SEG_LEN, N_REQ, MAX_NEW = 2, 64, 8, 4, 16


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_is_the_reference_config(smoke):
    get_t, get_j = ((get_smoke_config, jax_smoke) if smoke
                    else (get_config, jax_get_config))
    assert dataclasses.asdict(get_t(ARCH)) == dataclasses.asdict(get_j(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_width, cfg.d_ff,
            cfg.vocab) == (48, 1024, 2048, 32, 64, 128, 4, 0, 50280)


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_parity(with_state):
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((2, 5, 12)), rng.standard_normal((4, 12))
    st = rng.standard_normal((2, 3, 12)) if with_state else None
    y, new = L.causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
    y_j, new_j = JL.causal_conv1d(_j(x), _j(w),
                                  None if st is None else _j(st))
    np.testing.assert_allclose(_np(y), _np(y_j), atol=1e-5)
    np.testing.assert_array_equal(_np(new), _np(new_j))


def test_ssd_decode_step_parity():
    rng = np.random.default_rng(1)
    b, h, p, n = 2, 3, 4, 8
    state = rng.standard_normal((b, h, p, n))
    x, B, C = (rng.standard_normal(s) for s in ((b, h, p), (b, n), (b, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, h))))
    A = -np.exp(0.3 * rng.standard_normal(h))
    y, new = L.ssd_decode_step(*map(_t, (state, x, dt, A, B, C)))
    y_j, new_j = JL.ssd_decode_step(*map(_j, (state, x, dt, A, B, C)))
    assert new.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_j), atol=1e-5)
    np.testing.assert_allclose(_np(new), _np(new_j), atol=1e-5)


# ------------------------------------------------------------ params, cache

def _flat(tree):
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_init_params_and_cache_match_reference_layout():
    """The port's own draw and its cache have the reference's trees,
    shapes and dtypes: `mamba` leaves, no `ffn` (d_ff = 0), and conv/ssm
    states with no page table."""
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    want = _flat(jax.eval_shape(functools.partial(JT.init_params, jcfg),
                                jax.random.key(0)))
    got = _flat(jax.tree.map(lambda t: t, T.init_params(
        tcfg, torch.Generator().manual_seed(0), CPU)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype) == f"torch.{w.dtype}", k
    jc = JT.init_cache(jcfg, 3, MAX_SEQ)
    tc = T.init_cache(tcfg, 3, MAX_SEQ, device=CPU)
    assert set(tc) == set(jc) == {"pos", "conv0", "ssm0"}
    for k, w in jc.items():
        assert tuple(tc[k].shape) == w.shape, k
        assert str(tc[k].dtype) == f"torch.{w.dtype}", k
    model = T.Transformer(tcfg, T.init_params(
        tcfg, torch.Generator().manual_seed(0), CPU))
    assert "blocks.0.mamba.w_z" in model.state_dict()


# ----------------------------------------------------- prefill and decode

LENGTHS = (7, 2)
N_STEPS = 16


def _run_both(dtype):
    """Prefill two rows (row 1's prompt shorter than the conv width), then
    N_STEPS decode steps with the JAX greedy token fed to both, row 1
    write-masked every fourth step.  Returns per-step (jax logits, port
    logits), the caches after prefill and after the last step."""
    jcfg, tcfg, jp, tp = _setup(dtype)
    rng = np.random.default_rng(4)
    jcache = JT.init_cache(jcfg, len(LENGTHS), MAX_SEQ)
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), CPU)
    jprefill = jax.jit(functools.partial(JT.prefill_into_cache, jcfg))
    jdecode = jax.jit(functools.partial(JT.decode_step, jcfg))
    out, first = [], []
    for row, n in enumerate(LENGTHS):
        prompt = np.zeros(16, np.int32)
        prompt[:n] = rng.integers(1, jcfg.vocab, n)
        jl, jcache = jprefill(jp, jcache, jnp.asarray(prompt), row, n)
        tl, tcache = T.prefill_into_cache(tcfg, tp, tcache,
                                          torch.from_numpy(prompt), row, n)
        out.append((jl, tl))
        first.append(int(jnp.argmax(jl)))
    prefilled = ({k: np.asarray(v) for k, v in jcache.items()},
                 {k: v.clone() for k, v in tcache.items()})
    toks = np.asarray(first, np.int32)[:, None]
    pos = np.asarray(LENGTHS, np.int32)
    for t in range(N_STEPS):
        mask = np.array([True, t % 4 != 3])
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks),
                             positions=jnp.asarray(pos),
                             write_mask=jnp.asarray(mask))
        tl, tcache = T.decode_step(tcfg, tp, tcache, torch.from_numpy(toks),
                                   positions=torch.from_numpy(pos),
                                   write_mask=torch.from_numpy(mask))
        out.append((jl[:, -1], tl[:, -1]))
        toks = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + mask.astype(np.int32)
    return out, prefilled, (jcache, tcache)


@functools.lru_cache(maxsize=None)
def _f32_run():
    return _run_both("float32")


def test_prefill_into_cache_parity_f32():
    """Last-token prefill logits and the conv / SSM states written into
    each row, a prompt shorter than the conv width included."""
    out, (jcache, tcache), _ = _f32_run()
    for jl, tl in out[:len(LENGTHS)]:
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for key in ("conv0", "ssm0"):
        assert tcache[key].any()
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=ATOL)


def test_decode_step_parity_f32():
    """16 greedy decode steps: logits per step, and the states after,
    write-masked steps included."""
    out, _, (jcache, tcache) = _f32_run()
    assert len(out) == len(LENGTHS) + N_STEPS
    for i, (jl, tl) in enumerate(out):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(
            _np(tl).reshape(-1, tl.shape[-1]).argmax(-1),
            _np(jl).reshape(-1, jl.shape[-1]).argmax(-1))
    for key in ("conv0", "ssm0"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=ATOL)


def test_decode_step_tokens_bf16_near_tie_gate():
    """bf16: greedy tokens agree except where JAX's two best logits lie
    within 0.1 (the gate of tests/test_quant.py)."""
    out, _, _ = _run_both("bfloat16")
    flips = 0
    for i, (jl, tl) in enumerate(out):
        jn = _np(jl).reshape(-1, jl.shape[-1])
        tn = _np(tl).reshape(-1, tl.shape[-1])
        assert np.isfinite(tn).all()
        for r in range(jn.shape[0]):
            a, b = int(jn[r].argmax()), int(tn[r].argmax())
            if a != b:
                flips += 1
                gap = float(jn[r, a] - jn[r, b])
                assert 0.0 <= gap < 0.1, (i, r, gap)
    assert flips <= 2, flips


def test_prefill_hands_the_kernel_what_it_takes(monkeypatch):
    """The scan inputs that `_prefill_mamba` builds pass every check of
    the CUDA wrapper but the device (contiguity, dtypes, shapes), in the
    bf16 model, at a prompt bucket that is not a power of two."""
    _, tcfg, _, tp = _setup("bfloat16")
    seen = []

    def checked(*args):
        seen.append(kssd.check_args(*args))
        return ref.ssd_reference(*args)

    monkeypatch.setattr(ops, "ssd_scan", checked)
    cache = T.init_cache(tcfg, 1, MAX_SEQ, device=CPU)
    prompt = torch.arange(1, 13, dtype=torch.int32)
    T.prefill_into_cache(tcfg, tp, cache, prompt, 0, 9)
    assert seen == [(1, 12, tcfg.n_ssm_heads, tcfg.ssm_head_dim,
                     tcfg.ssm_state)] * tcfg.n_layers


def test_write_mask_freezes_recurrent_state():
    """A masked row keeps its conv and SSM state bit for bit."""
    _, tcfg, _, tp = _setup("float32")
    cache = T.init_cache(tcfg, 2, MAX_SEQ, device=CPU)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    _, cache = T.decode_step(tcfg, tp, cache, toks, positions=pos)
    before = {k: v.clone() for k, v in cache.items()}
    _, cache = T.decode_step(tcfg, tp, cache, toks, positions=pos + 1,
                             write_mask=torch.tensor([True, False]))
    for key in ("conv0", "ssm0"):
        assert torch.equal(cache[key][:, 1], before[key][:, 1])
        assert not torch.equal(cache[key][:, 0], before[key][:, 0])


def test_prefill_state_equals_stepping_the_prompt():
    """A padded prompt prefilled at once leaves the state that decode
    steps over the prompt, one token at a time, leave: the dt = 0 tail
    and the conv window at `length` carry no junk."""
    _, tcfg, _, tp = _setup("float32")
    prompt = np.zeros(16, np.int32)
    prompt[:11] = np.random.default_rng(6).integers(1, tcfg.vocab, 11)
    pre = T.init_cache(tcfg, 1, MAX_SEQ, device=CPU)
    lp, pre = T.prefill_into_cache(tcfg, tp, pre, torch.from_numpy(prompt),
                                   0, 11)
    step = T.init_cache(tcfg, 1, MAX_SEQ, device=CPU)
    i32 = torch.int32
    for t in range(11):
        ls, step = T.decode_step(tcfg, tp, step,
                                 torch.tensor([[prompt[t]]], dtype=i32),
                                 positions=torch.tensor([t], dtype=i32))
    np.testing.assert_allclose(_np(lp), _np(ls[0, -1]), atol=ATOL)
    for key in ("conv0", "ssm0"):
        np.testing.assert_allclose(_np(pre[key]), _np(step[key]), atol=ATOL)


# ------------------------------------------------------------------ server

def _workload(make, vocab, stops=()):
    """benchmarks/decode_stream.py's request draw."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(N_REQ):
        plen = int(rng.integers(3, 7))
        out.append(make(i, rng.integers(1, vocab, plen).astype(np.int32),
                        stops))
    return out


def _jax_server(stops=()):
    srv = jserve.BatchedServer(ARCH, smoke=True, batch_slots=SLOTS,
                               max_seq=MAX_SEQ, protocol="bs", stream=True,
                               seg_len=SEG_LEN)
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


def _port_server(protocol="bs", stream=True, stops=()):
    srv = _LedgerChecked(ARCH, smoke=True, device="cpu", batch_slots=SLOTS,
                         max_seq=MAX_SEQ, protocol=protocol, stream=stream,
                         seg_len=SEG_LEN, params=_params())
    for r in _workload(lambda i, p, s: tserve.Request(
            i, p, MAX_NEW, stop_tokens=s), srv.cfg.vocab, stops):
        srv.submit(r)
    srv.run_until_drained()
    return srv


def _tokens(srv):
    return {r.rid: list(r.generated) for r in srv.completed}


@functools.lru_cache(maxsize=None)
def _jax_stream():
    return _jax_server()


def test_stream_slice_matches_jax_server():
    jsrv = _jax_stream()
    tsrv = _port_server()
    assert "page_table" not in tsrv.cache
    assert _tokens(tsrv) == _tokens(jsrv)
    n_tok = sum(len(t) for t in _tokens(tsrv).values())
    assert n_tok == N_REQ * MAX_NEW
    # BENCH_decode.json's decode_stream.stream.mamba2_370m row
    assert tsrv.decode_syncs / n_tok == 0.0625
    assert tsrv.decode_syncs == jsrv.decode_syncs
    assert tsrv.host_syncs == jsrv.host_syncs
    assert tsrv.ledger_checks == tsrv.decode_syncs
    assert tsrv.page_size == jsrv.page_size
    assert tsrv.pages_allocated == tsrv.pages_freed > 0
    assert tsrv.pages_resident == 0
    assert tsrv.pages_resident_peak == jsrv.pages_resident_peak


def test_protocol_has_no_effect_without_attention():
    """Every protocol is accepted and gives the same tokens bit for bit:
    no attention runs."""
    base = _tokens(_port_server("bs"))
    for protocol in ("axle", "rp"):
        assert _tokens(_port_server(protocol)) == base


def test_stop_tokens_match_jax_server():
    """The write-masked variant: requests that stop at a token they emit
    end as the JAX server's do."""
    stop = (_tokens(_jax_stream())[0][3],)
    jsrv = _jax_server(stops=stop)
    tsrv = _port_server(stops=stop)
    assert _tokens(tsrv) == _tokens(jsrv)
    assert _tokens(tsrv)[0][-1] == stop[0]
    assert tsrv.pages_allocated == tsrv.pages_freed


@pytest.mark.parametrize("stops", [(), "emitted"])
def test_streamed_equals_per_token_bitwise(stops):
    if stops:
        stops = (_tokens(_port_server())[1][5],)
    streamed = _port_server(stream=True, stops=stops)
    per_token = _port_server(stream=False, stops=stops)
    assert _tokens(streamed) == _tokens(per_token)
    assert per_token.decode_syncs > streamed.decode_syncs
    if not stops:
        # BENCH_decode.json's per-token row
        assert per_token.decode_syncs / (N_REQ * MAX_NEW) == 0.46875
