"""Per-slot stochastic sampling in the port (`kernels/ref.py`,
`kernels/ops.py`, the sampled decode segment and the server's
`SamplingParams`) against the JAX package, mirroring
tests/test_sampling.py case for case.

Across the two packages, on the same f32 logits and keys: greedy rows are
argmax in both, bit for bit; sampled tokens are equal except at a near
tie of the JAX oracle's own values: the two best values of filtered +
gumbel within 1e-5, a rank's mass before it within 1e-5 of top_p, or a
probability within 1e-6 of the min_p floor (torch's `log`, softmax and
cumsum round apart from XLA's in the last bits).

Inside the port, bit for bit: greedy rows are argmax, the partial-sort
sampler (`sample_tokens_capped`) equals the full reference with its
partial path taken and with its fallback forced, and a fixed seed gives
the same served tokens at seg_len 1, 4 and 8, streamed or per-token, in
any slot and beside any batch-mates.

The servers: the port serves the JAX server's weights on the
tests/test_torch_serve.py workload (smoke starcoder2_3b, 2 slots,
max_seq 64, seg_len 8, 4 requests of 16 tokens) under bs and rp, sampled
rows (T 0.8, top_k 50, top_p 0.95) beside greedy ones, one with a stop
token.  Both run in f32 arithmetic: in bf16 the two frameworks' logits
part by bf16 units, which on the flat distribution of random weights
reorders ranks and with them the rank-indexed Gumbel draws, so bf16
sampled streams part within a few tokens (the JAX server's own bs and rp
streams do too).  Streams must be equal up to a first difference, and
that difference must lie at a near tie: the port's replayed logits at
that step, perturbed by at most 1e-4 (f32 logits of the two frameworks
agree to ~1e-6), reach both choices; for a greedy row, the two choices'
logits lie within 0.1 (the greedy near-tie gate).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops                         # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro.launch import serve as jserve                      # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.core import prng                             # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.kernels import ref                           # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402
from repro_torch.launch import steps                          # noqa: E402
from repro_torch.models import transformer                    # noqa: E402

B, V = 4, 64
Z_TIE, MASS_TIE, MIN_P_TIE = 1e-5, 1e-5, 1e-6
LOGIT_TIE_F32, NEAR_TIE = 1e-4, 0.1


def params(b=B, temperature=0.0, top_k=0, top_p=1.0, min_p=0.0):
    """One parameter set for every row, as (numpy leaves)."""
    return dict(temperature=np.full((b,), temperature, np.float32),
                top_k=np.full((b,), top_k, np.int32),
                top_p=np.full((b,), top_p, np.float32),
                min_p=np.full((b,), min_p, np.float32))


def keys_for(seed, b=B):
    return np.stack([np.asarray(jax.random.PRNGKey(seed * 1000 + i))
                     for i in range(b)]).astype(np.int64)


def logits_for(seed, b=B, v=V):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32)


def _t(p):
    return ops.BatchedSampling(**{k: torch.from_numpy(v)
                                  for k, v in p.items()})


def sample(lf, p, keys, vocab=0):
    """The port's `ops.sample_tokens` (numpy in, numpy out)."""
    return ops.sample_tokens(torch.from_numpy(lf), _t(p),
                             torch.from_numpy(keys), vocab=vocab).numpy()


def jax_sample(lf, p, keys, vocab=0):
    return np.asarray(jops.sample_tokens(
        jnp.asarray(lf), jops.BatchedSampling(**{
            k: jnp.asarray(v) for k, v in p.items()}),
        jnp.asarray(keys, jnp.uint32), vocab=vocab))


def _near_tie_rows(lf, p, keys, vocab):
    """Rows where the JAX oracle's own values sit at a near tie."""
    t, k = jnp.asarray(p["temperature"]), jnp.asarray(p["top_k"])
    tp, mp = jnp.asarray(p["top_p"]), jnp.asarray(p["min_p"])
    scaled = jref._scaled_bounded_logits(jnp.asarray(lf), t, vocab)
    order, sorted_logits, keep = jref._sorted_keep(scaled, k, tp, mp)
    probs = np.asarray(jnp.take_along_axis(jax.nn.softmax(scaled, -1),
                                           order, -1))
    cum_before = np.cumsum(probs, -1) - probs
    g = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(
        kk, (lf.shape[-1],), jnp.float32))(jnp.asarray(keys, jnp.uint32)))
    z = np.where(np.asarray(keep), np.asarray(sorted_logits), -np.inf) + g
    top2 = -np.sort(-z, -1)[:, :2]
    return ((top2[:, 0] - top2[:, 1] <= Z_TIE)
            | (np.abs(cum_before - p["top_p"][:, None]) <= MASS_TIE).any(-1)
            | (np.abs(probs - p["min_p"][:, None] * probs[:, :1])
               <= MIN_P_TIE).any(-1))


def agree(lf, p, keys, vocab=0):
    """The port's tokens, held to the JAX oracle's under the near-tie
    gate; greedy rows bitwise."""
    got, want = sample(lf, p, keys, vocab), jax_sample(lf, p, keys, vocab)
    greedy = (p["temperature"] <= 0) | (p["top_k"] == 1)
    np.testing.assert_array_equal(got[greedy], want[greedy])
    differ = got != want
    assert not (differ & ~_near_tie_rows(lf, p, keys, vocab)).any(), \
        (got, want)
    return got


def nucleus(lf_row, top_p):
    """tests/test_sampling.py's nucleus: the smallest descending prefix
    with mass >= top_p, in f64, widened by a one-sided epsilon."""
    order = np.argsort(-lf_row)
    q = np.exp(np.float64(lf_row[order]) - lf_row[order].max())
    q /= q.sum()
    cum_before = np.cumsum(q) - q
    return set(order[cum_before < top_p + 1e-6]) | {order[0]}


# ------------------------------------------------------------- op level

def test_temperature_zero_is_argmax_bitwise():
    lf = logits_for(0)
    toks = agree(lf, params(), keys_for(0))
    np.testing.assert_array_equal(toks, np.argmax(lf, -1))


@pytest.mark.parametrize("temperature", [1e-4, 1e-3])
def test_temperature_to_zero_converges_to_argmax(temperature):
    lf = logits_for(1)
    for seed in range(20):
        toks = agree(lf, params(temperature=temperature), keys_for(seed))
        np.testing.assert_array_equal(toks, np.argmax(lf, -1))


def test_top_k_one_is_greedy():
    lf = logits_for(2)
    for seed in range(10):
        toks = agree(lf, params(temperature=1.3, top_k=1), keys_for(seed))
        np.testing.assert_array_equal(toks, np.argmax(lf, -1))


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9])
def test_top_p_mass_bound_honored(top_p):
    lf = logits_for(3)
    sets = [nucleus(lf[b], top_p) for b in range(B)]
    for seed in range(40):
        toks = agree(lf, params(temperature=1.0, top_p=top_p),
                     keys_for(seed))
        for b in range(B):
            assert toks[b] in sets[b], (b, toks[b], sorted(sets[b]))


@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_top_k_support(top_k):
    lf = logits_for(4)
    topsets = [set(np.argsort(-lf[b])[:top_k]) for b in range(B)]
    for seed in range(40):
        toks = agree(lf, params(temperature=1.0, top_k=top_k),
                     keys_for(seed))
        for b in range(B):
            assert toks[b] in topsets[b]


def test_min_p_floor():
    lf = logits_for(5)
    min_p = 0.3
    q = np.exp(np.float64(lf) - lf.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    allowed = [set(np.nonzero(q[b] >= min_p * q[b].max())[0])
               for b in range(B)]
    for seed in range(40):
        toks = agree(lf, params(temperature=1.0, min_p=min_p),
                     keys_for(seed))
        for b in range(B):
            assert toks[b] in allowed[b]


def test_fixed_key_bitwise_deterministic():
    lf = logits_for(6)
    p = params(temperature=0.8, top_p=0.9)
    np.testing.assert_array_equal(sample(lf, p, keys_for(7)),
                                  sample(lf, p, keys_for(7)))


def test_per_slot_independence():
    """Changing slot 0's key or temperature never changes another slot's
    token."""
    lf = logits_for(8)
    p = params(temperature=1.0, top_p=0.8)
    keys = keys_for(9)
    base = agree(lf, p, keys)
    perturbed = keys.copy()
    perturbed[0] = np.asarray(jax.random.PRNGKey(424242))
    np.testing.assert_array_equal(agree(lf, p, perturbed)[1:], base[1:])
    p2 = dict(p, temperature=p["temperature"].copy())
    p2["temperature"][0] = 0.0
    np.testing.assert_array_equal(agree(lf, p2, keys)[1:], base[1:])


def test_vocab_bound_excludes_pad_ids():
    """A sampled row never emits a pad id >= vocab, even when the pad
    logits dominate; greedy rows keep the unbounded argmax."""
    vocab = 48
    lf = logits_for(12)
    lf[:, vocab:] += 10.0
    p = params(temperature=1.0, top_p=0.9)
    for seed in range(30):
        toks = agree(lf, p, keys_for(seed), vocab=vocab)
        assert (toks < vocab).all(), toks
    np.testing.assert_array_equal(agree(lf, params(), keys_for(0), vocab),
                                  np.argmax(lf, -1))


def test_mixed_greedy_and_sampled_rows():
    lf = logits_for(10)
    p = dict(temperature=np.asarray([0.0, 1.0, 0.0, 1.5], np.float32),
             top_k=np.asarray([0, 0, 1, 4], np.int32),
             top_p=np.asarray([1.0, 0.5, 1.0, 1.0], np.float32),
             min_p=np.zeros((4,), np.float32))
    toks = agree(lf, p, keys_for(11))
    want = np.argmax(lf, -1)
    assert toks[0] == want[0] and toks[2] == want[2]
    assert toks[1] in nucleus(lf[1], 0.5)
    assert toks[3] in set(np.argsort(-lf[3])[:4])


def _capped_cases():
    """tests/test_sampling.py's configurations at V = 8 x SAMPLE_HEAD, the
    last one (near-flat, top_p 0.9999) unclosable inside the head."""
    return [dict(), dict(temperature=0.8, top_k=8),
            dict(temperature=1.0, top_p=0.9),
            dict(temperature=1.2, min_p=0.05),
            dict(temperature=8.0, top_p=0.9999)]


def _port_args(lf, p, keys):
    return ([torch.from_numpy(lf)] + [torch.from_numpy(p[k]) for k in (
        "temperature", "top_k", "top_p", "min_p")]
        + [torch.from_numpy(keys)])


def test_capped_epilogue_bitwise_matches_full_argsort_reference():
    """The partial-sort sampler equals the full reference bit for bit, its
    partial path alone wherever every row closes in the head, across
    greedy, top-k, nucleus, min-p, vocab-bounded and unclosed rows; and
    the port's tokens agree with the JAX capped sampler's."""
    v_big = 8 * ref.SAMPLE_HEAD
    closed_seen = open_seen = 0
    for seed in range(12):
        lf = logits_for(seed, v=v_big)
        for kw in _capped_cases():
            p, keys = params(**kw), keys_for(seed)
            args = _port_args(lf, p, keys)
            full = ref.sample_tokens_reference(*args, vocab=v_big - 13)
            capped = ref.sample_tokens_capped(*args, vocab=v_big - 13)
            head, closed = ref.sample_tokens_head(*args, vocab=v_big - 13)
            assert torch.equal(capped, full), kw
            if bool(closed.all()):
                assert torch.equal(head, full), kw
                closed_seen += 1
            else:
                open_seen += 1
            agree(lf, p, keys, vocab=v_big - 13)
    assert closed_seen and open_seen, (closed_seen, open_seen)


def test_capped_fallback_branch_engages_and_matches():
    """Uniform logits: the head's mass (SAMPLE_HEAD / V) cannot reach
    top_p, so the fallback is taken, and the tokens are the full
    reference's."""
    v_big = 4 * ref.SAMPLE_HEAD
    lf = np.zeros((B, v_big), np.float32)
    p, keys = params(temperature=1.0, top_p=0.9), keys_for(99)
    args = _port_args(lf, p, keys)
    _, closed = ref.sample_tokens_head(*args)
    assert not bool(closed.any())
    assert torch.equal(ref.sample_tokens_capped(*args),
                       ref.sample_tokens_reference(*args))
    agree(lf, p, keys)


def test_largest_k_breaks_ties_as_the_stable_sort():
    x = torch.tensor([[0.0, -0.0, 1.0, 1.0, float("-inf"), 0.0, -2.0]])
    vals, idx = ref.largest_k(x, 7)
    want = torch.sort(x, dim=-1, descending=True, stable=True).indices
    assert torch.equal(idx, want)
    assert torch.equal(vals, torch.gather(x, -1, want))


@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=8),
                                dict(temperature=1.0, top_p=0.9),
                                dict(temperature=1.2, min_p=0.05)])
def test_filtered_log_probs_match_jax(kw):
    lf = logits_for(20, v=256)
    p = params(**kw)
    got = ref.filtered_log_probs(*_port_args(lf, p, keys_for(0))[:5],
                                 vocab=243).numpy()
    want = np.asarray(jref.filtered_log_probs(
        jnp.asarray(lf), *(jnp.asarray(p[k]) for k in (
            "temperature", "top_k", "top_p", "min_p")), vocab=243))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)


# ----------------------------------------------------------- loop level

def _serve(arch, *, stream, seg_len, sampling_for, n=3, max_new=6,
           slots=2):
    """tests/test_sampling.py's server run, on the port."""
    server = tserve.BatchedServer(arch, smoke=True, device="cpu",
                                  batch_slots=slots, max_seq=32,
                                  protocol="bs", stream=stream,
                                  seg_len=seg_len)
    rng = np.random.default_rng(13)
    for i in range(n):
        plen = int(rng.integers(3, 7))
        server.submit(tserve.Request(
            i, rng.integers(1, server.cfg.vocab, plen).astype(np.int32),
            max_new, sampling=sampling_for(i)))
    server.run_until_drained()
    assert all(r is None for r in server.active)
    return {r.rid: tuple(r.generated) for r in server.completed}


def test_fixed_seed_tokens_invariant_across_seg_len():
    sp = lambda i: tserve.SamplingParams(temperature=0.9, top_p=0.8,
                                         seed=50 + i)
    runs = {f"stream{sl}": _serve("mamba2_370m", stream=True, seg_len=sl,
                                  sampling_for=sp) for sl in (1, 4, 8)}
    runs["per_token"] = _serve("mamba2_370m", stream=False, seg_len=4,
                               sampling_for=sp)
    first = next(iter(runs.values()))
    assert all(r == first for r in runs.values()), runs
    assert all(len(v) == 6 for v in first.values())


def test_greedy_stream_bitwise_matches_sampling_off():
    a = _serve("starcoder2_3b", stream=True, seg_len=4,
               sampling_for=lambda i: None)
    b = _serve("starcoder2_3b", stream=True, seg_len=4,
               sampling_for=lambda i: tserve.SamplingParams(temperature=0.0))
    c = _serve("starcoder2_3b", stream=True, seg_len=4,
               sampling_for=lambda i: tserve.SamplingParams(
                   temperature=2.0, top_k=1))
    assert a == b == c


def test_slot_seed_independence_in_server():
    def sp(seed0):
        return lambda i: tserve.SamplingParams(
            temperature=1.0, top_p=0.9, seed=seed0 if i == 0 else 777)

    a = _serve("mamba2_370m", stream=True, seg_len=4, sampling_for=sp(1),
               n=2)
    b = _serve("mamba2_370m", stream=True, seg_len=4, sampling_for=sp(2),
               n=2)
    assert a[1] == b[1]
    assert a[0] != b[0]


def test_request_in_any_slot_or_alone_gives_the_same_tokens():
    """A sampled request served alone in one slot emits what it emits in
    a full batch in another slot."""
    sp = lambda i: tserve.SamplingParams(temperature=0.9, top_k=20,
                                         seed=5 + i)
    batch = _serve("starcoder2_3b", stream=True, seg_len=4, sampling_for=sp,
                   n=3, slots=2)
    alone = _serve("starcoder2_3b", stream=True, seg_len=4, sampling_for=sp,
                   n=3, slots=1)
    assert batch == alone


def test_request_may_not_set_two_stop_sets():
    server = tserve.BatchedServer("starcoder2_3b", smoke=True, device="cpu",
                                  batch_slots=1, max_seq=16)
    with pytest.raises(ValueError, match="stop tokens twice"):
        server.submit(tserve.Request(
            0, np.ones((3,), np.int32), 4, stop_tokens=(1,),
            sampling=tserve.SamplingParams(stop_tokens=(2,))))


def test_admission_keeps_split_zero_of_the_seed():
    state = steps.init_slot_state(2, torch.device("cpu"))
    key, _ = prng.split(prng.PRNGKey(31))
    state = steps.admit_slot(state, 1, token=5, position=3, key=key,
                             remaining=4, temperature=0.8, top_k=50,
                             top_p=0.95, min_p=0.0, stop=(7,))
    np.testing.assert_array_equal(
        state.keys.numpy(),
        [[0, 0], np.asarray(jax.random.split(jax.random.PRNGKey(31))[0])])
    assert state.sampling.top_k.tolist() == [0, 50]
    assert state.stop[1].tolist() == [7, -1, -1, -1]


# ------------------------------------------- the servers, across packages

ARCH = "starcoder2_3b"
SLOTS, MAX_SEQ, SEG_LEN, N_REQ, MAX_NEW = 2, 64, 8, 4, 16
_F32 = {}


@pytest.fixture
def f32(monkeypatch):
    """Both servers' smoke configs in f32 arithmetic."""
    for mod in (jserve, tserve):
        orig = mod.get_smoke_config
        monkeypatch.setattr(mod, "get_smoke_config", lambda a, _o=orig:
                            dataclasses.replace(_o(a), dtype="float32"))


def _sampling(mod, i, stop):
    """Even requests sampled, odd ones greedy; request 1 stops at `stop`."""
    stops = (stop,) if i == 1 else ()
    if i % 2 == 0:
        return mod.SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                  seed=100 + i)
    return mod.SamplingParams(seed=100 + i, stop_tokens=stops)


def _prompts(vocab):
    """tests/test_torch_serve.py's workload draw."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, int(rng.integers(3, 7))).astype(np.int32)
            for _ in range(N_REQ)]


def _jax_tokens(protocol, stop):
    """The JAX server's streams; its weights cross over once."""
    srv = jserve.BatchedServer(ARCH, smoke=True, batch_slots=SLOTS,
                               max_seq=MAX_SEQ, protocol=protocol,
                               stream=True, seg_len=SEG_LEN)
    for i, pr in enumerate(_prompts(srv.cfg.vocab)):
        srv.submit(jserve.Request(i, pr, MAX_NEW,
                                  sampling=_sampling(jserve, i, stop)))
    srv.run_until_drained()
    if "params" not in _F32:
        _F32["params"] = interop.params_from_jax(
            jax.tree.map(np.asarray, srv.params), "cpu")
    return {r.rid: list(r.generated) for r in srv.completed}


def _port(protocol, stop, *, stream=True, seg_len=SEG_LEN):
    srv = tserve.BatchedServer(ARCH, smoke=True, device="cpu",
                               batch_slots=SLOTS, max_seq=MAX_SEQ,
                               protocol=protocol, stream=stream,
                               seg_len=seg_len, params=_F32["params"])
    for i, pr in enumerate(_prompts(srv.cfg.vocab)):
        srv.submit(tserve.Request(i, pr, MAX_NEW,
                                  sampling=_sampling(tserve, i, stop)))
    srv.run_until_drained()
    assert srv.pages_allocated == srv.pages_freed
    return srv, {r.rid: list(r.generated) for r in srv.completed}


def _step_key(seed, t):
    """The key token t of a request is drawn with: split #1 of the t-th
    key of its chain (token 0: of PRNGKey(seed))."""
    key = prng.PRNGKey(seed)
    for _ in range(t + 1):
        key, sub = prng.split(key)
    return sub


def _at_near_tie(srv, prompt, prefix, sp, a, b):
    """Whether tokens a and b are both choices within the near-tie gates
    after prompt + prefix: the port's f32 logits there, replayed by a
    prefill, for a greedy row within NEAR_TIE of each other, for a
    sampled row both reached by the port's sampler under perturbations
    of the logits of at most LOGIT_TIE_F32."""
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    cache = transformer.init_cache(srv.cfg, 1, MAX_SEQ, device="cpu")
    lf, _ = transformer.prefill_into_cache(srv.cfg, srv.params, cache,
                                           torch.from_numpy(toks), 0,
                                           len(toks))
    lf = lf.float()[None]
    if sp.greedy:
        return abs(float(lf[0, a] - lf[0, b])) < NEAR_TIE
    one = ops.BatchedSampling(
        torch.tensor([sp.temperature]), torch.tensor([sp.top_k],
                                                     dtype=torch.int32),
        torch.tensor([sp.top_p]), torch.tensor([sp.min_p]))
    key = _step_key(sp.seed, len(prefix))[None]
    gen = torch.Generator().manual_seed(0)
    reached = {int(ops.sample_tokens(lf, one, key, vocab=srv.cfg.vocab)[0])}
    for _ in range(64):
        noise = (torch.rand(lf.shape, generator=gen) * 2 - 1) * LOGIT_TIE_F32
        reached.add(int(ops.sample_tokens(lf + noise, one, key,
                                          vocab=srv.cfg.vocab)[0]))
    return {a, b} <= reached


@pytest.mark.parametrize("protocol", ["bs", "rp"])
def test_sampled_serve_matches_jax_server(f32, protocol):
    """The port's streams against the JAX server's, up to a first
    difference at a near tie; request 1 stops at a token it emits."""
    free = _jax_tokens(protocol, stop=-1)
    stop = free[1][3]
    want = _jax_tokens(protocol, stop=stop)
    srv, got = _port(protocol, stop)
    assert got[1][-1] == stop and len(got[1]) == 4
    prompts = _prompts(srv.cfg.vocab)
    for rid, toks in got.items():
        ref_toks = want[rid]
        if toks == ref_toks:
            continue
        t = next(i for i, (x, y) in enumerate(zip(toks, ref_toks))
                 if x != y)
        assert _at_near_tie(srv, prompts[rid], toks[:t],
                            _sampling(tserve, rid, stop), toks[t],
                            ref_toks[t]), (rid, t, toks, ref_toks)


def test_sampled_serve_invariant_across_seg_len_and_loops(f32):
    """The same streams at seg_len 1, 4 and 8, streamed or per-token."""
    if "params" not in _F32:
        _jax_tokens("bs", stop=-1)
    runs = [_port("bs", 5, seg_len=sl)[1] for sl in (1, 4, 8)]
    runs.append(_port("bs", 5, stream=False)[1])
    assert all(r == runs[0] for r in runs), runs
