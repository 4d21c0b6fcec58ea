"""Speculative draft-and-verify decoding in the port (`ref.verify_tokens_
reference`, `ops.verify_tokens`, `transformer.decode_verify` with its KV
writes, `steps.self_draft_params`, `steps.make_spec_decode_segment` and
`BatchedServer(spec=True)`) against the JAX package, mirroring
tests/test_speculative.py.

Across the two packages, on the same inputs:
  * `verify_tokens` on the same f32 logits and keys: greedy rows bit for
    bit; sampled rows (out_tokens, accept_len) equal except where the
    JAX oracle's own values sit at a near tie (the two best residual or
    bonus Gumbel scores within 1e-5, or a draw of u within 1e-5 of its
    accept threshold);
  * `verify_kv_update` / `quant_verify_kv_update` bit for bit;
  * `decode_verify` in f32 arithmetic: logits at all T positions of the
    rows it writes within 1e-5, the mamba snapshots (SSM states up to
    ~10) within 1e-5 + 1e-5 relative;
  * the spec servers (smoke configs, 3 slots, max_seq 64, seg_len 3,
    spec_k 2) on the JAX server's weights, crossed through
    `repro_torch.interop`, for drafts self:1, full depth and another arch
    (its weights crossed too), fp and q8_0 weights with an int8 KV cache:
    greedy tokens equal except at a near tie (the gate of
    tests/test_quant.py: where a stream parts, the two choices' logits
    within 0.1 in the port's prefill of the common prefix; in bf16 the
    two frameworks' logits part by bf16 units), and the accept counts
    equal where every stream is.
Inside the port, bit for bit: a full-depth self-draft is the target;
`decode_verify` over fp caches gives the logits, K/V rows and recurrent
states of T sequential `decode_step`s; greedy spec streams equal the
non-spec server's in both loops, at any seg_len and k; the plain twin
equals the sampled variant on greedy batches."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ref as jref                          # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.launch import steps as jsteps                       # noqa: E402
from repro.models import transformer as JT                     # noqa: E402
from repro_torch import interop                                # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.core import prng                              # noqa: E402
from repro_torch.kernels import ops                            # noqa: E402
from repro_torch.kernels import ref                            # noqa: E402
from repro_torch.kernels.quant import QTensor                  # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.launch import steps                           # noqa: E402
from repro_torch.models import transformer as T                # noqa: E402
from repro_torch.models.quantize import quantize_params        # noqa: E402

ARCHES = ["starcoder2_3b", "mamba2_370m"]
SLOTS, MAX_SEQ, SEG_LEN, K = 3, 64, 3, 2
GUMBEL_TIE, U_TIE, NEAR_TIE, F32_ATOL = 1e-5, 1e-5, 0.1, 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: at smoke size it is faster
    than many (a third of the CPU time alone) and leaves the cores to the
    other test processes.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype=None):
    cfg = jax_smoke_config(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, JT.init_params(cfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype=None):
    """The JAX server's weights (jax.random.key(0)), crossed over."""
    return interop.params_from_jax(_np(_jax_params(arch, dtype)[1]), CPU)


def _cfg(arch, dtype=None):
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


# --------------------------------------------------------------------------
# verify_tokens
# --------------------------------------------------------------------------

def _samp(b, temperature=1.0, top_k=0, top_p=1.0, min_p=0.0):
    return dict(temperature=np.full((b,), temperature, np.float32),
                top_k=np.full((b,), top_k, np.int32),
                top_p=np.full((b,), top_p, np.float32),
                min_p=np.full((b,), min_p, np.float32))


def _keys(b, seed=0):
    return np.stack([np.asarray(jax.random.PRNGKey(seed + i))
                     for i in range(b)]).astype(np.int64)


def _verify(tl, dl, g, sp, keys, vocab=0):
    out, alen = ops.verify_tokens(
        torch.from_numpy(tl), torch.from_numpy(dl), torch.from_numpy(g),
        ops.BatchedSampling(**{k: torch.from_numpy(v)
                               for k, v in sp.items()}),
        torch.from_numpy(keys), vocab=vocab)
    return out.numpy(), alen.numpy()


_jax_verify_jit = jax.jit(jref.verify_tokens_reference,
                          static_argnames=("vocab",))


def _jax_verify(tl, dl, g, sp, keys, vocab=0):
    out, alen = _jax_verify_jit(
        jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(g),
        *(jnp.asarray(sp[k]) for k in ("temperature", "top_k", "top_p",
                                       "min_p")),
        jnp.asarray(keys, jnp.uint32), vocab=vocab)
    return np.asarray(out), np.asarray(alen)


def _verify_near_ties(tl, dl, g, sp, keys, vocab):
    """Rows where the JAX oracle's own values sit at a near tie: the two
    best residual or bonus Gumbel scores within GUMBEL_TIE, or log u
    within U_TIE of its accept threshold."""
    b, kp1, v = tl.shape
    k = kp1 - 1
    args = [jnp.asarray(sp[n]) for n in ("temperature", "top_k", "top_p",
                                         "min_p")]
    lq = np.asarray(jref.filtered_log_probs(jnp.asarray(tl), *args, vocab))
    lp = np.asarray(jref.filtered_log_probs(jnp.asarray(dl), *args, vocab))
    lq_g = np.take_along_axis(lq[:, :k], g[..., None], -1)[..., 0]
    lp_g = np.take_along_axis(lp, g[..., None], -1)[..., 0]

    def draws(key):
        ku, kc, kb = jax.random.split(key, 3)
        return (jax.random.uniform(ku, (k,), jnp.float32),
                jax.random.gumbel(kc, (k, v), jnp.float32),
                jax.random.gumbel(kb, (v,), jnp.float32))

    u, g_res, g_bonus = (np.asarray(x) for x in jax.vmap(draws)(
        jnp.asarray(keys, jnp.uint32)))
    res = np.maximum(np.exp(lq[:, :k]) - np.exp(lp), 0.0)
    with np.errstate(divide="ignore"):
        res_l = np.where(res.sum(-1, keepdims=True) > 0, np.log(res),
                         lq[:, :k])
        u_tie = (np.abs(np.log(u) + lp_g - lq_g) <= U_TIE).any(-1)

    def gap(z):
        top2 = -np.sort(-z, -1)[..., :2]
        return top2[..., 0] - top2[..., 1]

    return (u_tie | (gap(res_l + g_res) <= GUMBEL_TIE).any(-1)
            | (gap(lq[:, k] + g_bonus) <= GUMBEL_TIE))


VERIFY_CASES = {
    "greedy": dict(temperature=0.0),
    "t0.9": dict(temperature=0.9),
    "t0.8_topk8": dict(temperature=0.8, top_k=8),
    "t1_topp0.85": dict(temperature=1.0, top_p=0.85),
    "t1.2_minp0.05": dict(temperature=1.2, min_p=0.05),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
@pytest.mark.parametrize("vocab", [0, 40])
def test_verify_tokens_match_jax(case, vocab):
    """The port's verdicts on the same f32 logits and keys; half the
    drafts are the target argmax (accepted often), half random."""
    b, k, v = 8, 3, 48
    rng = np.random.default_rng(sorted(VERIFY_CASES).index(case))
    tl = rng.standard_normal((b, k + 1, v)).astype(np.float32) * 2
    dl = (tl[:, :k] + rng.standard_normal((b, k, v)).astype(np.float32)
          * np.linspace(0, 2, b, dtype=np.float32)[:, None, None])
    g = np.where(np.arange(b)[:, None] % 2 == 0,
                 tl[:, :k, :vocab or v].argmax(-1),
                 rng.integers(0, v, (b, k))).astype(np.int32)
    sp = _samp(b, **VERIFY_CASES[case])
    keys = _keys(b, seed=11)
    got, want = _verify(tl, dl, g, sp, keys, vocab), \
        _jax_verify(tl, dl, g, sp, keys, vocab)
    differ = (got[0] != want[0]).any(-1) | (got[1] != want[1])
    if case == "greedy":
        assert not differ.any()
        return
    assert not (differ & ~_verify_near_ties(tl, dl, g, sp, keys,
                                            vocab)).any(), (got, want)


def test_verify_tokens_greedy_prefix_semantics():
    """Greedy rows accept while the draft equals the target argmax and
    emit the target argmax stream whatever the draft."""
    b, k, v = 4, 3, 32
    tl = np.random.default_rng(0).standard_normal((b, k + 1, v)).astype(
        np.float32)
    am = tl.argmax(-1).astype(np.int32)
    drafts = np.stack([am[0, :k], (am[1, :k] + 1) % v,
                       [am[2, 0], (am[2, 1] + 1) % v, am[2, 2]],
                       [am[3, 0], am[3, 1], (am[3, 2] + 1) % v]]
                      ).astype(np.int32)
    out, alen = _verify(tl, tl[:, :k], drafts, _samp(b, temperature=0.0),
                        _keys(b))
    assert list(alen) == [3, 0, 1, 2]
    assert (out == am).all()


def test_verify_tokens_stochastic_accept_edges():
    """p == q accepts every draft; a draft the target filters out (q = 0)
    is always rejected, and the correction comes from the filtered
    target."""
    b, k, v = 3, 3, 32
    tl = np.random.default_rng(1).standard_normal((b, k + 1, v)).astype(
        np.float32)
    g = tl[:, :k].argmax(-1).astype(np.int32)
    out, alen = _verify(tl, tl[:, :k], g, _samp(b), _keys(b))
    assert (alen == k).all() and (out[:, :k] == g).all()
    sharp = tl.copy()
    sharp[:, :, 0] += 50.0
    out, alen = _verify(sharp, tl[:, :k], np.full((b, k), v - 1, np.int32),
                        _samp(b, top_p=0.5), _keys(b))
    assert (alen == 0).all() and (out[:, 0] == 0).all()


def test_verify_tokens_marginal_matches_filtered_target():
    """Over 30,000 keys the round's first emitted token (an accepted draft
    or the correction) is distributed as the filtered target: the draft
    moves the accept rate only."""
    k, v, n = 2, 12, 30_000
    rng = np.random.default_rng(2)
    tl = np.broadcast_to(rng.standard_normal((1, k + 1, v)).astype(
        np.float32), (n, k + 1, v)).copy()
    dl = np.broadcast_to(rng.standard_normal((1, k, v)).astype(
        np.float32), (n, k, v)).copy()
    sp = _samp(n, temperature=0.9, top_p=0.85)
    t_sp = ops.BatchedSampling(**{a: torch.from_numpy(x)
                                  for a, x in sp.items()})
    both = prng.split(torch.stack([prng.PRNGKey(i) for i in range(n)]))
    g0 = ops.sample_tokens(torch.from_numpy(dl[:, 0]), t_sp, both[:, 0])
    g = g0[:, None].expand(n, k).numpy().astype(np.int32)
    out, _ = _verify(tl, dl, g, sp, both[:, 1].numpy())
    counts = np.bincount(out[:, 0], minlength=v) / n
    want = torch.exp(ref.filtered_log_probs(
        torch.from_numpy(tl[:1, 0]), t_sp.temperature[:1], t_sp.top_k[:1],
        t_sp.top_p[:1], t_sp.min_p[:1]))[0].numpy()
    assert np.abs(counts - want).sum() < 0.03, (counts, want)
    assert counts[want == 0.0].sum() == 0.0


def test_verify_tokens_vocab_bound():
    """Sampled rows never emit a pad id >= vocab, as an accepted draft (q
    = 0 there) or as a correction."""
    b, k, v, vocab = 2, 2, 16, 10
    tl = np.random.default_rng(4).standard_normal((b, k + 1, v)).astype(
        np.float32)
    tl[:, :, vocab:] += 100.0
    out, alen = _verify(tl, tl[:, :k], np.full((b, k), v - 1, np.int32),
                        _samp(b), _keys(b), vocab=vocab)
    assert (alen == 0).all() and (out[:, 0] < vocab).all()


# --------------------------------------------------------------------------
# the verify forward and its KV writes
# --------------------------------------------------------------------------

def _paged_cache_case(seed, kv_int8=False):
    """A stacked (L, B, KH, S, hd) cache with a shuffled page table, T new
    rows, positions (one wrapping the ring) and a write mask."""
    rng = np.random.default_rng(seed)
    l, b, kh, s, hd, t, ps = 2, 3, 2, 32, 8, 4, 8
    new = rng.standard_normal((l, b, t, kh, hd)).astype(np.float32)
    pages = np.stack([rng.permutation(s // ps) for _ in range(b)]
                     ).astype(np.int32)
    pos = np.array([3, 13, 30], np.int32)
    mask = np.array([True, False, True])
    if kv_int8:
        pool = rng.integers(-127, 128, (l, b, kh, s, hd)).astype(np.int8)
        scales = rng.uniform(0.0, 0.02, (l, b, kh, s // ps)).astype(
            np.float32)
        return pool, scales, new, pos, mask, pages
    return rng.standard_normal((l, b, kh, s, hd)).astype(np.float32), \
        new, pos, mask, pages


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_verify_kv_update_matches_jax(masked, paged):
    cache, new, pos, mask, pages = _paged_cache_case(5)
    mask = mask if masked else None
    pages = pages if paged else None
    want = np.asarray(JT.verify_kv_update(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos),
        None if mask is None else jnp.asarray(mask),
        None if pages is None else jnp.asarray(pages)))
    got = T.verify_kv_update(
        torch.from_numpy(cache), torch.from_numpy(new), torch.from_numpy(pos),
        None if mask is None else torch.from_numpy(mask),
        None if pages is None else torch.from_numpy(pages))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_quant_verify_kv_update_matches_jax(masked, paged):
    pool, scales, new, pos, mask, pages = _paged_cache_case(6, kv_int8=True)
    mask = mask if masked else None
    pages = pages if paged else None
    want = jax.jit(JT.quant_verify_kv_update)(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(pos), None if mask is None else jnp.asarray(mask),
        None if pages is None else jnp.asarray(pages))
    got = T.quant_verify_kv_update(
        torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy()),
        torch.from_numpy(new), torch.from_numpy(pos),
        None if mask is None else torch.from_numpy(mask),
        None if pages is None else torch.from_numpy(pages))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _prefilled(arch, dtype=None, kv_quant=None, page_size=8, b=3):
    """JAX and port caches with b rows prefilled with the same prompts
    (the JAX prefill's cache crossed over), plus verify inputs."""
    jcfg, jparams = _jax_params(arch, dtype)
    rng = np.random.default_rng(9)
    cache = JT.init_cache(jcfg, b, 32, page_size=page_size,
                          kv_quant=kv_quant) if "full" in \
        jcfg.block_pattern else JT.init_cache(jcfg, b, 32)
    if "page_table" in cache:
        cache["page_table"] = jnp.asarray(np.stack(
            [rng.permutation(32 // page_size) for _ in range(b)]
        ).astype(np.int32))
    lens = [5, 9, 3]
    prefill = jax.jit(functools.partial(JT.prefill_into_cache, jcfg))
    for row, n in enumerate(lens[:b]):
        prompt = jnp.asarray(rng.integers(1, jcfg.vocab, 16).astype(
            np.int32))
        _, cache = prefill(jparams, cache, prompt, row, n)
    tokens = rng.integers(1, jcfg.vocab, (b, K + 2)).astype(np.int32)
    pos = np.asarray(lens[:b], np.int32)
    return jcfg, jparams, cache, tokens, pos


@pytest.mark.parametrize("arch,kv_quant", [("starcoder2_3b", None),
                                           ("starcoder2_3b", "int8"),
                                           ("mamba2_370m", None)])
def test_decode_verify_matches_jax_f32(arch, kv_quant):
    """Logits at all T positions within 1e-5 in f32 arithmetic; the
    written K/V rows and the recurrent snapshots too; the recurrent state
    in the cache untouched."""
    jcfg, jparams, jcache, tokens, pos = _prefilled(arch, "float32",
                                                    kv_quant)
    mask = np.array([True, False, True])
    tcache = interop.cache_from_jax(_np(jcache), CPU)
    jlog, jout, jsnaps = jax.jit(functools.partial(JT.decode_verify, jcfg))(
        jparams, jcache, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(mask))
    before = {k: v.clone() for k, v in tcache.items()}
    tlog, tout, tsnaps = T.decode_verify(
        _cfg(arch, "float32"), _params(arch, "float32"), tcache,
        torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(mask))
    # a masked row reads its old rows here and the reference's fresh
    # local copy there; the segment discards its outputs either way
    np.testing.assert_allclose(tlog.numpy()[mask], np.asarray(jlog)[mask],
                               rtol=0, atol=F32_ATOL)
    for key, want in _np(jout).items():
        got = tout[key].numpy()
        if key.startswith(("conv", "ssm")):
            assert torch.equal(tout[key], before[key])
        elif key.startswith(("k", "v")) and got.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        elif key.startswith(("kscale", "vscale")):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        elif got.dtype == np.int8:
            # int8 rows: a rounding step apart at most
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)
    assert tsnaps.keys() == jsnaps.keys()
    for key, want in _np(jsnaps).items():
        np.testing.assert_allclose(tsnaps[key].float().numpy(),
                                   want.astype(np.float32), rtol=F32_ATOL,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_verify_is_sequential_decode_bitwise(arch):
    """Within the port (bf16, fp caches): the verify's logits at position j
    are those of the j-th of T sequential decode steps, bitwise; the K/V
    rows it writes are theirs, and its snapshot j is the recurrent state
    after step j."""
    cfg, params = _cfg(arch), _params(arch)
    _, _, jcache, tokens, pos = _prefilled(arch)
    cache = interop.cache_from_jax(_np(jcache), CPU)
    seq = {k: v.clone() for k, v in cache.items()}
    logits, cache, snaps = T.decode_verify(cfg, params, cache,
                                           torch.from_numpy(tokens),
                                           torch.from_numpy(pos))
    p = torch.from_numpy(pos)
    for j in range(tokens.shape[1]):
        lg, seq = T.decode_step(cfg, params, seq,
                                torch.from_numpy(tokens[:, j:j + 1]),
                                positions=p + j)
        assert torch.equal(lg[:, 0], logits[:, j]), j
        for key, snap in snaps.items():
            assert torch.equal(snap[:, :, j], seq[key]), (key, j)
    for key in cache:
        if key[0] in "kv" and key[1:].isdigit():
            assert torch.equal(cache[key], seq[key]), key


@pytest.mark.parametrize("weights", [None, "q8_0"])
def test_full_depth_self_draft_is_the_target(weights):
    """The self-draft's leaves are views of the target's; at full depth
    it decodes the target's logits bitwise."""
    arch = "starcoder2_3b"
    cfg, params = _cfg(arch), _params(arch)
    if weights:
        params = quantize_params(params, weights)
    nb = cfg.n_blocks
    for n in (1, nb):
        draft = steps.self_draft_params(cfg, params, n)
        assert draft["embed"] is params["embed"]
        for blk_d, blk_t in zip(draft["blocks"], params["blocks"]):
            for sub, leaves in blk_d.items():
                for name, leaf in leaves.items():
                    full = blk_t[sub][name]
                    parts = ((leaf.scales, full.scales),
                             (leaf.quants, full.quants)) \
                        if isinstance(leaf, QTensor) else ((leaf, full),)
                    for a, b in parts:
                        assert a.shape[0] == n
                        assert a.data_ptr() == b.data_ptr()
    dcfg = steps.self_draft_config(cfg, nb)
    draft = steps.self_draft_params(cfg, params, nb)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    outs = []
    for c, p in ((cfg, params), (dcfg, draft)):
        cache = T.init_cache(c, 2, 32, device=CPU)
        outs.append(T.decode_step(c, p, cache, toks)[0])
    assert torch.equal(*outs)
    with pytest.raises(AssertionError):
        steps.self_draft_config(cfg, nb + 1)


def test_padded_rows_pads_products_and_norms_only_inside():
    """Inside `quantize.padded_rows(n)` (the spec segment's draft steps,
    n = the verify's row count) an fp product or norm over fewer than n
    rows runs over n, x's rows first and zero rows after, and returns
    x's rows in x's shape, equal to the unpadded result within f32
    rounding; at n rows or more, and outside, nothing is padded."""
    from repro_torch.models import layers as TL
    from repro_torch.models import quantize as TQ
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16), np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8), np.float32))
    scale = torch.from_numpy(rng.standard_normal(16, np.float32))
    assert TQ.invariant_rows(x)[0].shape == (6, 16)
    with TQ.padded_rows(16):
        x2, rows = TQ.invariant_rows(x)
        assert rows == 6 and x2.shape == (16, 16)
        assert torch.equal(x2[:6], x.reshape(6, 16))
        assert not bool(x2[6:].any())
        big = torch.zeros(20, 16)
        assert TQ.invariant_rows(big)[0].shape == (20, 16)
        got_mm, got_norm = TQ.matmul(x, w), TL.rms_norm(x, scale)
    assert TQ.invariant_rows(x)[0].shape == (6, 16)
    assert got_mm.shape == (2, 3, 8) and got_norm.shape == x.shape
    torch.testing.assert_close(got_mm, x @ w, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_norm, TL.rms_norm(x, scale), rtol=0,
                               atol=1e-6)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _workload(vocab, n_req, seed, sampled=False, stops=False, eos=0,
              sampling_cls=None):
    """tests/test_speculative.py's request draw, as dicts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_req):
        plen = int(rng.integers(3, 7))
        prompt = rng.integers(1, vocab, plen).astype(np.int32)
        sp = None
        if sampled and i % 2:
            sp = dict(temperature=0.9, top_p=0.85, seed=500 + i)
        elif stops and i % 2:
            sp = dict(stop_tokens=(eos, 3))
        out.append(dict(rid=i, prompt=prompt,
                        max_new=int(rng.integers(2, 9)), sampling=sp))
    return out


def _submit(srv, wl, mod):
    for w in wl:
        sp = w["sampling"]
        srv.submit(mod.Request(w["rid"], w["prompt"], w["max_new"],
                               sampling=None if sp is None
                               else mod.SamplingParams(**sp)))
    srv.run_until_drained(max_steps=100_000)
    assert all(r is None for r in srv.active) and not srv.queue
    return srv


@functools.lru_cache(maxsize=None)
def _jax_spec(arch, draft, seed=7, quant=None):
    """One drained JAX spec server on the greedy workload (cached)."""
    srv = jserve.BatchedServer(
        arch, smoke=True, batch_slots=SLOTS, max_seq=MAX_SEQ, protocol="bs",
        stream=True, seg_len=SEG_LEN, spec=True, spec_k=K, draft_arch=draft,
        quant=jsteps.QuantConfig(*quant) if quant else None)
    return _submit(srv, _workload(srv.cfg.vocab, 7, seed), jserve)


class _LedgerChecked(tserve.BatchedServer):
    """Asserts the page ledger after every consumed segment."""

    def _consume_segment(self, *a, **kw):
        super()._consume_segment(*a, **kw)
        self.assert_ledger()


def _port(arch, wl, *, spec=True, draft="self:1", spec_k=K,
          seg_len=SEG_LEN, stream=True, quant=None, draft_params=None):
    srv = _LedgerChecked(
        arch, smoke=True, device="cpu", batch_slots=SLOTS, max_seq=MAX_SEQ,
        protocol="bs", stream=stream, seg_len=seg_len, params=_params(arch),
        spec=spec, spec_k=spec_k, draft_arch=draft,
        draft_params=draft_params,
        quant=steps.QuantConfig(*quant) if quant else None)
    _submit(srv, wl, tserve)
    assert srv.pages_allocated == srv.pages_freed
    return srv


def _streams(srv):
    return {r.rid: tuple(r.generated) for r in srv.completed}


@functools.lru_cache(maxsize=None)
def _port_plain(arch, seed=7):
    return _streams(_port(arch, _workload(_cfg(arch).vocab, 7, seed),
                          spec=False))


def _other(arch):
    return "mamba2_370m" if arch == "starcoder2_3b" else "starcoder2_3b"


def _near_tie_agree(srv, got, want, wl):
    """Equal streams, or streams that part at a near tie: the two choices'
    logits within NEAR_TIE in the port's prefill of the prompt and the
    common prefix (the gate of tests/test_quant.py).  Returns whether all
    are equal."""
    assert got.keys() == want.keys()
    for w in wl:
        a, b = got[w["rid"]], want[w["rid"]]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([w["prompt"], np.asarray(a[:t], np.int32)])
        cache = T.init_cache(srv.cfg, 1, MAX_SEQ, device=CPU)
        lg, _ = T.prefill_into_cache(srv.cfg, srv.params, cache,
                                     torch.from_numpy(seq), 0, len(seq))
        gap = (lg[a[t]] - lg[b[t]]).abs().item()
        assert gap < NEAR_TIE, (w["rid"], t, gap)
    return got == want


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("draft", ["self:1", "full", "other"])
def test_spec_server_matches_jax_spec_server(arch, draft):
    """The tokens of the JAX spec server on its own weights (a foreign
    draft's crossed too) up to a near tie, and its accept counts where
    every stream is equal; the tokens are the port's non-spec server's,
    bitwise."""
    name = {"self:1": "self:1", "full": f"self:{_cfg(arch).n_blocks}",
            "other": _other(arch)}[draft]
    jsrv = _jax_spec(arch, name)
    dparams = (interop.params_from_jax(_np(jsrv.draft_params), CPU)
               if draft == "other" else None)
    wl = _workload(_cfg(arch).vocab, 7, 7)
    tsrv = _port(arch, wl, draft=name, draft_params=dparams)
    assert _streams(tsrv) == _port_plain(arch)
    if _near_tie_agree(tsrv, _streams(tsrv), _streams(jsrv), wl):
        assert (tsrv.draft_accepted, tsrv.draft_proposed) == \
            (jsrv.draft_accepted, jsrv.draft_proposed)
        assert (tsrv.decode_syncs, tsrv.steps) == (jsrv.decode_syncs,
                                                   jsrv.steps)


@pytest.mark.parametrize("arch", ARCHES)
def test_spec_per_token_loop_and_geometry_invariance(arch):
    """The greedy spec stream is the non-spec stream in the per-token loop
    too, and at any rounds per segment and draft depth k."""
    wl = _workload(_cfg(arch).vocab, 5, 11)
    want = _streams(_port(arch, wl, spec=False))
    for seg_len, k, stream in ((SEG_LEN, K, False), (1, 1, True),
                               (2, 3, True), (4, 2, True)):
        got = _streams(_port(arch, wl, spec_k=k, seg_len=seg_len,
                             stream=stream))
        assert got == want, (arch, seg_len, k, stream)


@pytest.mark.parametrize("arch", ARCHES)
def test_spec_plain_twin_equals_sampled_variant(arch):
    """On an all-greedy batch the plain twin emits the sampled variant's
    tokens, emit masks, accept lengths and positions, bitwise."""
    cfg, params = _cfg(arch), _params(arch)
    dcfg = steps.self_draft_config(cfg, 1)
    dparams = steps.self_draft_params(cfg, params, 1)

    def prepped():
        cache = T.init_cache(cfg, 2, MAX_SEQ, device=CPU)
        dcache = T.init_cache(dcfg, 2, MAX_SEQ, device=CPU)
        state = steps.init_slot_state(2, CPU)
        r = np.random.default_rng(23)
        for row in range(2):
            prompt = torch.from_numpy(r.integers(1, cfg.vocab, 8).astype(
                np.int32))
            lg, cache = T.prefill_into_cache(cfg, params, cache, prompt,
                                             row, 5)
            T.prefill_into_cache(dcfg, dparams, dcache, prompt, row, 5)
            state = steps.admit_slot(
                state, row, token=int(lg.argmax()), position=5,
                key=prng.PRNGKey(row), remaining=10, temperature=0.0,
                top_k=0, top_p=1.0, min_p=0.0, stop=())
        return cache, dcache, state

    outs = {}
    for plain in (False, True):
        seg = steps.make_spec_decode_segment(cfg, dcfg, 2, 2, plain=plain)
        seq, emit, alens, state, _, _ = seg(params, dparams, *prepped())
        outs[plain] = (seq, emit, alens, state.positions, state.accepted,
                       state.proposed)
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHES)
def test_spec_churn_stop_budget_and_accept_accounting(arch):
    """Greedy, sampled and stop-token requests churning through a spec
    server: budgets kept, a stop token is the last token, sampled rows
    stay under the vocabulary, the greedy cohort is the non-spec
    server's, and the server's accept totals are the sum of the
    per-request device counters."""
    cfg = _cfg(arch)
    wl = _workload(cfg.vocab, 9, 13, sampled=True)
    wl += [dict(w, rid=w["rid"] + 100) for w in
           _workload(cfg.vocab, 4, 14, stops=True, eos=cfg.eos_token)]
    srv = _port(arch, wl)
    got = _streams(srv)
    assert set(got) == {w["rid"] for w in wl}
    plain = _streams(_port(arch, wl, spec=False))
    for w in wl:
        toks, sp = got[w["rid"]], w["sampling"] or {}
        assert 1 <= len(toks) <= w["max_new"]
        hit = [i for i, t in enumerate(toks)
               if t in sp.get("stop_tokens", ())]
        if hit:
            assert hit[0] == len(toks) - 1
        else:
            assert len(toks) == w["max_new"]
        if sp.get("temperature"):
            assert all(0 <= t < cfg.vocab for t in toks)
        else:
            assert toks == plain[w["rid"]], w["rid"]
    assert 0 <= srv.draft_accepted <= srv.draft_proposed
    assert srv.draft_proposed > 0
    assert srv.draft_accepted == sum(r.spec_accepted or 0
                                     for r in srv.completed)
    assert srv.draft_proposed == sum(r.spec_proposed or 0
                                     for r in srv.completed)


def test_sampled_spec_stream_invariant_to_rounds_per_segment():
    """Sampled draws are consumed per round, so a fixed seed gives the
    same stream at any rounds per segment and in the per-token loop."""
    arch = "starcoder2_3b"
    wl = _workload(_cfg(arch).vocab, 4, 31, sampled=True)
    want = _streams(_port(arch, wl, seg_len=1))
    assert _streams(_port(arch, wl, seg_len=4)) == want
    assert _streams(_port(arch, wl, stream=False)) == want


@pytest.mark.parametrize("arch", ARCHES)
def test_spec_accept_rate_one_grows_tokens_per_sync(arch):
    """A full-depth self-draft accepts every greedy draft (rate exactly
    1.0) and emits more tokens per host sync than the non-spec server at
    the same budget."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(17)
    wl = [dict(rid=i, prompt=rng.integers(1, cfg.vocab, 5).astype(np.int32),
               max_new=25, sampling=None) for i in range(4)]
    base = _port(arch, wl, spec=False, seg_len=4)
    spec = _port(arch, wl, draft=f"self:{cfg.n_blocks}", spec_k=3,
                 seg_len=4)
    assert _streams(spec) == _streams(base)
    assert spec.draft_accepted == spec.draft_proposed > 0
    assert spec.tokens_emitted / spec.decode_syncs > \
        base.tokens_emitted / base.decode_syncs


def test_spec_requires_a_draft_and_headroom(monkeypatch):
    """No draft at all, a self-draft given weights of its own, and a
    request whose prompt + budget + k overruns max_seq all fail."""
    cfg = dataclasses.replace(_cfg("starcoder2_3b"), draft_arch=None)
    monkeypatch.setattr(tserve, "get_smoke_config", lambda arch: cfg)
    with pytest.raises(AssertionError, match="draft"):
        tserve.BatchedServer("starcoder2_3b", device="cpu", spec=True)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="self-draft"):
        tserve.BatchedServer("starcoder2_3b", device="cpu", spec=True,
                             draft_params=_params("starcoder2_3b"))
    srv = tserve.BatchedServer("starcoder2_3b", device="cpu",
                               batch_slots=1, max_seq=16, stream=True,
                               spec=True, draft_arch="self:1")
    srv.submit(tserve.Request(0, np.ones((6,), np.int32), 16))
    with pytest.raises(AssertionError):
        srv.run_until_drained()


def test_quantized_spec_server_matches_jax_spec_server():
    """q8_0 weights and an int8 KV cache: tokens equal to the JAX spec
    server's up to a near tie.  Neither is held to the non-spec stream:
    the reference's own spec stream parts from it under an int8 cache
    (ROADMAP.md queue 3)."""
    arch = "starcoder2_3b"
    quant = ("q8_0", "int8")
    jsrv = _jax_spec(arch, "self:1", quant=quant)
    wl = _workload(_cfg(arch).vocab, 7, 7)
    tsrv = _port(arch, wl, quant=quant)
    _near_tie_agree(tsrv, _streams(tsrv), _streams(jsrv), wl)


def test_cli_serves_speculatively(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--device", "cpu", "--stream", "--spec", "--spec-k", "2",
        "--draft", "self:1", "--requests", "2", "--slots", "2",
        "--max-seq", "64", "--max-new", "6"])
    assert tserve.main() == 0
    line = capsys.readouterr().out
    assert "accept_rate=" in line and "tokens=12" in line
