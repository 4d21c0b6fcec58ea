"""The host tier and the prefix cache in the port (`core/backstream.py`'s
`stream_offload_to_host` / `stream_offload_to_device`, `HostTier`,
`PrefixCache`; `transformer.extract_slot_cache` / `insert_slot_cache`,
`resume_prefill_into_cache` and `quant_kv_write_rows(start > 0)`;
`steps.save_slot_state` / `restore_slot`; `BatchedServer(host_offload=
True)` and `BatchedServer(prefix_cache=True)`) against the JAX package,
mirroring tests/test_cache_offload.py, on smoke configs.

Across the two packages, on the same numpy inputs (crossed through
`repro_torch.interop`):
  * one slot's pages out of a cache under permuted page tables, every
    leaf kind (K/V page sets, int8 scales, conv windows, SSD states,
    cross-K/V, enc_pos), cut by `upto` or whole, and written back into a
    cache: bit for bit;
  * `quant_kv_write_rows` at start 0, 5, 128 and 130 (page 128: fresh
    pages and a boundary page that merges with the restored prefix's
    scale), against the jitted JAX function: bit for bit;
  * `resume_prefill_into_cache` in f32 arithmetic (fp and int8 K/V):
    logits and the written K/V rows and recurrent states within 1e-4;
  * the evicting servers (greedy and sampled, streamed and per-token,
    plain and speculative) and the prefix-caching servers in f32
    arithmetic: streams equal except where one parts at a near tie (a
    greedy row's two choices within 0.1 in the port's replayed logits, a
    sampled row's both reached by the port's sampler under perturbations
    of the logits of at most 1e-4), and the eviction and prefix counts
    equal where every stream is.
Inside the port, bit for bit: the round trip through host memory in any
chunking; an evicting server's streams and a non-evicting one's; prefix
full hits and the no-cache server's; a mamba resume and its full prefill.
Partial hits against the no-cache server: the near-tie gate (the resume
merges two softmax partials in another order than the one-pass prefill).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.launch import steps as jsteps                       # noqa: E402
from repro.models import transformer as JT                     # noqa: E402
from repro.models.registry import get_model as jax_model       # noqa: E402
from repro_torch import interop                                # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.core import backstream as BS                  # noqa: E402
from repro_torch.core import prng                              # noqa: E402
from repro_torch.kernels import ops                            # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.launch import steps                           # noqa: E402
from repro_torch.models import transformer as T                # noqa: E402
from repro_torch.models.registry import get_model              # noqa: E402

CPU = torch.device("cpu")
ATOL = 1e-4
NEAR_TIE, LOGIT_TIE_F32 = 0.1, 1e-4
ARCHES = ["mamba2_370m", "jamba_1_5_large", "starcoder2_3b",
          "whisper_large_v3"]
EXPECTED_KINDS = {
    "mamba2_370m": {"conv", "ssm"},
    "jamba_1_5_large": {"k", "v", "conv", "ssm"},
    "starcoder2_3b": {"k", "v"},
    "starcoder2_3b:int8": {"k", "v", "kscale", "vscale"},
    "whisper_large_v3": {"k", "v", "cross_k", "cross_v", "enc_pos"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (faster at smoke size, and it
    leaves the cores to the other test processes).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kind(key: str) -> str:
    return key.rstrip("0123456789")


def _bits(x) -> np.ndarray:
    """An array's bits, bf16 as int16 words, from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------ slot pages, bitwise

def _filled(spec, batch=3, max_seq=16, page_size=4, seed=1):
    """A cache of `spec` ("arch" or "arch:int8") with random contents in
    every leaf and a random per-row PERMUTATION as its page table, in both
    packages (the JAX one, and the port's crossed from it)."""
    arch, _, kvq = spec.partition(":")
    cfg = jax_smoke_config(arch)
    jc = jax_model(cfg).init_cache(cfg, batch, max_seq, page_size=page_size,
                                   kv_quant=kvq or None)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in jc.items():
        if k == "pos":
            out[k] = v
        elif k == "page_table":
            out[k] = jnp.asarray(np.stack(
                [rng.permutation(v.shape[1]) for _ in range(v.shape[0])]),
                jnp.int32)
        elif jnp.issubdtype(v.dtype, jnp.floating):
            out[k] = jnp.asarray(rng.standard_normal(v.shape), v.dtype)
        else:
            out[k] = jnp.asarray(rng.integers(1, 7, v.shape), v.dtype)
    tc = interop.cache_from_jax(jax.tree.map(np.asarray, out), CPU)
    return cfg, get_smoke_config(arch), out, tc


@pytest.mark.parametrize("spec", ARCHES + ["starcoder2_3b:int8"])
@pytest.mark.parametrize("chunks", [1, 3])
def test_slot_pages_bitwise_jax_and_round_trip(spec, chunks):
    """Row 1's pages equal the JAX extract's bit for bit, leaf for leaf;
    through host memory in `chunks` pieces a leaf and back into a zeroed
    cache they restore row 1 exactly, write nothing else, and equal the
    JAX insert's cache."""
    jcfg, tcfg, jc, tc = _filled(spec)
    fns = get_model(tcfg)
    jleaves = jax_model(jcfg).extract_slot(jcfg, jc, 1, None)
    leaves = fns.extract_slot(tcfg, tc, 1)
    assert {_kind(k) for k in leaves} == EXPECTED_KINDS[spec]
    assert leaves.keys() == jleaves.keys()
    for k, v in leaves.items():
        assert tuple(v.shape) == tuple(jleaves[k].shape), k
        np.testing.assert_array_equal(_bits(v), _bits(jleaves[k]), k)

    snap = BS.stream_offload_to_host(leaves, chunks=chunks)
    assert snap.event is None and snap.nbytes == sum(
        v.numel() * v.element_size() for v in leaves.values()) > 0
    back = BS.stream_offload_to_device(snap.materialize(), CPU,
                                       chunks=chunks)
    zero = {k: (v if k in ("pos", "page_table") else torch.zeros_like(v))
            for k, v in tc.items()}
    fns.insert_slot(tcfg, zero, back, 1)
    jzero = {k: (v if k in ("pos", "page_table") else jnp.zeros_like(v))
             for k, v in jc.items()}
    jback = jax_model(jcfg).insert_slot(jcfg, jzero, jleaves, 1)
    for k, v in tc.items():
        if k in ("pos", "page_table"):
            continue
        got = _bits(zero[k])
        np.testing.assert_array_equal(got, _bits(jback[k]), k)
        if v.dim() >= 2:
            row, others = got[:, 1], got[:, [0, 2]]
            np.testing.assert_array_equal(row, _bits(v)[:, 1], k)
        else:
            row, others = got[1], got[[0, 2]]
            assert row == _bits(v)[1], k
        assert not others.any(), (k, "wrote outside the slot row")


def test_page_set_moves_across_placements():
    """A page set extracted under one placement restores under another
    row's table: the logical rows are equal."""
    _, tcfg, _, src = _filled("starcoder2_3b:int8", batch=2, seed=1)
    _, _, _, dst = _filled("starcoder2_3b:int8", batch=2, seed=2)
    assert not torch.equal(src["page_table"], dst["page_table"])
    fns = get_model(tcfg)
    host = BS.stream_offload_to_host(fns.extract_slot(tcfg, src, 0),
                                     chunks=2).materialize()
    fns.insert_slot(tcfg, dst, BS.stream_offload_to_device(host, CPU), 1)
    ta, tb = src["page_table"][0].long(), dst["page_table"][1].long()
    for k in src:
        if _kind(k) in ("k", "v"):
            a = src[k][:, 0].reshape(src[k].shape[0], src[k].shape[2], 4,
                                     4, -1)
            b = dst[k][:, 1].reshape(a.shape)
            assert torch.equal(a[:, :, ta], b[:, :, tb]), k
        elif _kind(k) in ("kscale", "vscale"):
            assert torch.equal(src[k][:, 0][..., ta], dst[k][:, 1][..., tb])


@pytest.mark.parametrize("arch", ["starcoder2_3b", "whisper_large_v3"])
def test_upto_cuts_kv_to_whole_pages_as_jax(arch):
    """`upto` 7 cuts the K/V page sets to ceil(7 / 4) = 2 logical pages
    and leaves every other leaf whole (cross-K/V is keyed on frames), as
    the JAX extract does."""
    jcfg, tcfg, jc, tc = _filled(arch, batch=2)
    jleaves = jax_model(jcfg).extract_slot(jcfg, jc, 0, 7)
    leaves = get_model(tcfg).extract_slot(tcfg, tc, 0, 7)
    for k, v in leaves.items():
        if _kind(k) in ("k", "v"):
            assert v.shape[3:5] == (2, 4), (k, v.shape)
        elif _kind(k) in ("cross_k", "cross_v"):
            assert v.shape[3] == tcfg.enc_len
        np.testing.assert_array_equal(_bits(v), _bits(jleaves[k]), k)


def test_slot_state_save_restore_round_trip():
    """A slot-state row survives save -> host -> restore into another
    slot: every field continues (the clock, the chain head, the budget,
    the stops, the sampling parameters, alive, the accept counters), the
    other rows are untouched, and the restored row equals the JAX
    restore's."""
    key = prng.PRNGKey(3)
    state = steps.admit_slot(
        steps.init_slot_state(3, CPU), 1, token=7, position=11, key=key,
        remaining=6, temperature=0.7, top_k=12, top_p=0.9, min_p=0.05,
        stop=(5, 9))
    state = dataclasses.replace(state, accepted=state.accepted + 4,
                                proposed=state.proposed + 6)
    saved = BS.stream_offload_to_host(
        steps.save_slot_state(state, 1)).materialize()
    fresh = steps.init_slot_state(3, CPU)
    back = steps.restore_slot(fresh, 2, saved)
    for got, want, idle in zip(steps.state_tensors(back),
                               steps.state_tensors(state),
                               steps.state_tensors(fresh)):
        assert torch.equal(got[2], want[1])
        assert torch.equal(got[[0, 1]], idle[[0, 1]])
        assert not torch.equal(idle[2], got[2]) or torch.equal(idle[2],
                                                               want[1])
    jstate = jsteps.admit_slot(
        jsteps.init_slot_state(3), 1, token=7, position=11,
        key=jax.random.PRNGKey(3), remaining=6, temperature=0.7, top_k=12,
        top_p=0.9, min_p=0.05,
        stop=jnp.asarray(np.array([5, 9, -1, -1], np.int32)))
    jstate = jstate._replace(accepted=jstate.accepted + 4,
                             proposed=jstate.proposed + 6)
    jback = jsteps.restore_slot(jsteps.init_slot_state(3), 2,
                                jax.device_get(
                                    jsteps.save_slot_state(jstate, 1)))
    for name in ("tokens", "positions", "keys", "remaining", "alive",
                 "stop", "accepted", "proposed"):
        np.testing.assert_array_equal(
            getattr(back, name).numpy().astype(np.int64),
            np.asarray(getattr(jback, name)).astype(np.int64), name)
    for f in dataclasses.fields(back.sampling):
        np.testing.assert_array_equal(
            getattr(back.sampling, f.name).numpy(),
            np.asarray(getattr(jback.sampling, f.name)), f.name)


# --------------------------------------------- int8 K/V writes past start 0

@pytest.mark.parametrize("start,t", [(0, 150), (5, 40), (128, 150),
                                     (130, 200)])
def test_quant_kv_write_rows_bitwise_equal_jax(start, t):
    """Rows [start, start + t) into an int8 pool of 128-row pages under a
    permuted table, over a previous occupant's quants and scales: fresh
    pages, and at start 5 and 130 a boundary page whose scale merges with
    the old one (grown for some (layer, head), kept for others) and whose
    kept rows are re-quantized.  Pool and scales equal the jitted JAX
    function's bit for bit."""
    l, b, kh, s, hd, ps = 2, 3, 2, 512, 16, 128
    rng = np.random.default_rng(start)
    pool = rng.integers(-127, 128, (l, b, kh, s, hd)).astype(np.int8)
    scales = rng.uniform(0.005, 0.03, (l, b, kh, s // ps)).astype(np.float32)
    amp = rng.uniform(0.3, 6.0, (l, 1, kh, 1)).astype(np.float32)
    vals = (rng.standard_normal((l, t, kh, hd)) * amp).astype(np.float32)
    prow = rng.permutation(s // ps).astype(np.int32)
    jfn = jax.jit(JT.quant_kv_write_rows, static_argnums=(6,))
    jp, js = jfn(jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(vals),
                 1, start, jnp.asarray(prow), ps)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    T.quant_kv_write_rows(tp, ts, torch.from_numpy(vals), 1,
                          torch.from_numpy(prow), ps, start)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not np.array_equal(tp.numpy(), pool)


# --------------------------------------------------- resume prefill, f32

@functools.lru_cache(maxsize=None)
def _f32_params(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    jp = JT.init_params(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return jcfg, tcfg, jp, interop.params_from_jax(
        jax.tree.map(np.asarray, jp), CPU)


FULL_LEN, START = 12, 7


@pytest.mark.parametrize("spec", ["starcoder2_3b", "starcoder2_3b:int8",
                                  "mamba2_370m", "jamba_1_5_large",
                                  "gemma3_12b"])
def test_resume_prefill_matches_jax_f32(spec):
    """A prefix prefill of 7 tokens, then the suffix (8 bucketed, 5 true)
    resumed from start 7 with pages of 4 (a boundary page), in both
    packages in f32: the last-token logits and every written leaf of the
    row (K/V rows [0, 12), dequantized on an int8 cache; the recurrent
    states) within 1e-4."""
    arch, _, kvq = spec.partition(":")
    jcfg, tcfg, jp, tp = _f32_params(arch)
    toks = np.random.default_rng(0).integers(1, jcfg.vocab, 16).astype(
        np.int32)
    jc = JT.init_cache(jcfg, 2, 32, page_size=4, kv_quant=kvq or None)
    tc = interop.cache_from_jax(jax.tree.map(np.asarray, jc), CPU)
    _, jc = jax.jit(functools.partial(JT.prefill_into_cache, jcfg))(
        jp, jc, jnp.asarray(toks), 1, START)
    jl, jc = jax.jit(functools.partial(JT.resume_prefill_into_cache, jcfg))(
        jp, jc, jnp.asarray(toks[START:START + 8]), 1, FULL_LEN, START)
    T.prefill_into_cache(tcfg, tp, tc, torch.from_numpy(toks), 1, START)
    tl, tc = T.resume_prefill_into_cache(
        tcfg, tp, tc, torch.from_numpy(toks[START:START + 8].copy()), 1,
        FULL_LEN, START)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    jrow = jax_model(jcfg).extract_slot(jcfg, jc, 1, FULL_LEN)
    trow = T.extract_slot_cache(tcfg, tc, 1, FULL_LEN)
    for k, v in trow.items():
        if _kind(k) in ("kscale", "vscale"):
            continue
        got, want = _np(v), _np(jrow[k])
        if _kind(k) in ("k", "v"):
            if kvq:
                got = got * _np(trow[T.scale_key(k)])[..., None, None]
                want = want * _np(jrow[T.scale_key(k)])[..., None, None]
            got = got.reshape(got.shape[:3] + (-1, got.shape[-1]))
            want = want.reshape(got.shape)
            got, want = got[:, :, :, :FULL_LEN], want[:, :, :, :FULL_LEN]
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=k)


def test_mamba_resume_equals_full_prefill_bitwise():
    """In the port on the CPU (the sequential SSD recurrence, the model
    dtype bf16), a resume from a 7-token prefix gives the full 12-token
    prefill's logits, conv window and SSM state bit for bit: the
    recurrence visits the same states, and every per-token value
    (projections, softplus, conv) is the same in a prompt of 8 and one of
    16 rows."""
    cfg = get_smoke_config("mamba2_370m")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, 16).astype(np.int32))
    full = T.init_cache(cfg, 2, 32, device=CPU)
    la, _ = T.prefill_into_cache(cfg, params, full, toks, 1, FULL_LEN)
    part = T.init_cache(cfg, 2, 32, device=CPU)
    T.prefill_into_cache(cfg, params, part, toks, 1, START)
    lb, _ = T.resume_prefill_into_cache(cfg, params, part,
                                        toks[START:START + 8].clone(), 1,
                                        FULL_LEN, START)
    np.testing.assert_array_equal(_bits(lb), _bits(la))
    for k in full:
        if k != "pos":
            np.testing.assert_array_equal(_bits(part[k][:, 1]),
                                          _bits(full[k][:, 1]), k)


# ----------------------------------------------------------- the servers

@pytest.fixture
def f32(monkeypatch):
    """Both packages' smoke configs in f32 arithmetic."""
    for mod in (jserve, tserve):
        orig = mod.get_smoke_config
        monkeypatch.setattr(mod, "get_smoke_config", lambda a, _o=orig:
                            dataclasses.replace(_o(a), dtype="float32"))


def _workload(mod, cfg, n, max_new=12, sampled=False):
    """tests/test_cache_offload.py's oversubscribed workload: prompts of
    4-9 tokens, odd requests sampled with the EOS as their stop when
    `sampled`; an enc-dec request brings enc_len random frames."""
    rng = np.random.default_rng(7)
    erng = np.random.default_rng(11)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 10))
        prompt = rng.integers(1, cfg.vocab, plen).astype(np.int32)
        embeds = None
        if cfg.enc_dec:
            embeds = erng.standard_normal(
                (cfg.enc_len, cfg.d_model)).astype(np.float32)
        sampling = None
        if sampled and i % 2:
            sampling = mod.SamplingParams(temperature=0.8, top_p=0.9,
                                          seed=100 + i,
                                          stop_tokens=(cfg.eos_token,))
        reqs.append(mod.Request(i, prompt, max_new, embeds=embeds,
                                sampling=sampling))
    return reqs


_SERVE = dict(smoke=True, batch_slots=2, max_seq=64, seg_len=4,
              protocol="bs")


def _streams(srv):
    return {r.rid: tuple(r.generated) for r in srv.completed}


_JAX_PARAMS = {}


def _jax_serve(arch, reqs, **kw):
    srv = jserve.BatchedServer(arch, **_SERVE, **kw)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained(max_steps=100_000)
    _JAX_PARAMS[arch, srv.cfg.dtype] = srv.params
    return srv


class _Checked(tserve.BatchedServer):
    """Asserts the page ledger after every consumed segment."""

    def _consume_segment(self, *a, **kw):
        super()._consume_segment(*a, **kw)
        self.assert_ledger()


def _port_serve(arch, reqs, **kw):
    cfg = tserve.get_smoke_config(arch)
    params = interop.params_from_jax(
        jax.tree.map(np.asarray, _JAX_PARAMS[arch, cfg.dtype]), CPU)
    srv = _Checked(arch, device="cpu", params=params, **_SERVE, **kw)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained(max_steps=100_000)
    assert srv.pages_allocated == srv.pages_freed
    assert all(r is None for r in srv.active) and not srv.suspended
    return srv


def _step_key(seed, t):
    """The key token t of a request is drawn with."""
    key = prng.PRNGKey(seed)
    for _ in range(t + 1):
        key, sub = prng.split(key)
    return sub


def _at_near_tie(srv, req, prefix, a, b):
    """Whether tokens a and b are both choices within the near-tie gates
    after req's prompt + prefix, in the port's logits replayed by a
    prefill: for a greedy row within NEAR_TIE of each other, for a
    sampled one both reached by the port's sampler under perturbations
    of the logits of at most LOGIT_TIE_F32."""
    toks = np.concatenate([req.prompt, np.asarray(prefix, np.int32)])
    model = get_model(srv.cfg)
    cache = model.init_cache(srv.cfg, 1, 64, device=CPU)
    args = ()
    if srv.cfg.enc_dec:
        args = (torch.from_numpy(req.embeds)[None],)
    lf, _ = model.prefill_into_cache(srv.cfg, srv.params, cache,
                                     torch.from_numpy(toks), 0, len(toks),
                                     *args)
    lf = lf.float()[None]
    sp = req.sampling_params
    if sp.greedy:
        return abs(float(lf[0, a] - lf[0, b])) < NEAR_TIE
    one = ops.BatchedSampling(
        torch.tensor([sp.temperature]),
        torch.tensor([sp.top_k], dtype=torch.int32),
        torch.tensor([sp.top_p]), torch.tensor([sp.min_p]))
    key = _step_key(sp.seed, len(prefix))[None]
    gen = torch.Generator().manual_seed(0)
    reached = {int(ops.sample_tokens(lf, one, key, vocab=srv.cfg.vocab)[0])}
    for _ in range(64):
        noise = (torch.rand(lf.shape, generator=gen) * 2 - 1) * LOGIT_TIE_F32
        reached.add(int(ops.sample_tokens(lf + noise, one, key,
                                          vocab=srv.cfg.vocab)[0]))
    return {a, b} <= reached


def _near_tie_agree(srv, got, want, reqs):
    """Equal streams, or streams that part at a near tie.  Returns whether
    all are equal."""
    assert got.keys() == want.keys()
    for req in reqs:
        a, b = got[req.rid], want[req.rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        assert _at_near_tie(srv, req, a[:t], a[t], b[t]), (req.rid, t, a, b)
    return got == want


def _tier_closed(srv, n_req):
    """Every eviction restored or found dead, the host tier drained, its
    bytes closed, and the syncs: one a consumed segment for decode, one
    an admission or a restore besides."""
    assert srv.restores + srv.restored_dead == srv.evictions > 0
    assert any(r.suspensions > 0 for r in srv.completed)
    assert len(srv.host_tier) == 0
    assert srv.host_tier.bytes_evicted == srv.host_tier.bytes_restored > 0
    assert srv.host_syncs - srv.decode_syncs == n_req + srv.evictions


@pytest.mark.parametrize("arch,sampled,stream", [
    ("starcoder2_3b", False, True), ("starcoder2_3b", True, True),
    ("starcoder2_3b", True, False), ("mamba2_370m", True, True),
    ("whisper_large_v3", False, True)],
    ids=["starcoder2-greedy-stream", "starcoder2-sampled-stream",
         "starcoder2-sampled-per_token", "mamba2-sampled-stream",
         "whisper-greedy-stream"])
def test_evicting_server_matches_jax_and_non_evicting(f32, arch, sampled,
                                                      stream):
    """6 requests over 2 slots, evict_after 1: the port's streams equal
    the JAX evicting server's up to a near tie (and its eviction counts
    where all are equal), and the port's non-evicting server's bit for
    bit, with the tier's accounting closed."""
    cfg = tserve.get_smoke_config(arch)
    jsrv = _jax_serve(arch, _workload(jserve, cfg, 6, sampled=sampled),
                      stream=stream, host_offload=True, evict_after=1)
    reqs = _workload(tserve, cfg, 6, sampled=sampled)
    off = _port_serve(arch, reqs, stream=stream, host_offload=True,
                      evict_after=1)
    base = _port_serve(arch, _workload(tserve, cfg, 6, sampled=sampled),
                       stream=stream)
    assert _streams(off) == _streams(base)
    _tier_closed(off, 6)
    if not sampled:
        assert off.decode_syncs == base.decode_syncs
    if _near_tie_agree(off, _streams(off), _streams(jsrv), reqs):
        assert (off.evictions, off.restores, off.restored_dead,
                off.decode_syncs) == (jsrv.evictions, jsrv.restores,
                                      jsrv.restored_dead, jsrv.decode_syncs)


def test_evicting_spec_server_matches_jax_and_non_evicting(f32):
    """Speculative (self:1, spec_k 2) with the draft's row evicted with
    the target's: the JAX evicting spec server's streams up to a near
    tie, the port's non-evicting spec server's bit for bit, the accept
    counters carried across evictions."""
    arch = "starcoder2_3b"
    cfg = tserve.get_smoke_config(arch)
    kw = dict(stream=True, spec=True, spec_k=2, draft_arch="self:1")
    jsrv = _jax_serve(arch, _workload(jserve, cfg, 6), host_offload=True,
                      evict_after=1, **kw)
    reqs = _workload(tserve, cfg, 6)
    off = _port_serve(arch, reqs, host_offload=True, evict_after=1, **kw)
    base = _port_serve(arch, _workload(tserve, cfg, 6), **kw)
    assert _streams(off) == _streams(base)
    _tier_closed(off, 6)
    assert (off.draft_accepted, off.draft_proposed) == \
        (base.draft_accepted, base.draft_proposed)
    assert sum(r.spec_proposed for r in off.completed) == \
        sum(r.spec_proposed for r in base.completed) > 0
    if _near_tie_agree(off, _streams(off), _streams(jsrv), reqs):
        assert (off.evictions, off.draft_accepted) == (jsrv.evictions,
                                                       jsrv.draft_accepted)


def _prefix_requests(mod, cfg):
    """tests/test_cache_offload.py's: a miss, its repeat (sampled: a
    full hit), and its extension (a partial hit)."""
    rng = np.random.default_rng(3)
    common = rng.integers(1, cfg.vocab, 9).astype(np.int32)
    ext = np.concatenate([common,
                          rng.integers(1, cfg.vocab, 5).astype(np.int32)])
    return [mod.Request(0, common.copy(), 8),
            mod.Request(1, common.copy(), 8,
                        sampling=mod.SamplingParams(temperature=0.7,
                                                    seed=5)),
            mod.Request(2, ext.copy(), 8)]


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
def test_prefix_cache_matches_jax_and_no_cache(f32, arch):
    """The counts (1 full, 1 partial, 1 miss), the tokens skipped and the
    forwards are the JAX prefix server's; its streams up to a near tie.
    Against the port's no-cache server: the miss and the full hit (first
    token from the stored logits) bit for bit, the partial hit by the
    near-tie gate (bit for bit for mamba: its resume is the full
    prefill's recurrence)."""
    cfg = tserve.get_smoke_config(arch)
    jsrv = _jax_serve(arch, _prefix_requests(jserve, cfg), stream=True,
                      prefix_cache=True)
    reqs = _prefix_requests(tserve, cfg)
    pc = _port_serve(arch, reqs, stream=True, prefix_cache=True)
    base = _port_serve(arch, _prefix_requests(tserve, cfg), stream=True)
    got, want = _streams(pc), _streams(base)
    assert (pc.prefix_hits_full, pc.prefix_hits_partial,
            pc.prefix_misses) == (1, 1, 1)
    assert pc.prefill_tokens_skipped == 9 * 2
    assert (pc.prefill_forwards, base.prefill_forwards) == (2, 3)
    assert (got[0], got[1]) == (want[0], want[1])
    _near_tie_agree(pc, got, want, reqs)
    if arch == "mamba2_370m":
        assert got == want
    _near_tie_agree(pc, got, _streams(jsrv), reqs)
    assert (pc.prefix_hits_full, pc.prefix_hits_partial, pc.prefix_misses,
            pc.prefill_tokens_skipped, pc.prefill_forwards) == \
        (jsrv.prefix_hits_full, jsrv.prefix_hits_partial,
         jsrv.prefix_misses, jsrv.prefill_tokens_skipped,
         jsrv.prefill_forwards)


def test_jamba_prefix_hits_match_the_no_cache_server():
    """jamba_1_5_large (attention and mamba layers, MoE): its partial hit
    is held to the port's own no-cache server by the near-tie gate, not
    to the JAX server (the reference's own jamba partial hit parts from
    its baseline: ROADMAP queue 3); the full hit and the miss bit for
    bit, the counts as on the other archs."""
    arch = "jamba_1_5_large"
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)

    def serve(prefix_cache):
        srv = _Checked(arch, device="cpu", params=params,
                       prefix_cache=prefix_cache, stream=True, **_SERVE)
        for r in _prefix_requests(tserve, cfg):
            srv.submit(r)
        srv.run_until_drained(max_steps=100_000)
        return srv

    pc, base = serve(True), serve(False)
    got, want = _streams(pc), _streams(base)
    assert (pc.prefix_hits_full, pc.prefix_hits_partial,
            pc.prefix_misses) == (1, 1, 1)
    assert (got[0], got[1]) == (want[0], want[1])
    _near_tie_agree(pc, got, want, _prefix_requests(tserve, cfg))


def test_prefix_trie_longest_match_lru_and_pruning():
    snap = BS.stream_offload_to_host({"x": torch.zeros((4, 8))})
    pc = BS.PrefixCache(capacity_bytes=None)
    pc.put([1, 2], snap)
    pc.put([1, 2, 3], snap)
    assert pc.lookup([1, 2, 3, 4]).length == 3       # longest wins
    assert pc.lookup([1, 2, 9]).length == 2          # falls back
    assert pc.lookup([2]) is None
    small = BS.PrefixCache(capacity_bytes=snap.nbytes + 1)
    small.put([5], snap)
    small.put([6], snap)
    assert small.entries_evicted == 1 and len(small) == 1
    assert small.lookup([5]) is None and small.lookup([6]) is not None
    assert list(small._root.children) == [6]         # pruned, not orphaned
    # a lookup refreshes recency: [7] then evicts [8], not [7]
    lru = BS.PrefixCache(capacity_bytes=2 * snap.nbytes + 1)
    lru.put([7], snap)
    lru.put([8], snap)
    assert lru.lookup([7, 1]).length == 1
    lru.put([9], snap)
    assert lru.lookup([8]) is None and lru.lookup([7]) is not None


@pytest.mark.parametrize("arch,kw", [
    ("starcoder2_3b", dict(spec=True, draft_arch="self:1")),
    ("whisper_large_v3", {})], ids=["spec", "encdec"])
def test_prefix_cache_refusals(arch, kw):
    with pytest.raises(ValueError, match="prefix_cache"):
        tserve.BatchedServer(arch, device="cpu", batch_slots=1, max_seq=16,
                             prefix_cache=True, **kw)
