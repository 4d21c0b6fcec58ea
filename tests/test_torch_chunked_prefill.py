"""Chunked admission prefill in the port (`steps.make_chunked_prefill`,
`run_chunked_prefill`; `BatchedServer(prefill_chunk=C)`: `_begin_chunked`,
`_pump_prefill`, the masked segment while a slot is reserved) against the
JAX package, mirroring tests/test_paged_cache.py and
tests/test_serve_churn.py, on smoke configs.

Across the two packages, on the same numpy weights and prompts:
  * `run_chunked_prefill` in f32 arithmetic (starcoder2_3b, mamba2_370m,
    jamba_1_5_large, gemma3_12b across its window of 32, and q8_0 weights
    with an int8 K/V cache at a chunk that starts mid-page): the last
    logits and the row's written K/V rows and recurrent states within
    1e-4; in bf16 (starcoder2_3b) the logits within 0.05 (a few bf16
    units of logits of order 1);
  * the chunked servers in f32 arithmetic, in the reference's own chunked
    setups: streams equal except where one parts at a near tie (the two
    choices within 0.1 in the port's replayed logits), counts equal where
    every stream is.
Inside the port, bit for bit: the streams in flight while a long prompt
admits in chunks equal the run without it and retire at the same decode
sync; a reserved slot's segments are the write-masked ones; evicting ==
non-evicting with a slot reserved.  Chunked against one-shot admission:
the near-tie gate (the resume merges two softmax partials in another
order than the one-pass prefill); bit for bit for mamba.
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
from repro.models import quantize as JQ                        # noqa: E402
from repro.models import transformer as JT                     # noqa: E402
from repro.models.registry import get_model as jax_model       # noqa: E402
from repro_torch import interop                                # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.launch import steps                           # noqa: E402
from repro_torch.models import transformer as T                # noqa: E402

CPU = torch.device("cpu")
ATOL, ATOL_BF16 = 1e-4, 0.05
NEAR_TIE = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (faster at smoke size, and it
    leaves the cores to the other test processes).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bits(x) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


# ------------------------------------------------ run_chunked_prefill

# spec -> (prompt length, chunk, max_seq, page size)
CHUNKED = {
    "starcoder2_3b": (40, 16, 64, 8),
    "mamba2_370m": (40, 16, 64, None),
    "jamba_1_5_large": (40, 16, 64, 8),
    "gemma3_12b": (70, 16, 96, 16),
    # chunks of 12 start at rows 12, 24, 36: mid-page of pages of 8
    "starcoder2_3b:q8_0:int8": (40, 12, 64, 8),
}


@functools.lru_cache(maxsize=None)
def _params(arch, dtype, wq):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.key(0))
    if wq:
        jp = JQ.quantize_params(jp, wq)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    return jcfg, tcfg, jp, interop.params_from_jax(
        jax.tree.map(np.asarray, jp), CPU)


def _chunked_both(spec, dtype):
    """The prompt through both packages' `run_chunked_prefill` into row 1
    of a 2-row cache.  Returns (JAX logits, cache), (port logits, cache),
    the configs and the prompt length."""
    arch, wq, kvq = (spec.split(":") + [None, None])[:3]
    plen, c, max_seq, page = CHUNKED[spec]
    jcfg, tcfg, jp, tp = _params(arch, dtype, wq)
    toks = np.random.default_rng(0).integers(1, jcfg.vocab, plen).astype(
        np.int32)
    jc = JT.init_cache(jcfg, 2, max_seq, page_size=page, kv_quant=kvq)
    tc = interop.cache_from_jax(jax.tree.map(np.asarray, jc), CPU)
    jcp = jsteps.make_chunked_prefill(jcfg)
    jcp = jcp._replace(first=jax.jit(jcp.first), resume=jax.jit(jcp.resume))
    jl, jc = jsteps.run_chunked_prefill(jcp, jp, jc, jnp.asarray(toks), 1, c)
    tcp = steps.make_chunked_prefill(tcfg)
    assert tcp.plan(plen, c) == jcp.plan(plen, c)
    tl, tc = steps.run_chunked_prefill(tcp, tp, tc, torch.from_numpy(toks),
                                       1, c)
    return (jl, jc), (tl, tc), jcfg, tcfg, plen


@pytest.mark.parametrize("spec", list(CHUNKED))
def test_run_chunked_prefill_matches_jax_f32(spec):
    """f32 arithmetic: the last-token logits and every written leaf of the
    row (K/V rows [0, P), dequantized on an int8 cache; the recurrent
    states) within 1e-4 of the JAX package's."""
    (jl, jc), (tl, tc), jcfg, tcfg, plen = _chunked_both(spec, "float32")
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    jrow = jax_model(jcfg).extract_slot(jcfg, jc, 1, plen)
    trow = T.extract_slot_cache(tcfg, tc, 1, plen)
    assert trow.keys() == jrow.keys()
    for k, v in trow.items():
        kind = k.rstrip("0123456789")
        if kind in ("kscale", "vscale"):
            continue
        got, want = _np(v), _np(jrow[k])
        if kind in ("k", "v"):
            if T.scale_key(k) in trow:
                got = got * _np(trow[T.scale_key(k)])[..., None, None]
                want = want * _np(jrow[T.scale_key(k)])[..., None, None]
            got = got.reshape(got.shape[:3] + (-1, got.shape[-1]))[..., :plen,
                                                                   :]
            want = want.reshape(want.shape[:3] + (-1, want.shape[-1]))[
                ..., :plen, :]
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=k)


def test_run_chunked_prefill_matches_jax_bf16():
    """The model dtype, bf16: the last-token logits within 0.05."""
    (jl, _), (tl, _), _, _, _ = _chunked_both("starcoder2_3b", "bfloat16")
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL_BF16)


def test_mamba_chunked_prefill_equals_one_shot_bitwise():
    """mamba2_370m in the port (bf16): the chunks' recurrence visits the
    one-shot prefill's states, so logits and states are its bits."""
    cfg = get_smoke_config("mamba2_370m")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, 40).astype(np.int32))
    one = T.init_cache(cfg, 2, 64, device=CPU)
    la, _ = T.prefill_into_cache(cfg, params, one, toks, 1, 40)
    chunked = T.init_cache(cfg, 2, 64, device=CPU)
    lb, _ = steps.run_chunked_prefill(steps.make_chunked_prefill(cfg), params,
                                      chunked, toks, 1, 16)
    np.testing.assert_array_equal(_bits(lb), _bits(la))
    for k in one:
        if k != "pos":
            np.testing.assert_array_equal(_bits(chunked[k][:, 1]),
                                          _bits(one[k][:, 1]), k)


# ------------------------------------------------------------ the servers

@pytest.fixture
def f32(monkeypatch):
    """Both packages' smoke configs in f32 arithmetic."""
    for mod in (jserve, tserve):
        orig = mod.get_smoke_config
        monkeypatch.setattr(mod, "get_smoke_config", lambda a, _o=orig:
                            dataclasses.replace(_o(a), dtype="float32"))


def _tracking(cls):
    """The server with the page ledger asserted after every consumed
    segment, each request's decode syncs at retirement (`retire_syncs`),
    and each dispatched segment's variant beside whether a slot was
    reserved then (`variants`: (plain, reserved))."""
    class Tracking(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.retire_syncs, self.variants = {}, []

        def _run_segment(self, fn):
            plain = fn in (self.segment_plain_fn, self.step_plain_fn)
            self.variants.append((plain, bool(self.prefilling)))
            return super()._run_segment(fn)

        def _consume_segment(self, *a, **kw):
            before = {r.rid for r in self.completed}
            super()._consume_segment(*a, **kw)
            self.assert_ledger()
            for r in self.completed:
                if r.rid not in before and r.rid not in self.retire_syncs:
                    self.retire_syncs[r.rid] = self.decode_syncs
    return Tracking


_JAX_PARAMS = {}


def _jax_serve(arch, prompts, max_new, **kw):
    srv = _tracking(jserve.BatchedServer)(arch, smoke=True, protocol="bs",
                                          **kw)
    for i, p in enumerate(prompts):
        srv.submit(jserve.Request(i, p, max_new))
    srv.run_until_drained(max_steps=100_000)
    _JAX_PARAMS[arch, srv.cfg.dtype] = srv.params
    return srv


def _port_serve(arch, prompts, max_new, params=None,
                cls=tserve.BatchedServer, **kw):
    cfg = tserve.get_smoke_config(arch)
    if params is None:
        params = interop.params_from_jax(
            jax.tree.map(np.asarray, _JAX_PARAMS[arch, cfg.dtype]), CPU)
    srv = _tracking(cls)(arch, device="cpu", params=params, protocol="bs",
                         **kw)
    for i, p in enumerate(prompts):
        srv.submit(tserve.Request(i, p, max_new))
    srv.run_until_drained(max_steps=100_000)
    assert srv.pages_allocated == srv.pages_freed
    assert srv.pages_resident == 0 and not srv.prefilling
    assert all(r is None for r in srv.active)
    return srv


def _streams(srv):
    return {r.rid: tuple(r.generated) for r in srv.completed}


def _near_tie_agree(srv, got, want, prompts):
    """Equal streams, or streams that part where the two choices are
    within NEAR_TIE in the port's logits of a one-shot prefill of the
    common prefix.  Returns whether all are equal."""
    assert got.keys() == want.keys()
    for rid, a in got.items():
        b = want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[rid], np.asarray(a[:t], np.int32)])
        cache = T.init_cache(srv.cfg, 1, 64, device=CPU)
        lg, _ = T.prefill_into_cache(srv.cfg, srv.params, cache,
                                     torch.from_numpy(seq), 0, len(seq))
        assert abs(float(lg[a[t]] - lg[b[t]])) < NEAR_TIE, (rid, t, a, b)
    return got == want


def _paged_cache_prompts(vocab):
    """tests/test_paged_cache.py's: two prompts of 9-13 tokens, two of 4."""
    rng = np.random.default_rng(31)
    return [rng.integers(1, vocab, int(rng.integers(9, 14)) if i < 2 else 4
                         ).astype(np.int32) for i in range(4)]


PAGED = dict(batch_slots=2, max_seq=32, stream=True, seg_len=4)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m",
                                  "jamba_1_5_large"])
def test_chunked_server_matches_jax_f32(f32, arch):
    """tests/test_paged_cache.py's chunked setup (2 slots, max_seq 32,
    seg_len 4, chunks of 4, 6 tokens a request): the port's streams are
    the JAX chunked server's up to a near tie, with its chunk and forward
    counts where all are equal; and the port's one-shot server's up to a
    near tie (mamba: bit for bit)."""
    prompts = _paged_cache_prompts(jax_smoke_config(arch).vocab)
    jsrv = _jax_serve(arch, prompts, 6, prefill_chunk=4, **PAGED)
    chunked = _port_serve(arch, prompts, 6, prefill_chunk=4, **PAGED)
    one_shot = _port_serve(arch, prompts, 6, **PAGED)
    assert chunked.prefill_chunks > chunked.prefill_forwards == 4
    if _near_tie_agree(chunked, _streams(chunked), _streams(jsrv), prompts):
        assert (chunked.prefill_chunks, chunked.prefill_forwards,
                chunked.decode_syncs) == (jsrv.prefill_chunks,
                                          jsrv.prefill_forwards,
                                          jsrv.decode_syncs)
    _near_tie_agree(chunked, _streams(chunked), _streams(one_shot), prompts)
    if arch == "mamba2_370m":
        assert _streams(chunked) == _streams(one_shot)


def _churn_prompts(vocab):
    """tests/test_serve_churn.py's: three prompts of 3-5 tokens in
    flight, then a 24-token one admitted in chunks of 8."""
    rng = np.random.default_rng(77)
    short = [rng.integers(1, vocab, int(rng.integers(3, 6))).astype(np.int32)
             for _ in range(3)]
    return short, rng.integers(1, vocab, 24).astype(np.int32)


CHURN = dict(batch_slots=4, max_seq=32, stream=True, seg_len=4)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
def test_chunked_admission_leaves_inflight_streams_untouched(f32, arch):
    """tests/test_serve_churn.py's setup: the in-flight streams equal the
    run without the long prompt bit for bit and retire at the same decode
    sync; the long prompt admits in 3 chunks; every segment dispatched
    while its slot was reserved is the write-masked one, though every row
    is greedy (the plain one runs before and after); the streams equal
    the JAX chunked server's up to a near tie, and the long request's its
    one-shot twin's."""
    short, long_p = _churn_prompts(jax_smoke_config(arch).vocab)
    jsrv = _jax_serve(arch, short + [long_p], 10, prefill_chunk=8, **CHURN)
    base = _port_serve(arch, short, 10, **CHURN)
    full = _port_serve(arch, short + [long_p], 10, prefill_chunk=8, **CHURN)
    one_shot = _port_serve(arch, short + [long_p], 10, **CHURN)
    got, want = _streams(full), _streams(base)
    assert {r: got[r] for r in want} == want
    assert {r: full.retire_syncs[r] for r in base.retire_syncs} \
        == base.retire_syncs
    assert full.prefill_chunks == 3 and len(got[3]) == 10
    reserved = [plain for plain, res in full.variants if res]
    assert reserved and not any(reserved)
    assert any(plain for plain, res in full.variants if not res)
    prompts = short + [long_p]
    if _near_tie_agree(full, got, _streams(jsrv), prompts):
        assert full.retire_syncs == jsrv.retire_syncs
    _near_tie_agree(full, got, _streams(one_shot), prompts)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
def test_reserved_slot_never_evicted_and_eviction_is_bitwise(f32, arch):
    """Under host_offload (2 slots, evict_after 1, 6 requests, two of 30
    tokens and those of 9 in chunks of 8): no reserved slot is evicted or
    restored into, slots evicted in a fill are reserved in it, and the
    streams equal the non-evicting chunked server's bit for bit.  The
    evicted row is frozen on the device (`steps.freeze_slot`): where it
    went on decoding, as in the reference, its segments wrote its stale
    rows into the reserved slot (mamba: its state), and request 3's
    stream changed (ROADMAP.md, queue 3)."""
    cfg = tserve.get_smoke_config(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, 30 if i in (2, 4)
                            else int(rng.integers(4, 10))).astype(np.int32)
               for i in range(6)]
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    kw = dict(batch_slots=2, max_seq=64, stream=True, seg_len=4,
              prefill_chunk=8, params=params)

    class Guarded(tserve.BatchedServer):
        evicted_then_reserved = 0

        def _fill_slots(self):
            self._evicted_now = set()
            super()._fill_slots()

        def suspend_slot(self, slot):
            assert slot not in self.prefilling
            self._evicted_now.add(slot)
            super().suspend_slot(slot)
            assert not bool(self.state.alive[slot])

        def _restore(self, slot, req):
            assert slot not in self.prefilling
            return super()._restore(slot, req)

        def _begin_chunked(self, slot, req):
            Guarded.evicted_then_reserved += slot in self._evicted_now
            super()._begin_chunked(slot, req)

    base = _port_serve(arch, prompts, 12, **kw)
    off = _port_serve(arch, prompts, 12, cls=Guarded, host_offload=True,
                      evict_after=1, **kw)
    assert off.evictions > 0 and Guarded.evicted_then_reserved > 0
    assert off.prefill_chunks == base.prefill_chunks > 8
    assert _streams(off) == _streams(base)


def test_chunked_max_seq_edge_matches_jax():
    """The last chunk padded exactly to max_seq (P 30, chunks of 8,
    max_seq 32) gives the JAX chunked server's tokens and the port's
    one-shot ones; one chunk size more (12: rows to 36) is refused at
    submit, where the reference shifts the last chunk's rows."""
    arch = "starcoder2_3b"
    cfg = jax_smoke_config(arch)
    prompt = np.random.default_rng(9).integers(1, cfg.vocab, 30).astype(
        np.int32)
    kw = dict(batch_slots=2, max_seq=32, stream=True, seg_len=4)
    jsrv = _jax_serve(arch, [prompt], 4, prefill_chunk=8, **kw)
    srv = _port_serve(arch, [prompt], 4, prefill_chunk=8, **kw)
    one = _port_serve(arch, [prompt], 4, **kw)
    assert srv.prefill_chunks == 4
    _near_tie_agree(srv, _streams(srv), _streams(jsrv), [prompt])
    _near_tie_agree(srv, _streams(srv), _streams(one), [prompt])
    over = tserve.BatchedServer(arch, device="cpu", prefill_chunk=12, **kw)
    with pytest.raises(ValueError, match="max_seq"):
        over.submit(tserve.Request(0, prompt, 4))


@pytest.mark.parametrize("arch,kw,match", [
    ("starcoder2_3b", dict(spec=True, draft_arch="self:1"), "spec"),
    ("starcoder2_3b", dict(prefix_cache=True), "prefix_cache"),
    ("whisper_large_v3", {}, "encoder-decoder"),
    ("starcoder2_3b", dict(prefill_chunk=0), "a token")],
    ids=["spec", "prefix_cache", "encdec", "empty"])
def test_prefill_chunk_refusals(arch, kw, match):
    kw.setdefault("prefill_chunk", 4)
    with pytest.raises(ValueError, match=match):
        tserve.BatchedServer(arch, device="cpu", batch_slots=1, max_seq=16,
                             **kw)


def test_prefill_chunk_cli(capsys):
    """`--prefill-chunk` through the CLI: the chunks and the closed page
    ledger are printed."""
    assert tserve.main(["--device", "cpu", "--stream", "--requests", "4",
                        "--slots", "2", "--max-seq", "64", "--max-new", "4",
                        "--prefill-chunk", "4"]) == 0
    out = capsys.readouterr().out
    chunks = int(out.split("prefill_chunks=")[1].split()[0])
    alloc, freed = out.split("pages=")[1].split()[0].split("alloc/")
    assert chunks > 4 and alloc == freed.replace("freed", "")
