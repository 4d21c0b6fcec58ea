"""Parity of the port's encoder-decoder (`repro_torch.models.encdec`, the
whisper_large_v3 serve path) with the JAX package at smoke size (2
encoder + 2 decoder layers, d 64, 4 heads of 16, enc_len 32), the JAX
weights and caches crossed over through `repro_torch.interop`, inputs
drawn from numpy seeds.

Tolerances: float32 (`dtype="float32"` in both packages) encoder outputs
within atol = 1e-5, prefill / decode / verify logits and fp cache rows
within 1e-4 (two frameworks order their f32 sums differently through four
layers), int8 K/V rows one rounding step apart at most and their page
scales within rtol 1e-5, greedy tokens equal; bfloat16 encoder outputs
within 0.0625 (four bf16 units of outputs in [2, 4), the largest here;
two were measured: the dense MLP's `F.silu` rounds once where the
reference's rounds per op) and greedy tokens equal except where a stream parts at a near tie (the two
choices' logits within 0.1 in a prefill of the common prefix, the gate of
tests/test_quant.py).  Inside the port: the `enc_out=` prefill equals the
`enc_embeds=` one, a short clip in a batch with a full clip equals the
clip alone, and streamed equals per-token, bitwise."""
import dataclasses
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import backstream as jbs                      # noqa: E402
from repro.kernels import flash_attention as jfa              # noqa: E402
from repro.launch import serve as jserve                      # noqa: E402
from repro.models import encdec as JE                         # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro_torch import configs, interop                      # noqa: E402
from repro_torch.core import backstream as bs                 # noqa: E402
from repro_torch.kernels import build as kbuild               # noqa: E402
from repro_torch.kernels import flash_attention as fa         # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402
from repro_torch.launch import steps                          # noqa: E402
from repro_torch.models import encdec as E                    # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402
from repro_torch.models import registry, transformer          # noqa: E402

ARCH = "whisper_large_v3"
CPU = torch.device("cpu")
ATOL, ENC_ATOL, BF16_ENC_ATOL, NEAR_TIE = 1e-4, 1e-5, 0.0625, 0.1
S, PAGE = 32, 8
SLOTS, SEG_LEN, MAX_NEW = 2, 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: faster at smoke size, and it leaves the cores
    to the other test processes.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype=dtype)
    jp = JE.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, interop.params_from_jax(_tree_np(jp), CPU)


def _frames(rng, e, d=64):
    return rng.standard_normal((1, e, d)).astype(np.float32)


# -------------------------------------------------------- config, params

def test_registry_picks_the_model_functions():
    tcfg = configs.get_smoke_config(ARCH)
    assert registry.get_model(tcfg).decode_step is E.decode_step
    assert registry.get_model(tcfg).prefill_into_cache \
        is E.prefill_into_cache
    dense = configs.get_smoke_config("starcoder2_3b")
    assert registry.get_model(dense).decode_verify \
        is transformer.decode_verify
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        transformer.init_params(tcfg, torch.Generator(), CPU)


def test_init_params_matches_reference_layout():
    """The port's own draw has the reference's tree (enc_blocks,
    dec_blocks, cross, both final norms), shapes and dtypes."""
    want = jax.eval_shape(functools.partial(JE.init_params,
                                            jax_smoke_config(ARCH)),
                          jax.random.key(0))
    got = E.init_params(configs.get_smoke_config(ARCH),
                        torch.Generator().manual_seed(0), CPU)
    flat_w = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_leaves_with_path(got)}
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == w.shape, k
        assert str(flat_g[k].dtype) == f"torch.{w.dtype}", k


def test_blocked_attention_parity():
    """The plain blocked attention against the reference's: non-causal
    over 150 keys in blocks of 75 (the largest divisor of 150 not above
    80), causal with a query offset and two query tiles."""
    rng = np.random.default_rng(1)
    for sq, sk, causal, off, block, tile in ((7, 150, False, 0, 80, 512),
                                             (12, 20, True, 8, 6, 5)):
        q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
                   ((2, sq, 4, 16), (2, sk, 2, 16), (2, sk, 2, 16)))
        want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    q_offset=off, block=block, q_tile=tile)
        got = L.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  q_offset=off, block=block, q_tile=tile)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ENC_ATOL, rtol=ENC_ATOL)


# ----------------------------------------------------------------- encoder

@pytest.mark.parametrize("dtype,e", [("float32", 32), ("float32", 20),
                                     ("bfloat16", 32)])
def test_encode_parity(dtype, e):
    jcfg, tcfg, jp, tp = _setup(dtype)
    emb = _frames(np.random.default_rng(e), e)
    want = jax.jit(functools.partial(JE.encode, jcfg, remat=False))(
        jp, jnp.asarray(emb))
    got = E.encode(tcfg, tp, torch.from_numpy(emb))
    assert got.dtype == getattr(torch, dtype) and got.shape == (1, e, 64)
    tol = ENC_ATOL if dtype == "float32" else BF16_ENC_ATOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


# ------------------------------------------------- prefill, decode, verify

def _admissions(rng, vocab):
    """(row, prompt tokens padded to 16, length, frames): row 1 takes a
    full clip, then row 0 a full clip and row 1 a short one (e = 20) over
    the first, so its cross rows past 20 must be zeroed."""
    out = []
    for row, n, e in ((1, 9, 32), (0, 11, 32), (1, 13, 20)):
        prompt = np.zeros(16, np.int32)
        prompt[:n] = rng.integers(1, vocab, n)
        out.append((row, prompt, n, _frames(rng, e)))
    return out


def _check_cache(got, want):
    assert got.keys() == want.keys()
    for key, w in _tree_np(want).items():
        g = got[key].numpy() if got[key].dtype != torch.bfloat16 \
            else got[key].float().numpy()
        if g.dtype == np.int8:
            # int8 rows: a rounding step apart at most
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, key
        elif key.startswith(("kscale", "vscale")):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=key)
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, w.astype(np.float32), atol=ATOL,
                                       rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@functools.lru_cache(maxsize=None)
def _run_both(kv_quant):
    """The admissions through a permuted page table in both packages in
    f32, then four teacher-forced decode steps (the JAX greedy token fed
    to both; row 1 write-masked at step 2) and a verify of 3 tokens a
    row.  Returns [(jax out, port out)] and both final caches."""
    jcfg, tcfg, jp, tp = _setup("float32")
    rng = np.random.default_rng(3)
    table = np.stack([rng.permutation(S // PAGE) for _ in range(2)]).astype(
        np.int32)
    jcache = JE.init_cache(jcfg, 2, S, page_size=PAGE, kv_quant=kv_quant)
    jcache["page_table"] = jnp.asarray(table)
    tcache = interop.cache_from_jax(_tree_np(jcache), CPU)
    jprefill = jax.jit(functools.partial(JE.prefill_into_cache, jcfg),
                       static_argnums=(4,))
    out, first, pos = [], [0, 0], [0, 0]
    for row, prompt, n, emb in _admissions(rng, jcfg.vocab):
        jl, jcache = jprefill(jp, jcache, jnp.asarray(prompt), row, n,
                              jnp.asarray(emb))
        tl, tcache = E.prefill_into_cache(tcfg, tp, tcache,
                                          torch.from_numpy(prompt), row, n,
                                          torch.from_numpy(emb))
        out.append(("prefill", jl, tl))
        first[row], pos[row] = int(jnp.argmax(jl)), n
    toks = np.asarray(first, np.int32)[:, None]
    pos = np.asarray(pos, np.int32)
    jdecode = jax.jit(functools.partial(JE.decode_step, jcfg))
    for t in range(4):
        mask = np.array([True, t != 2])
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks),
                             positions=jnp.asarray(pos),
                             write_mask=jnp.asarray(mask))
        tl, tcache = E.decode_step(tcfg, tp, tcache, torch.from_numpy(toks),
                                   positions=torch.from_numpy(pos),
                                   write_mask=torch.from_numpy(mask))
        out.append((f"step {t}", jl[:, -1], tl[:, -1]))
        toks = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + mask.astype(np.int32)
    ver = np.concatenate([toks, rng.integers(1, jcfg.vocab, (2, 2)).astype(
        np.int32)], axis=1)
    jl, jcache, jsn = jax.jit(functools.partial(JE.decode_verify, jcfg))(
        jp, jcache, jnp.asarray(ver), jnp.asarray(pos))
    tl, tcache, tsn = E.decode_verify(tcfg, tp, tcache, torch.from_numpy(ver),
                                      torch.from_numpy(pos))
    assert jsn == {} and tsn == {}
    out.append(("verify", jl, tl))
    return out, jcache, tcache


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_prefill_decode_verify_parity_f32(kv_quant):
    """Logits of the three prefills, four decode steps with per-row
    positions and a write mask, and a 3-token verify; every cache leaf at
    the end: the paged self K/V (or int8 pools and scales), cross_k /
    cross_v with row 1's tail past its short clip zeroed, enc_pos."""
    out, jcache, tcache = _run_both(kv_quant)
    for what, jl, tl in out:
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0,
                                   err_msg=what)
    _check_cache(tcache, jcache)
    assert tcache["enc_pos"].tolist() == [32, 20]
    assert not tcache["cross_k"][:, 1, :, 20:].any()
    assert tcache["cross_k"][:, 1, :, :20].abs().min() > 0


def test_prefill_from_enc_out_equals_from_embeds():
    """Handing the prefill the encoder output equals handing it the frames
    it was encoded from, bitwise (bf16: the server's dtype)."""
    _, tcfg, _, tp = _setup("bfloat16")
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(1, 512, 16).astype(np.int32))
    emb = torch.from_numpy(_frames(rng, 24))
    outs = []
    for kw in (dict(enc_embeds=emb),
               dict(enc_out=E.encode(tcfg, tp, emb))):
        cache = E.init_cache(tcfg, 2, S, device=CPU)
        outs.append(E.prefill_into_cache(tcfg, tp, cache, prompt, 1, 10,
                                         **kw))
    (l1, c1), (l2, c2) = outs
    assert torch.equal(l1, l2)
    assert all(torch.equal(c1[k], c2[k]) for k in c1)


# ------------------------------------------- the cross read: n_chunks = 1

@pytest.mark.parametrize("protocol", ["bs", "rp", "axle"])
def test_cross_attention_n_chunks_1_matches_reference(protocol):
    """`decode_attention_combined(..., n_chunks=1)` over a dense cross
    cache, rows of 32 and 20 valid frames, under chunks_per_shard 4
    (which n_chunks overrides), against the reference's, f32."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 1, 4, 16), (2, 4, 32, 16), (2, 4, 32, 16)))
    pos = np.array([31, 19], np.int32)
    proto = bs.OffloadProtocol(protocol)
    with jbs.use_offload(jbs.OffloadConfig(
            protocol=jbs.OffloadProtocol(protocol), chunks_per_shard=4)):
        want = jbs.decode_attention_combined(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pos), n_chunks=1)
    with bs.use_offload(bs.OffloadConfig(protocol=proto,
                                         chunks_per_shard=4)):
        got = bs.decode_attention_combined(
            *(torch.from_numpy(a) for a in (q, k, v, pos)), n_chunks=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_cross_decode_split_rule_scaled_down():
    """The dense cross read's split at hd 64: 1500 frames take chunks of
    125 and one split a chunk (12 a row); 150 take chunks of 75 and one
    split a chunk (2).  At S = 150 (MHA, hd 64, the last valid frame e - 1
    for e in {1, 60, 149, 150}) the port's plain fused decode and partial,
    which the card holds the kernels to, against the Pallas kernels in
    interpret mode."""
    assert fa.dense_chunk(1500, 128) == 125
    assert fa.decode_split_rows(125, 64) == 125
    assert fa.decode_split(1500, 125, 64) == (125, 12)
    assert fa.dense_chunk(150, 128) == 75
    assert fa.decode_split(150, 75, 64) == (75, 2)
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((4, 1, 2, 64), (4, 2, 150, 64), (4, 2, 150, 64)))
    pos = np.array([0, 59, 148, 149], np.int32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = jfa.decode_attention_fused(jq, jk, jv, jnp.asarray(pos),
                                      blk_c=128, interpret=True)
    got = ops.decode_attention_fused(tq, tk, tv, torch.from_numpy(pos),
                                     blk_c=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    valid = np.arange(150)[None] <= pos[:, None]
    wacc, wm, wl = jfa.decode_attention_partial(jq, jk, jv,
                                                jnp.asarray(valid),
                                                blk_c=75, interpret=True)
    gacc, gm, gl = ops.decode_attention_partial(tq, tk, tv,
                                                torch.from_numpy(valid))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gacc.numpy(), np.asarray(wacc), atol=1e-4,
                               rtol=1e-5)


# ------------------------------------------------------------- the servers

def _requests(cfg, n=4, seed=0):
    """Prompts of 4-11 tokens and clips of 12-32 frames (two full)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = cfg.enc_len if i % 2 == 0 else int(rng.integers(12, cfg.enc_len))
        emb = rng.standard_normal((e, cfg.d_model)).astype(np.float32)
        prompt = rng.integers(1, cfg.vocab, int(rng.integers(4, 12))).astype(
            np.int32)
        out.append((i, prompt, emb))
    return out


@pytest.fixture
def f32(monkeypatch):
    """Both servers' smoke configs in f32 arithmetic."""
    for mod in (jserve, tserve):
        orig = mod.get_smoke_config
        monkeypatch.setattr(mod, "get_smoke_config", lambda a, _o=orig:
                            dataclasses.replace(_o(a), dtype="float32"))


def _port_server(params, **kw):
    kw = dict(dict(batch_slots=SLOTS, max_seq=S, protocol="bs",
                   stream=True, seg_len=SEG_LEN), **kw)
    return tserve.BatchedServer(ARCH, smoke=True, device="cpu",
                                params=params, **kw)


def _drain(srv, reqs, cls):
    for rid, prompt, emb in reqs:
        srv.submit(cls(rid, prompt, MAX_NEW, embeds=emb))
    srv.run_until_drained()
    return {r.rid: list(r.generated) for r in srv.completed}


def _servers(**kw):
    """The JAX streamed server and the port's on its weights, drained on
    the same requests; returns (port server, port tokens, JAX server, JAX
    tokens, requests)."""
    jsrv = jserve.BatchedServer(ARCH, smoke=True, batch_slots=SLOTS,
                                max_seq=S, protocol="bs", stream=True,
                                seg_len=SEG_LEN, **kw)
    reqs = _requests(jsrv.cfg)
    want = _drain(jsrv, reqs, jserve.Request)
    tsrv = _port_server(interop.params_from_jax(_tree_np(jsrv.params), CPU),
                        **kw)
    got = _drain(tsrv, reqs, tserve.Request)
    assert tsrv.pages_allocated == tsrv.pages_freed
    assert all(len(t) == MAX_NEW for t in got.values())
    return tsrv, got, jsrv, want, reqs


def test_stream_server_matches_jax_f32(f32):
    tsrv, got, jsrv, want, _ = _servers()
    assert tsrv.cfg.dtype == "float32"
    assert got == want
    assert tsrv.encoder_passes == jsrv.encoder_passes == 4


def test_stream_server_tokens_bf16_near_tie_gate():
    tsrv, got, _, want, reqs = _servers()
    frames = {rid: emb for rid, _, emb in reqs}
    prompts = {rid: p for rid, p, _ in reqs}
    for rid, a in got.items():
        b = want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[rid], np.asarray(a[:t], np.int32)])
        cache = E.init_cache(tsrv.cfg, 1, S, device=CPU)
        lg, _ = E.prefill_into_cache(tsrv.cfg, tsrv.params, cache,
                                     torch.from_numpy(seq), 0, len(seq),
                                     torch.from_numpy(frames[rid])[None])
        gap = (lg[a[t]] - lg[b[t]]).abs().item()
        assert gap < NEAR_TIE, (rid, t, gap)


def test_spec_server_matches_jax_f32(f32):
    """The self:1 spec servers: tokens and accept counts equal; one
    encoder pass an admission in both, the draft's prefill sharing it."""
    tsrv, got, jsrv, want, _ = _servers(spec=True, spec_k=2,
                                        draft_arch="self:1")
    assert got == want
    assert (tsrv.draft_accepted, tsrv.draft_proposed) == \
        (jsrv.draft_accepted, jsrv.draft_proposed)
    assert tsrv.draft_shares_encoder and jsrv.draft_shares_encoder
    assert tsrv.encoder_passes == jsrv.encoder_passes == 4
    assert set(tsrv.draft_params) == set(tsrv.params)
    assert tsrv.draft_params["enc_blocks"] is tsrv.params["enc_blocks"]
    assert tsrv.draft_params["cross"]["wq"].shape[0] == 1


def test_foreign_encdec_draft_encodes_again():
    """A draft of its own weights (another whisper, drawn from seed 1)
    shares no encoder: each admission runs two encoder passes, the
    draft's prefill taking the frames."""
    _, tcfg, _, tp = _setup("bfloat16")
    srv = _port_server(tp, spec=True, spec_k=2, draft_arch=ARCH)
    got = _drain(srv, _requests(tcfg, n=2, seed=3), tserve.Request)
    assert not srv.draft_shares_encoder
    assert srv.encoder_passes == 2 * srv.prefill_forwards == 4
    assert srv.draft_params["enc_blocks"] is not tp["enc_blocks"]
    assert all(len(t) == MAX_NEW for t in got.values())


def test_port_streamed_per_token_and_alone_bitwise():
    """Inside the port, bf16: per-token == streamed, and each short clip
    served alone == its row in the batch beside full clips."""
    _, tcfg, _, tp = _setup("bfloat16")
    reqs = _requests(tcfg, seed=7)
    streamed = _drain(_port_server(tp), reqs, tserve.Request)
    assert _drain(_port_server(tp, stream=False), reqs,
                  tserve.Request) == streamed
    for rid, prompt, emb in reqs:
        if len(emb) < tcfg.enc_len:
            alone = _drain(_port_server(tp), [(rid, prompt, emb)],
                           tserve.Request)
            assert alone[rid] == streamed[rid], rid


def test_launch_site_counts_only_inside_it():
    """A decode launch counted inside `launch_site("cross")` counts at the
    site too; outside it, and after it, only under its own name."""
    name = "decode_attention_fused"
    before = dict(kbuild.LAUNCHES)
    kbuild.count_site(name)
    with kbuild.launch_site("cross"):
        kbuild.count_site(name)
        kbuild.count_site("decode_attention_partial")
    kbuild.count_site(name)
    got = {k: n - before[k] for k, n in kbuild.LAUNCHES.items()
           if n != before[k]}
    kbuild.LAUNCHES.update(before)
    assert got == {name + "@cross": 1, "decode_attention_partial@cross": 1}
    assert set(got) <= set(kbuild.VARIANTS)
    with pytest.raises(ValueError, match="no call site"):
        with kbuild.launch_site("self"):
            pass


@pytest.mark.parametrize("shape", [(0, 64), (33, 64), (16, 32), (64,)],
                         ids=["empty", "past_enc_len", "wrong_width", "1d"])
def test_submit_rejects_a_clip_of_the_wrong_shape(shape):
    """A clip the cross cache cannot hold is refused at submission, as
    a ValueError (not an assert that `python -O` drops), and nothing is
    queued."""
    srv = _port_server(None)
    emb = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="embeds of shape"):
        srv.submit(tserve.Request(0, np.arange(1, 5, dtype=np.int32),
                                  MAX_NEW, embeds=emb))
    assert not srv.queue


def test_serve_cli_runs(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--device", "cpu", "--requests", "3",
        "--slots", "2", "--max-seq", "64", "--max-new", "6", "--stream",
        "--spec"])
    assert tserve.main() == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert f"arch={ARCH}_smoke" in line and "tokens=18" in line, line


def test_make_prefill_takes_frames_or_the_encoder_output():
    """The steps' prefill: frames (encoded inside) or their encoder
    output, the same bits."""
    _, tcfg, _, tp = _setup("bfloat16")
    rng = np.random.default_rng(9)
    prompt = torch.from_numpy(rng.integers(1, 512, 8).astype(np.int32))
    emb = torch.from_numpy(_frames(rng, 32))
    outs = []
    for enc, arg in ((False, emb), (True, E.encode(tcfg, tp, emb))):
        cache = E.init_cache(tcfg, 1, S, device=CPU)
        fn = steps.make_prefill_into_cache(tcfg, from_enc_out=enc)
        outs.append(fn(tp, cache, prompt, 0, 6, arg)[0])
    assert torch.equal(*outs)
