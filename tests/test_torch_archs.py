"""Parity of the port's other dense attention archs with the JAX package at
smoke size: gemma3_12b (five sliding-window "local" layers to one "full"
layer, window 32 at smoke size), mistral_nemo_12b (GQA, H hd != d_model),
opt_2_7b (MHA), minitron_4b and qwen2_vl_2b (M-RoPE).  The port runs the
JAX package's own weights, crossed over through `repro_torch.interop`.

Every prompt here is 30-40 tokens and every run decodes past position 32,
so gemma3's window masks in the prefill and moves in the decode.

Tolerances: float32 (`dtype="float32"` in both packages) logits within
atol = 1e-4 and equal greedy tokens, as tests/test_torch_model.py holds
starcoder2_3b; bfloat16 greedy tokens equal except where a stream parts
at a near tie (the two choices' logits within 0.1 in the port's prefill of
the common prefix, the gate of tests/test_quant.py)."""
import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_config as jax_config            # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jserve                      # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro.models import transformer as JT                    # noqa: E402
from repro_torch import configs, interop                      # noqa: E402
from repro_torch.examples import serve_offload                # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402
from repro_torch.models import transformer as T               # noqa: E402

ARCHS = ("gemma3_12b", "mistral_nemo_12b", "opt_2_7b", "minitron_4b",
         "qwen2_vl_2b")
ATOL = 1e-4
NEAR_TIE = 0.1
CPU = torch.device("cpu")
S, PAGE = 64, 16
LENGTHS = (30, 37)                 # either side of gemma3's smoke window
N_STEPS = 8
SLOTS, SEG_LEN, N_REQ, MAX_NEW = 2, 8, 4, 16
ROOT = Path(__file__).resolve().parents[1]


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


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS + ("whisper_large_v3",))
def test_config_is_the_reference_config(arch):
    assert dataclasses.asdict(configs.get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(configs.get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("change,item", [
    # an enc-dec config belongs to models/encdec.py (the case keeps the id
    # it had while enc-dec waited for ROADMAP item 13)
    pytest.param(dict(enc_dec=True), "models/encdec.py",
                 id="change0-item 13"),
    (dict(block_pattern=("none",)), "item"),
])
def test_unported_layer_kinds_still_raise(change, item):
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3_12b"),
                              n_layers=6, **change)
    with pytest.raises(NotImplementedError, match=item):
        T.init_cache(cfg, 1, S, device=CPU)


def test_moe_layers_now_build():
    """MoE FFNs are ported (tests/test_torch_moe.py holds them to the
    reference): gemma3's pattern with experts builds its cache and its
    expert stacks, and decodes a step."""
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3_12b"),
                              n_layers=6, n_experts=4, top_k=2, moe_every=2)
    cache = T.init_cache(cfg, 1, S, device=CPU)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    ffn = [b["ffn"] for b in params["blocks"]]
    assert [("router" in f) for f in ffn] == [True, False] * 3
    assert ffn[0]["w_gate"].shape == (1, 4, cfg.d_model, cfg.d_ff)
    logits, _ = T.decode_step(cfg, params, cache,
                              torch.ones((1, 1), dtype=torch.int32))
    assert logits.shape == (1, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


# ------------------------------------------------------------------ M-RoPE

def test_apply_mrope_parity():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16))
    pos3 = rng.integers(0, 4096, (2, 5, 3)).astype(np.int32)
    for sections in ((4, 2, 2), T._mrope_sections(16)):
        np.testing.assert_allclose(
            _np(L.apply_mrope(torch.from_numpy(x).float(),
                              torch.from_numpy(pos3), 1e6, sections)),
            _np(JL.apply_mrope(jnp.asarray(x, jnp.float32),
                               jnp.asarray(pos3), 1e6, sections)),
            atol=ATOL)
    assert T._mrope_sections(128) == (32, 16, 16)


def test_mrope_of_text_positions_is_rope():
    """Text tokens carry (i, i, i): M-RoPE then rotates as plain RoPE."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 9, 2, 16))).to(
        torch.bfloat16)
    pos3 = L.default_mrope_positions(1, 9)
    np.testing.assert_array_equal(
        pos3.numpy(), np.asarray(JL.default_mrope_positions(1, 9)))
    assert pos3.dtype == torch.int32 and pos3.shape == (1, 9, 3)
    got = L.apply_mrope(x, pos3, 1e6, T._mrope_sections(16))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, L.apply_rope(x, pos3[..., 0], 1e6))


# ------------------------------------------- the model functions, f32

def _prompt(rng, vocab, n):
    prompt = np.zeros(40, np.int32)
    prompt[:n] = rng.integers(1, vocab, n)
    return prompt


@functools.lru_cache(maxsize=None)
def _run_both(arch):
    """Prefill LENGTHS through a permuted page table, then N_STEPS
    teacher-forced decode steps (the JAX greedy token fed to both), row 1
    write-masked every fourth step, in f32.  Returns per-step (jax logits,
    port logits) and both final caches."""
    jcfg, tcfg, jp, tp = _setup(arch, "float32")
    rng = np.random.default_rng(4)
    table = np.stack([rng.permutation(S // PAGE) for _ in LENGTHS]).astype(
        np.int32)
    jcache = JT.init_cache(jcfg, len(LENGTHS), S, page_size=PAGE)
    jcache["page_table"] = jnp.asarray(table)
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), CPU)
    jprefill = jax.jit(functools.partial(JT.prefill_into_cache, jcfg))
    jdecode = jax.jit(functools.partial(JT.decode_step, jcfg))
    out, first = [], []
    for row, n in enumerate(LENGTHS):
        prompt = _prompt(rng, jcfg.vocab, n)
        jl, jcache = jprefill(jp, jcache, jnp.asarray(prompt), row, n)
        tl, tcache = T.prefill_into_cache(tcfg, tp, tcache,
                                          torch.from_numpy(prompt), row, n)
        out.append((jl, tl))
        first.append(int(jnp.argmax(jl)))
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
    return out, jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_parity_f32(arch):
    """Prefill logits, then each decode step's, and the K/V caches."""
    out, jcache, tcache = _run_both(arch)
    for i, (jl, tl) in enumerate(out):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL,
                                   err_msg=f"step {i}")
    for key in jcache:
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=ATOL, err_msg=key)


def test_gemma3_decode_verify_parity_f32():
    """The verify forward of 3 tokens per row from positions 31 and 36,
    across the window's edge: logits and the cache rows it writes."""
    arch = "gemma3_12b"
    jcfg, tcfg, jp, tp = _setup(arch, "float32")
    rng = np.random.default_rng(9)
    jcache = JT.init_cache(jcfg, 2, S, page_size=PAGE)
    lengths = (31, 36)
    for row, n in enumerate(lengths):
        prompt = _prompt(rng, jcfg.vocab, n)
        _, jcache = JT.prefill_into_cache(jcfg, jp, jcache,
                                          jnp.asarray(prompt), row, n)
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), CPU)
    toks = rng.integers(1, jcfg.vocab, (2, 3)).astype(np.int32)
    pos = np.asarray(lengths, np.int32)
    jl, jcache, _ = JT.decode_verify(jcfg, jp, jcache, jnp.asarray(toks),
                                     jnp.asarray(pos))
    tl, tcache, _ = T.decode_verify(tcfg, tp, tcache, torch.from_numpy(toks),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for key in jcache:
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=ATOL, err_msg=key)


def test_local_windows_change_the_logits():
    """The same weights with every layer "full": equal bits while every
    position lies inside the 32-token window, different logits once the
    window masks (a 37-token prompt's prefill, decode steps past 32)."""
    _, tcfg, _, tp = _setup("gemma3_12b", "float32")
    full = dataclasses.replace(tcfg, block_pattern=("full",) * 6)
    rng = np.random.default_rng(5)
    prompt = _prompt(rng, tcfg.vocab, 37)
    outs = {}
    for name, cfg in (("local", tcfg), ("full", full)):
        cache = T.init_cache(cfg, 2, S, device=CPU, page_size=PAGE)
        lg = []
        for row, n in enumerate((30, 37)):
            l0, cache = T.prefill_into_cache(cfg, tp, cache,
                                             torch.from_numpy(prompt), row, n)
            lg.append(l0)
        toks = torch.tensor([[5], [9]], dtype=torch.int32)
        pos = torch.tensor([30, 37], dtype=torch.int32)
        for _ in range(4):                 # row 0: positions 30..33
            l1, cache = T.decode_step(cfg, tp, cache, toks, positions=pos)
            lg.append(l1[:, -1])
            pos = pos + 1
        outs[name] = lg
    loc, ful = outs["local"], outs["full"]
    assert torch.equal(loc[0], ful[0])                     # prompt of 30
    assert (loc[1] - ful[1]).abs().max().item() > 1e-3     # prompt of 37
    for step in range(4):
        a, b = loc[2 + step], ful[2 + step]
        assert (a[1] - b[1]).abs().max().item() > 1e-3     # row 1: past 32
        # row 0 at positions 30, 31 sees 31, 32 tokens; at 32 and 33 its
        # window drops slot 0, then slot 1
        if step < 2:
            assert torch.equal(a[0], b[0]), step
        else:
            assert (a[0] - b[0]).abs().max().item() > 1e-3, step


# ------------------------------------------------------------- the servers

def _workload(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, int(rng.integers(30, 41))).astype(
        np.int32) for _ in range(N_REQ)]


@pytest.fixture
def f32(monkeypatch):
    """Both servers' smoke configs in f32 arithmetic."""
    for mod in (jserve, tserve):
        orig = mod.get_smoke_config
        monkeypatch.setattr(mod, "get_smoke_config", lambda a, _o=orig:
                            dataclasses.replace(_o(a), dtype="float32"))


def _servers(arch, **kw):
    """The JAX streamed server and the port's on its weights, drained on
    the same prompts; returns (port server, port tokens, JAX tokens)."""
    jsrv = jserve.BatchedServer(arch, smoke=True, batch_slots=SLOTS,
                                max_seq=S, protocol="bs", stream=True,
                                seg_len=SEG_LEN, **kw)
    prompts = _workload(jsrv.cfg.vocab)
    for i, pr in enumerate(prompts):
        jsrv.submit(jserve.Request(i, pr, MAX_NEW))
    jsrv.run_until_drained()
    tsrv = tserve.BatchedServer(
        arch, smoke=True, device="cpu", batch_slots=SLOTS, max_seq=S,
        protocol="bs", stream=True, seg_len=SEG_LEN,
        params=interop.params_from_jax(jax.tree.map(np.asarray, jsrv.params),
                                       CPU), **kw)
    for i, pr in enumerate(prompts):
        tsrv.submit(tserve.Request(i, pr, MAX_NEW))
    tsrv.run_until_drained()
    assert tsrv.pages_allocated == tsrv.pages_freed
    toks = {r.rid: list(r.generated) for r in tsrv.completed}
    assert all(len(t) == MAX_NEW for t in toks.values())
    return tsrv, toks, {r.rid: list(r.generated) for r in jsrv.completed}, \
        prompts


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_server_matches_jax_f32(arch, f32):
    tsrv, got, want, _ = _servers(arch)
    assert tsrv.cfg.dtype == "float32"
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_server_tokens_bf16_near_tie_gate(arch):
    tsrv, got, want, prompts = _servers(arch)
    assert got.keys() == want.keys()
    for rid, a in got.items():
        b = want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[rid], np.asarray(a[:t], np.int32)])
        cache = T.init_cache(tsrv.cfg, 1, S, device=CPU)
        lg, _ = T.prefill_into_cache(tsrv.cfg, tsrv.params, cache,
                                     torch.from_numpy(seq), 0, len(seq))
        gap = (lg[a[t]] - lg[b[t]]).abs().item()
        assert gap < NEAR_TIE, (rid, t, gap)


def test_gemma3_spec_server_matches_jax_f32(f32):
    """gemma3 has no draft of its own: with an explicit self:1 draft the
    spec server's tokens and accept counts are the JAX spec server's."""
    tsrv, got, want, _ = _servers("gemma3_12b", spec=True, spec_k=2,
                                  draft_arch="self:1")
    assert got == want
    assert tsrv.draft_proposed > 0


def test_gemma3_spec_needs_an_explicit_draft():
    with pytest.raises(AssertionError):
        tserve.BatchedServer("gemma3_12b", smoke=True, device="cpu",
                             spec=True)


# ------------------------------------------------------------ the CLI

@pytest.mark.parametrize("arch,flags", [
    ("gemma3_12b", ["--stream"]),
    ("gemma3_12b", []),                                  # per-token
    ("gemma3_12b", ["--stream", "--spec", "--draft", "self:1"]),
    ("mistral_nemo_12b", ["--stream", "--spec"]),        # its self:1
    ("opt_2_7b", ["--stream", "--spec"]),
    ("minitron_4b", ["--stream"]),
    ("qwen2_vl_2b", ["--stream"]),
    ("granite_moe_3b", ["--stream"]),
    ("jamba_1_5_large", ["--stream", "--spec", "--draft", "self:1"]),
])
def test_serve_cli_runs(arch, flags, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--device", "cpu", "--requests", "3",
        "--slots", "2", "--max-seq", "64", "--max-new", "6", *flags])
    assert tserve.main() == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert f"arch={arch}_smoke" in line and "tokens=18" in line, line


# ------------------------------------------------- the serve_offload example

def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_offload", ROOT / "examples" / "serve_offload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_offload_example_matches_the_reference_example(f32):
    """The port's `serve_with` on the JAX example's weights gives the JAX
    example's tokens under every protocol (bs == rp == axle), both in f32
    arithmetic (in bf16 two of the six streams part from the JAX ones)."""
    ref = _reference_example()
    want = ref.serve_with("bs")
    jsrv = jserve.BatchedServer(serve_offload.ARCH, smoke=True,
                                batch_slots=1, max_seq=16)
    params = interop.params_from_jax(jax.tree.map(np.asarray, jsrv.params),
                                     CPU)
    for protocol in serve_offload.PROTOCOLS:
        got, srv, _ = serve_offload.serve_with(protocol, device="cpu",
                                               params=params)
        assert got == want, protocol
        assert srv.cfg.dtype == "float32"
        assert srv.offload.chunks_per_shard == 4 and not srv.stream


def test_serve_offload_example_bf16_parts_only_at_near_ties():
    """In bf16 (the example's dtype) the port's protocol comparison on the
    JAX example's weights against the JAX example's tokens (its bs run;
    the JAX example holds bs == rp == axle): each stream equal, or parting
    where the two choices' logits lie within `serve_offload.NEAR_TIE` in
    the port's prefill of the common prefix (`serve_offload.partings`)."""
    want = _reference_example().serve_with("bs")
    jsrv = jserve.BatchedServer(serve_offload.ARCH, smoke=True,
                                batch_slots=1, max_seq=16)
    params = interop.params_from_jax(jax.tree.map(np.asarray, jsrv.params),
                                     CPU)
    outs = {}
    for protocol in serve_offload.PROTOCOLS:
        outs[protocol], srv, _ = serve_offload.serve_with(
            protocol, device="cpu", params=params)
        assert srv.cfg.dtype == "bfloat16"
        for rid, t, gap in serve_offload.partings(srv, outs[protocol], want):
            assert gap < serve_offload.NEAR_TIE, (protocol, rid, t, gap)
    assert outs["bs"] == outs["rp"] == outs["axle"]


def test_serve_offload_example_main_on_the_cpu():
    outs = serve_offload.main(["--device", "cpu"])
    assert outs["bs"] == outs["rp"] == outs["axle"]
    assert sum(len(t) for t in outs["bs"].values()) == 6 * 12


def test_serve_offload_partings_name_where_streams_part():
    """`partings` finds the first differing token of each stream and the
    logit distance of the two choices there; equal streams give none."""
    got, srv, _ = serve_offload.serve_with("bs", n_requests=2, max_new=6,
                                           device="cpu")
    assert serve_offload.partings(srv, got, got) == []
    other = dict(got)
    other[1] = got[1][:3] + ((got[1][3] + 1) % srv.cfg.vocab,) + got[1][4:]
    (rid, t, gap), = serve_offload.partings(srv, got, other)
    assert (rid, t) == (1, 3) and gap >= 0.0
