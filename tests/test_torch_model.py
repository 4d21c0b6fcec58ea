"""Parity of the port's model modules (`repro_torch.models`) with the JAX
package at smoke size (starcoder2_3b SMOKE: 2 layers, d 64, H 4, KH 1,
hd 16), with the JAX weights crossed over through `repro_torch.interop`.

float32 runs (`dtype="float32"` in both packages): atol = 1e-4 — the two
frameworks order their f32 sums differently, through two layers.  One
bfloat16 run: greedy tokens agree except at a near tie (the two best
logits within 0.1, the gate of tests/test_quant.py)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro.models import transformer as JT                    # noqa: E402
from repro_torch import interop                               # noqa: E402
from repro_torch.configs import get_smoke_config              # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402
from repro_torch.models import transformer as T               # noqa: E402

ARCH = "starcoder2_3b"
ATOL = 1e-4
NEAR_TIE = 0.1
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _setup(dtype):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------------------ layers

def test_rms_norm_parity():
    rng = np.random.default_rng(0)
    x, s = rng.standard_normal((2, 5, 64)), rng.standard_normal(64) * 0.1
    np.testing.assert_allclose(
        _np(L.rms_norm(_t(x), _t(s))),
        _np(JL.rms_norm(jnp.asarray(x, jnp.float32),
                        jnp.asarray(s, jnp.float32))), atol=ATOL)


def test_apply_rope_parity():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16))
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(L.apply_rope(_t(x), torch.from_numpy(pos), 10_000.0)),
        _np(JL.apply_rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos),
                          10_000.0)), atol=ATOL)


def test_single_kv_partial_and_merge_parity():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 1, 4, 16))
    kn, vn = rng.standard_normal((2, 1, 1, 16)), rng.standard_normal(
        (2, 1, 1, 16))
    got = L.single_kv_partial(_t(q), _t(kn), _t(vn))
    want = JL.single_kv_partial(*(jnp.asarray(a, jnp.float32)
                                  for a in (q, kn, vn)))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL)
    accs = rng.standard_normal((3, 2, 4, 16))
    ms = rng.standard_normal((3, 2, 4))
    ms[1, 0] = -np.inf                       # an empty partial
    ls = rng.random((3, 2, 4)) + 0.5
    np.testing.assert_allclose(
        _np(L.merge_attention_partials(_t(accs), _t(ms), _t(ls))),
        _np(JL.merge_attention_partials(*(jnp.asarray(a, jnp.float32)
                                          for a in (accs, ms, ls)))),
        atol=ATOL)


def test_gated_mlp_parity():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64))
    ws = [rng.standard_normal(s) * 0.1 for s in ((64, 128), (64, 128),
                                                (128, 64))]
    np.testing.assert_allclose(
        _np(L.gated_mlp(_t(x), *map(_t, ws))),
        _np(JL.gated_mlp(jnp.asarray(x, jnp.float32),
                         *(jnp.asarray(w, jnp.float32) for w in ws))),
        atol=ATOL)


# ------------------------------------------------------------ params, bridge

def test_init_params_matches_reference_layout():
    """The port's own draw has the reference's tree, shapes and dtypes."""
    jcfg = jax_smoke_config(ARCH)
    want = jax.eval_shape(functools.partial(JT.init_params, jcfg),
                          jax.random.key(0))
    got = T.init_params(get_smoke_config(ARCH),
                        torch.Generator().manual_seed(0), CPU)
    flat_w = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(p): l for p, l in
              jax.tree_util.tree_leaves_with_path(
                  jax.tree.map(lambda t: t, got))}
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == w.shape, k
        assert str(flat_g[k].dtype) == f"torch.{w.dtype}", k


def test_interop_crosses_bf16_bit_exact_and_names_buffers_by_path():
    jcfg, tcfg, jp, tp = _setup("bfloat16")
    w = np.asarray(jp["blocks"][0]["attn"]["wq"])
    assert w.dtype.name == "bfloat16"
    got = tp["blocks"][0]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  w.view(np.int16))
    model = T.Transformer(tcfg, tp)
    assert "blocks.0.attn.wq" in model.state_dict()
    assert "blocks.0.ffn.w_down" in model.state_dict()
    assert model.params["blocks"][0]["ffn"]["w_up"] is \
        tp["blocks"][0]["ffn"]["w_up"]


# --------------------------------------------------------------- transformer

S, PAGE = 64, 16
LENGTHS = (7, 11)
N_STEPS = 16


def _run_both(dtype):
    """Prefill two rows through a permuted page table, then N_STEPS
    teacher-forced decode steps (the JAX greedy token fed to both), with
    row 1 write-masked every fourth step.  Returns per-step
    (jax logits, port logits) and both final caches."""
    jcfg, tcfg, jp, tp = _setup(dtype)
    rng = np.random.default_rng(4)
    table = np.stack([rng.permutation(S // PAGE) for _ in LENGTHS]).astype(
        np.int32)
    jcache = JT.init_cache(jcfg, len(LENGTHS), S, page_size=PAGE)
    jcache["page_table"] = jnp.asarray(table)
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), CPU)
    jprefill = jax.jit(functools.partial(JT.prefill_into_cache, jcfg))
    jdecode = jax.jit(functools.partial(JT.decode_step, jcfg))
    out = []
    first = []
    for row, n in enumerate(LENGTHS):
        prompt = np.zeros(16, np.int32)
        prompt[:n] = rng.integers(1, jcfg.vocab, n)
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


@functools.lru_cache(maxsize=None)
def _f32_run():
    return _run_both("float32")


def test_prefill_into_cache_parity_f32():
    """Last-token prefill logits and the cache rows written through a
    permuted page table."""
    jcfg, tcfg, jp, tp = _setup("float32")
    jcache = JT.init_cache(jcfg, 2, S, page_size=PAGE)
    table = np.array([[3, 1, 0, 2], [2, 0, 3, 1]], np.int32)
    jcache["page_table"] = jnp.asarray(table)
    tcache = T.init_cache(tcfg, 2, S, device=CPU, page_size=PAGE)
    tcache["page_table"] = torch.from_numpy(table)
    prompt = np.zeros(32, np.int32)
    prompt[:21] = np.random.default_rng(5).integers(1, jcfg.vocab, 21)
    jl, jcache = jax.jit(functools.partial(JT.prefill_into_cache, jcfg))(
        jp, jcache, jnp.asarray(prompt), 1, 21)
    tl, tcache = T.prefill_into_cache(tcfg, tp, tcache,
                                      torch.from_numpy(prompt), 1, 21)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL)
    for key in ("k0", "v0"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=ATOL)
    assert not tcache["k0"][:, 0].any()        # row 0 untouched


def test_decode_step_parity_f32():
    """16 greedy decode steps: logits per step, and the caches after,
    write-masked steps included."""
    out, jcache, tcache = _f32_run()
    assert len(out) == len(LENGTHS) + N_STEPS
    for i, (jl, tl) in enumerate(out):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL,
                                   err_msg=f"step {i}")
    for key in ("k0", "v0"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   atol=ATOL)


def test_decode_step_tokens_bf16_near_tie_gate():
    out, _, _ = _run_both("bfloat16")
    flips = 0
    for i, (jl, tl) in enumerate(out):
        jn, tn = _np(jl).reshape(-1, jl.shape[-1]), _np(tl).reshape(
            -1, tl.shape[-1])
        assert np.isfinite(tn).all()
        for r in range(jn.shape[0]):
            a, b = int(jn[r].argmax()), int(tn[r].argmax())
            if a != b:
                flips += 1
                gap = float(jn[r, a] - jn[r, b])
                assert 0.0 <= gap < NEAR_TIE, (i, r, gap)
    assert flips <= 2, flips


def test_transformer_module_runs_the_same_functions():
    jcfg, tcfg, jp, tp = _setup("float32")
    model = T.Transformer(tcfg, tp)
    c1 = T.init_cache(tcfg, 2, S, device=CPU)
    c2 = T.init_cache(tcfg, 2, S, device=CPU)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    l1, c1 = model.decode_step(c1, toks, pos)
    l2, c2 = T.decode_step(tcfg, tp, c2, toks, positions=pos)
    assert torch.equal(l1, l2) and torch.equal(c1["k0"], c2["k0"])
