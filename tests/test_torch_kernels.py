"""Parity of the port's attention kernels module (`repro_torch.kernels`)
with the JAX package: the plain versions and the CPU dispatch of `ops`
against the Pallas kernels in interpret mode and against `repro.kernels.ref`,
on the same inputs drawn with numpy.  The CUDA kernels themselves run only
on a GPU: tests/test_torch_cuda.py holds them to these plain versions.

Tolerances: float32 inputs, atol = rtol = 1e-5 (both sides compute in f32
and differ only in summation order over at most 64 terms); bfloat16
inputs, atol = 2e-2 (both round an f32 result to bf16, which is one unit
in the last place, 0.0156, for outputs below 4)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import flash_attention as jfa              # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro_torch.kernels import flash_attention as fa         # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402

# jitted oracles: one compile per case instead of one per primitive
_mha = jax.jit(jref.mha_reference, static_argnames=("causal", "window"))
_fused = jax.jit(jref.decode_fused_reference,
                 static_argnames=("window", "page_size"))
_partial = jax.jit(jref.decode_partial_reference)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=0.0)}


def _pair(arr, dtype):
    """The same numbers as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(arr, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(
        getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# ------------------------------------------------------------ flash attention

# Every case is held to the JAX oracle; the cases marked `interpret` also
# to the Pallas kernel run in interpret mode (each such run compiles its
# own grid on the CPU, a few seconds apiece).

@pytest.mark.parametrize("dtype,group,window,interpret", [
    ("float32", 1, 0, False), ("float32", 4, 8, True),
    ("float32", 12, 0, False), ("bfloat16", 12, 5, True),
])
def test_flash_attention_parity(dtype, group, window, interpret):
    rng = np.random.default_rng(group * 10 + window)
    kh, s, hd = 1, 16, 16
    h = kh * group
    q, tq = _pair(rng.standard_normal((1, s, h, hd)), dtype)
    k, tk = _pair(rng.standard_normal((1, s, kh, hd)), dtype)
    v, tv = _pair(rng.standard_normal((1, s, kh, hd)), dtype)
    oracle = _mha(q, k, v, causal=True, window=window)
    port = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, oracle, dtype)
    if interpret:
        _close(port, jfa.flash_attention(q, k, v, causal=True, window=window,
                                         interpret=True), dtype)


# gemma3_12b's head dim (256, 2 query heads per KV head, its sliding
# window) and opt_2_7b's (80, MHA): on the card both run the tensor-core
# kernels in bf16 and the CUDA-core ones in f32; here both are the plain
# version, held to the oracle and, where marked, to the Pallas kernel.

@pytest.mark.parametrize("dtype,hd,group,window,interpret", [
    ("float32", 256, 2, 20, True), ("bfloat16", 256, 2, 20, False),
    ("float32", 80, 1, 20, True), ("bfloat16", 80, 1, 0, False),
])
def test_flash_attention_head_dim_parity(dtype, hd, group, window,
                                         interpret):
    rng = np.random.default_rng(hd + window)
    kh, s = 2, 48
    h = kh * group
    q, tq = _pair(rng.standard_normal((1, s, h, hd)), dtype)
    k, tk = _pair(rng.standard_normal((1, s, kh, hd)), dtype)
    v, tv = _pair(rng.standard_normal((1, s, kh, hd)), dtype)
    port = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(port, _mha(q, k, v, causal=True, window=window), dtype)
    if interpret:
        _close(port, jfa.flash_attention(q, k, v, causal=True, window=window,
                                         interpret=True), dtype)


# --------------------------------------------------------- fused flash decode

B, KH, S, HD, PAGE = 2, 2, 48, 16, 16
POS = np.array([0, 37], np.int32)         # row 0 sees only slot 0


def _decode_inputs(rng, group, dtype, extra, table, hd=HD):
    h = KH * group
    q, tq = _pair(rng.standard_normal((B, 1, h, hd)), dtype)
    k, tk = _pair(rng.standard_normal((B, KH, S, hd)), dtype)
    v, tv = _pair(rng.standard_normal((B, KH, S, hd)), dtype)
    jx = tx = None
    if extra:
        parts = (rng.standard_normal((B, h, hd)), rng.standard_normal((B, h)),
                 rng.random((B, h)) + 0.5)
        jx = tuple(jnp.asarray(p, jnp.float32) for p in parts)
        tx = tuple(torch.from_numpy(np.asarray(p, np.float32)) for p in parts)
    n = S // PAGE
    pages = (np.tile(np.arange(n, dtype=np.int32), (B, 1))
             if table == "identity" else
             np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32))
    return (q, k, v, jx, jnp.asarray(pages)), \
        (tq, tk, tv, tx, torch.from_numpy(pages))


@pytest.mark.parametrize("dtype,group,window,extra,table,interpret", [
    ("float32", 1, 0, False, "identity", False),
    ("float32", 4, 5, True, "permuted", True),
    ("float32", 12, 0, True, "permuted", False),
    ("float32", 4, 0, False, "permuted", False),
    ("float32", 1, 5, True, "identity", True),
    ("float32", 12, 5, False, "identity", False),
    ("bfloat16", 4, 0, True, "permuted", False),
    ("bfloat16", 12, 5, True, "identity", True),
])
def test_decode_fused_parity(dtype, group, window, extra, table, interpret):
    rng = np.random.default_rng(group + 100 * window)
    (q, k, v, jx, jp), (tq, tk, tv, tx, tp) = _decode_inputs(
        rng, group, dtype, extra, table)
    jpos, tpos = jnp.asarray(POS), torch.from_numpy(POS)
    oracle = _fused(q, k, v, jpos, jx, window=window, pages=jp,
                    page_size=PAGE)
    port = ops.decode_attention_fused(tq, tk, tv, tpos, tx, tp,
                                      window=window, blk_c=PAGE)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, oracle, dtype)
    if interpret:
        _close(port, jfa.decode_attention_fused(
            q, k, v, jpos, jx, window=window, blk_c=PAGE, pages=jp,
            interpret=True), dtype)
    # and unpaged, against the dense oracle
    dense = _fused(q, k, v, jpos, jx, window=window)
    _close(ops.decode_attention_fused(tq, tk, tv, tpos, tx, window=window,
                                      blk_c=PAGE), dense, dtype)


@pytest.mark.parametrize("dtype,hd,group,window,interpret", [
    ("float32", 256, 2, 31, True), ("bfloat16", 256, 2, 31, False),
    ("float32", 80, 1, 31, True), ("bfloat16", 80, 1, 0, False),
])
def test_decode_fused_head_dim_parity(dtype, hd, group, window, interpret):
    """gemma3_12b's and opt_2_7b's head dims, paged through a permuted
    table with the current token's extra partial; row 1 (pos 37) sees a
    window of 31 slots, as a local layer of window 32 reads its cache."""
    rng = np.random.default_rng(hd + window)
    (q, k, v, jx, jp), (tq, tk, tv, tx, tp) = _decode_inputs(
        rng, group, dtype, True, "permuted", hd=hd)
    jpos, tpos = jnp.asarray(POS), torch.from_numpy(POS)
    port = ops.decode_attention_fused(tq, tk, tv, tpos, tx, tp,
                                      window=window, blk_c=PAGE)
    _close(port, _fused(q, k, v, jpos, jx, window=window, pages=jp,
                        page_size=PAGE), dtype)
    if interpret:
        _close(port, jfa.decode_attention_fused(
            q, k, v, jpos, jx, window=window, blk_c=PAGE, pages=jp,
            interpret=True), dtype)


def test_fused_partial_reference_parity():
    """The raw merged statistics before normalisation, extra included."""
    rng = np.random.default_rng(7)
    (q, k, v, jx, jp), (tq, tk, tv, tx, tp) = _decode_inputs(
        rng, 4, "float32", True, "permuted")
    want = jax.jit(jref.decode_fused_partial_reference,
                   static_argnames=("window", "page_size"))(
        q, k, v, jnp.asarray(POS), jx, window=3, pages=jp, page_size=PAGE)
    got = ref.decode_fused_partial_reference(
        tq, tk, tv, torch.from_numpy(POS), tx, window=3, pages=tp,
        page_size=PAGE)
    for g, w in zip(got, want):
        _close(g, w, "float32")


def test_paged_equals_dense_bitwise():
    """Inside the port: a shuffled page table over a pool holding the
    same logical data gives the dense result bit for bit."""
    rng = np.random.default_rng(3)
    _, (tq, tk, tv, tx, tp) = _decode_inputs(rng, 4, "bfloat16", True,
                                             "permuted")
    pool_k, pool_v = torch.empty_like(tk), torch.empty_like(tv)
    for b in range(B):
        for j in range(S // PAGE):
            p = int(tp[b, j])
            pool_k[b, :, p * PAGE:(p + 1) * PAGE] = \
                tk[b, :, j * PAGE:(j + 1) * PAGE]
            pool_v[b, :, p * PAGE:(p + 1) * PAGE] = \
                tv[b, :, j * PAGE:(j + 1) * PAGE]
    pos = torch.from_numpy(POS)
    for window in (0, 5):
        dense = ops.decode_attention_fused(tq, tk, tv, pos, tx,
                                           window=window, blk_c=PAGE)
        paged = ops.decode_attention_fused(tq, pool_k, pool_v, pos, tx, tp,
                                           window=window, blk_c=PAGE)
        assert torch.equal(dense, paged)


# ------------------------------------------------------ partial decode stats

def _check_partial(dtype, group, interpret, seed, hd=HD, c=32):
    """The port's plain partial against the oracle and, if `interpret`,
    the Pallas kernel (chunks of 16 slots): random masks, row 1 fully
    masked, row 0's first three slots valid."""
    rng = np.random.default_rng(seed)
    h = KH * group
    q, tq = _pair(rng.standard_normal((B, 1, h, hd)), dtype)
    k, tk = _pair(rng.standard_normal((B, KH, c, hd)), dtype)
    v, tv = _pair(rng.standard_normal((B, KH, c, hd)), dtype)
    valid = rng.random((B, c)) < 0.6
    valid[1] = False                       # a fully masked row
    valid[0, :3] = True
    jv, tvalid = jnp.asarray(valid), torch.from_numpy(valid)
    wants = [_partial(q, k, v, jv)]
    if interpret:
        wants.append(jfa.decode_attention_partial(q, k, v, jv, blk_c=16,
                                                  interpret=True))
    port = ops.decode_attention_partial(tq, tk, tv, tvalid)
    # statistics are f32 on every side; bf16 inputs are exact in f32
    for want in wants:
        acc, m, l = (np.asarray(x) for x in want)
        pacc, pm, pl = (x.numpy() for x in port)
        np.testing.assert_array_equal(np.isneginf(pm), np.isneginf(m))
        fin = np.isfinite(m)
        np.testing.assert_allclose(pm[fin], m[fin], **TOL["float32"])
        np.testing.assert_allclose(pl, l, **TOL["float32"])
        np.testing.assert_allclose(pacc, acc, atol=1e-4, rtol=1e-5)
    assert np.isneginf(port[1][1].numpy()).all()
    assert (port[2][1].numpy() == 0).all()


@pytest.mark.parametrize("dtype,group,interpret", [
    ("float32", 1, False), ("float32", 4, True), ("float32", 12, False),
    ("bfloat16", 12, True)])
def test_decode_partial_parity(dtype, group, interpret):
    _check_partial(dtype, group, interpret, 50 + group)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_partial_head_dim_parity(dtype):
    """opt_2_7b's head dim 80, MHA, over 48 slots (3 chunks of 16),
    against the oracle and the Pallas kernel in interpret mode; on the
    card bf16 runs the tensor-core split and f32 the CUDA-core one, both
    held to this plain version."""
    _check_partial(dtype, 1, True, 80, hd=80, c=48)


@pytest.mark.parametrize("dtype,window,paged", [
    ("float32", 31, True), ("float32", 0, False), ("bfloat16", 31, True)])
def test_decode_fused_int8_head_dim_parity(dtype, window, paged):
    """opt_2_7b's head dim 80 (MHA) over int8 pools with one f32 scale
    per (row, KV head, page), the current token's extra merged: the
    port's plain fused decode against the Pallas kernel's has_scales
    branch in interpret mode and the oracle, dense and paged through a
    permuted table (the pools then physical, each page with its scale).
    f32 q within 1e-5, bf16 q within one bf16 unit (2e-2)."""
    rng = np.random.default_rng(80 + window)
    hd, h = 80, KH
    q, tq = _pair(rng.standard_normal((B, 1, h, hd)), dtype)
    (k8, ks), (v8, vs) = (jref.quantize_kv_pages(jnp.asarray(
        rng.standard_normal((B, KH, S, hd)), jnp.float32), PAGE)
        for _ in range(2))
    parts = (rng.standard_normal((B, h, hd)), rng.standard_normal((B, h)),
             rng.random((B, h)) + 0.5)
    jx = tuple(jnp.asarray(x, jnp.float32) for x in parts)
    tx = tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in parts)
    table = np.stack([rng.permutation(S // PAGE)
                      for _ in range(B)]).astype(np.int32)
    jp, tp = (jnp.asarray(table), torch.from_numpy(table)) if paged \
        else (None, None)
    jpos, tpos = jnp.asarray(POS), torch.from_numpy(POS)
    t8 = [torch.from_numpy(np.array(x)) for x in (k8, v8, ks, vs)]
    port = ops.decode_attention_fused(tq, t8[0], t8[1], tpos, tx, tp,
                                      (t8[2], t8[3]), window=window,
                                      blk_c=PAGE)
    assert port.dtype == tq.dtype and port.shape == tq.shape
    _close(port, jfa.decode_attention_fused(
        q, k8, v8, jpos, jx, window=window, blk_c=PAGE, pages=jp,
        kv_scales=(ks, vs), interpret=True), dtype)
    _close(port, _fused(q, k8, v8, jpos, jx, window=window, pages=jp,
                        page_size=PAGE if paged else 0,
                        kv_scales=(ks, vs)), dtype)


def test_merge_fused_partial_pair_guards_empty_partials():
    """A partial with m = -inf (an empty row) contributes nothing, on both
    sides, and two empty partials stay empty."""
    rng = np.random.default_rng(11)
    acc = rng.standard_normal((2, 3, 4)).astype(np.float32)
    m = np.array([[-np.inf, 0.5, 1.0], [-np.inf, -np.inf, 2.0]], np.float32)
    l = np.where(np.isfinite(m), 1.5, 0.0).astype(np.float32)
    acc_e = rng.standard_normal((2, 3, 4)).astype(np.float32)
    m_e = np.array([[0.1, -np.inf, 3.0], [-np.inf, 0.0, 1.0]], np.float32)
    l_e = np.where(np.isfinite(m_e), 2.0, 0.0).astype(np.float32)
    args = (acc, m, l, acc_e, m_e, l_e)
    want = jref.merge_fused_partial_pair(*(jnp.asarray(a) for a in args))
    got = ref.merge_fused_partial_pair(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    out = ref.normalize_fused_partial(got[0], got[2], torch.float32)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.normalize_fused_partial(
            want[0], want[2], jnp.float32)), atol=1e-6)


def test_gather_kv_pages_parity():
    rng = np.random.default_rng(5)
    kv = rng.standard_normal((2, 2, 32, 4)).astype(np.float32)
    pages = np.stack([rng.permutation(4) for _ in range(2)]).astype(np.int32)
    want = jref.gather_kv_pages(jnp.asarray(kv), jnp.asarray(pages), 8)
    got = ref.gather_kv_pages(torch.from_numpy(kv), torch.from_numpy(pages),
                              8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ the CUDA side

@pytest.mark.parametrize("kernel", ["decode_attention_fused",
                                    "flash_attention",
                                    "decode_attention_partial"])
def test_cuda_wrapper_refuses_cpu_tensors(kernel):
    """A CUDA wrapper raises on a CPU tensor rather than quietly running
    the plain version (ops.py is where CPU tensors turn off)."""
    q = torch.zeros((1, 1, 2, 16))
    k = torch.zeros((1, 1, 16, 16))
    args = {"decode_attention_fused": (q, k, k, torch.zeros(1, dtype=torch.int32)),
            "flash_attention": (torch.zeros((1, 8, 2, 16)),
                                torch.zeros((1, 8, 1, 16)),
                                torch.zeros((1, 8, 1, 16))),
            "decode_attention_partial": (q, k, k,
                                         torch.ones((1, 16), dtype=torch.bool))}
    launches = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fa, kernel)(*args[kernel])
    assert fa.LAUNCHES == launches
