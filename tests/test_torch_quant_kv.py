"""Parity of the port's int8 KV cache with the JAX package: the page
quantizers, the decode write (`quant_kv_update_stacked`), the prefill
write (`quant_kv_write_rows`, start = 0), the cache layout, and the plain
fused decode over int8 pools against the Pallas kernel's `has_scales`
branch in interpret mode.  Inputs are drawn from a seed with numpy and
handed to both packages.

Tolerances: every quantizer and write is bitwise (the same f32 divisions
and products, rounding half to even).  The fused decode over int8 pools
in f32: atol = rtol = 1e-5 (both sides dequantize to the same f32 values
and differ only in summation order); paged == dense inside the port:
bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import flash_attention as jfa               # noqa: E402
from repro.kernels import ref as jref                          # noqa: E402
from repro.models import transformer as JT                     # noqa: E402
from repro_torch.configs import get_smoke_config               # noqa: E402
from repro_torch.kernels import ops, ref                       # noqa: E402
from repro_torch.models import transformer as T                # noqa: E402

CPU = torch.device("cpu")
L, B, KH, S, HD, PAGE = 2, 3, 2, 32, 16, 8
N_PAGES = S // PAGE


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_page_quantizers_bitwise_equal_jax(dtype):
    rng = np.random.default_rng(0)
    kv = jnp.asarray(_f32(rng, (B, KH, S, HD), 3.0), dtype)
    kv = kv.at[1, 0, :PAGE].set(0)                    # an all-zero page
    jq, js = jref.quantize_kv_pages(kv, PAGE)
    tq, ts = ref.quantize_kv_pages(
        torch.from_numpy(np.array(kv, np.float32)).to(getattr(torch, dtype)),
        PAGE)
    assert tq.dtype == torch.int8 and ts.shape == (B, KH, N_PAGES)
    _eq(tq, jq)
    _eq(ts, js)
    _eq(ref.dequantize_kv_pages(tq, ts), jref.dequantize_kv_pages(jq, js))


def _phys_slots(table, pos):
    return (table[np.arange(B), (pos % S) // PAGE] * PAGE
            + pos % PAGE).astype(np.int32)


def test_quant_kv_update_stacked_bitwise_equal_jax():
    """A run of 20 one-token writes per row from three per-row clocks
    through a permuted page table, into pools holding a previous
    occupant's junk: fresh pages (scale 0: the junk is cleared, ratio 0),
    pages whose old scale the token exceeds (re-quantized rows), tokens
    under the scale (ratio exactly 1), and a write mask freezing row 1 on
    some steps.  Pool and scales equal JAX's after every write (jitted,
    as the reference's decode step runs it)."""
    rng = np.random.default_rng(1)
    table = np.stack([rng.permutation(N_PAGES)
                      for _ in range(B)]).astype(np.int32)
    pool = rng.integers(-127, 128, (L, B, KH, S, HD)).astype(np.int8)
    scales = np.where(rng.random((L, B, KH, N_PAGES)) < 0.3,
                      rng.uniform(0.01, 0.05, (L, B, KH, N_PAGES)),
                      0.0).astype(np.float32)
    jpool, jscales = jnp.asarray(pool), jnp.asarray(scales)
    tpool, tscales = torch.from_numpy(pool.copy()), \
        torch.from_numpy(scales.copy())
    step = jax.jit(JT.quant_kv_update_stacked)
    pos = np.array([0, 5, 14], np.int32)
    for t in range(20):
        growth = 1.0 + 0.4 * t if t % 3 else 0.2
        new = jnp.asarray(_f32(rng, (L, B, KH, 1, HD), growth),
                          jnp.bfloat16)
        slot = _phys_slots(table, pos)
        mask = None if t % 4 == 0 else np.array([True, t % 2 == 0, True])
        jpool, jscales = step(jpool, jscales, new, jnp.asarray(slot),
                              None if mask is None else jnp.asarray(mask))
        tnew = torch.from_numpy(np.asarray(new, np.float32)).to(
            torch.bfloat16)
        got = T.quant_kv_update_stacked(
            tpool, tscales, tnew, torch.from_numpy(slot),
            None if mask is None else torch.from_numpy(mask))
        assert got[0] is tpool and got[1] is tscales      # in place
        _eq(tpool, jpool)
        _eq(tscales, jscales)
        pos = pos + (1 if mask is None else mask.astype(np.int32))


@pytest.mark.parametrize("t_rows", [13, 16, 32])
def test_quant_kv_write_rows_bitwise_equal_jax(t_rows):
    """The prefill write of T rows (start = 0) into row 1 through a
    permuted page map, over junk with nonzero scales: touched pages get
    fresh scales and a cleared tail, other pages and rows stay.  Jitted
    on the JAX side, as the reference's prefill runs it."""
    rng = np.random.default_rng(t_rows)
    pool = rng.integers(-127, 128, (L, B, KH, S, HD)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, (L, B, KH, N_PAGES)).astype(np.float32)
    prow = rng.permutation(N_PAGES).astype(np.int32)
    vals = jnp.asarray(_f32(rng, (L, t_rows, KH, HD), 2.0), jnp.bfloat16)
    jpool, jscales = jax.jit(JT.quant_kv_write_rows, static_argnums=6)(
        jnp.asarray(pool), jnp.asarray(scales), vals, jnp.int32(1),
        jnp.zeros((), jnp.int32), jnp.asarray(prow), PAGE)
    tpool, tscales = torch.from_numpy(pool.copy()), \
        torch.from_numpy(scales.copy())
    T.quant_kv_write_rows(
        tpool, tscales,
        torch.from_numpy(np.asarray(vals, np.float32)).to(torch.bfloat16),
        1, torch.from_numpy(prow), PAGE)
    _eq(tpool, jpool)
    _eq(tscales, jscales)
    assert not np.array_equal(tpool.numpy(), pool)


def test_init_cache_int8_layout_matches_jax():
    jcfg, tcfg = jax_smoke_config("starcoder2_3b"), \
        get_smoke_config("starcoder2_3b")
    jc = JT.init_cache(jcfg, 2, 64, page_size=8, kv_quant="int8")
    tc = T.init_cache(tcfg, 2, 64, device=CPU, page_size=8, kv_quant="int8")
    assert sorted(jc) == sorted(tc)
    for key, leaf in jc.items():
        assert tuple(tc[key].shape) == leaf.shape, key
        assert str(tc[key].dtype).split(".")[-1] == str(leaf.dtype), key
    assert T.cache_kv_quant(tc) == "int8" == JT.cache_kv_quant(jc)
    assert T.cache_kv_quant(T.init_cache(tcfg, 2, 64, device=CPU)) is None


# ------------------------------------------------ fused decode, int8 pools

POS = np.array([0, 13, 31], np.int32)
H = KH * 4


def _int8_case(rng, extra):
    q = _f32(rng, (B, 1, H, HD))
    k8, ks = jref.quantize_kv_pages(jnp.asarray(_f32(rng, (B, KH, S, HD))),
                                    PAGE)
    v8, vs = jref.quantize_kv_pages(jnp.asarray(_f32(rng, (B, KH, S, HD))),
                                    PAGE)
    ex = ((_f32(rng, (B, H, HD)), _f32(rng, (B, H)),
           (rng.random((B, H)) + 0.5).astype(np.float32)) if extra else None)
    table = np.stack([rng.permutation(N_PAGES)
                      for _ in range(B)]).astype(np.int32)
    jargs = (jnp.asarray(q), k8, v8, jnp.asarray(POS),
             None if ex is None else tuple(map(jnp.asarray, ex)))
    targs = (torch.from_numpy(q), torch.from_numpy(np.array(k8)),
             torch.from_numpy(np.array(v8)), torch.from_numpy(POS),
             None if ex is None else tuple(map(torch.from_numpy, ex)))
    return (jargs, (ks, vs), jnp.asarray(table)), \
        (targs, (torch.from_numpy(np.array(ks)),
                 torch.from_numpy(np.array(vs))), torch.from_numpy(table))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("window,extra", [(0, False), (5, True)])
def test_decode_fused_int8_matches_pallas_interpret(paged, window, extra):
    """The plain fused decode over int8 pools (dequantized per physical
    page, then gathered) against the Pallas kernel's has_scales branch
    and the reference oracle: dense, and paged through a permuted table
    (the pools are then physical, each page with its own scale)."""
    rng = np.random.default_rng(10 * window + paged)
    (jargs, jsc, jtab), (targs, tsc, ttab) = _int8_case(rng, extra)
    pages_j, pages_t = (jtab, ttab) if paged else (None, None)
    want = jfa.decode_attention_fused(*jargs, window=window, blk_c=PAGE,
                                      pages=pages_j, kv_scales=jsc,
                                      interpret=True)
    oracle = jref.decode_fused_reference(
        *jargs, window=window, pages=pages_j,
        page_size=PAGE if paged else 0, kv_scales=jsc)
    got = ops.decode_attention_fused(*targs, pages_t, tsc, window=window,
                                     blk_c=PAGE)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, HD)
    for w in (want, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


def test_decode_fused_int8_paged_equals_dense_bitwise():
    """Inside the port: int8 pages and their scales placed by a shuffled
    table give the dense int8 result bit for bit."""
    rng = np.random.default_rng(3)
    _, (targs, (ks, vs), table) = _int8_case(rng, True)
    q, k8, v8, pos, ex = targs
    pk, pv = torch.empty_like(k8), torch.empty_like(v8)
    pks, pvs = torch.empty_like(ks), torch.empty_like(vs)
    for b in range(B):
        for j in range(N_PAGES):
            p = int(table[b, j])
            pk[b, :, p * PAGE:(p + 1) * PAGE] = k8[b, :, j * PAGE:(j + 1) * PAGE]
            pv[b, :, p * PAGE:(p + 1) * PAGE] = v8[b, :, j * PAGE:(j + 1) * PAGE]
            pks[b, :, p], pvs[b, :, p] = ks[b, :, j], vs[b, :, j]
    for window in (0, 5):
        dense = ops.decode_attention_fused(q, k8, v8, pos, ex,
                                           kv_scales=(ks, vs), window=window)
        paged = ops.decode_attention_fused(q, pk, pv, pos, ex, table,
                                           (pks, pvs), window=window,
                                           blk_c=PAGE)
        assert torch.equal(dense, paged)


def test_rp_schedule_dequantizes_up_front():
    """The chunked (rp) schedule over int8 pools equals the chunked
    schedule over the dequantized f32 pools, bit for bit, and the fused
    schedule within the f32 tolerance."""
    from repro_torch.core import backstream as bs
    rng = np.random.default_rng(4)
    _, (targs, (ks, vs), table) = _int8_case(rng, True)
    q, k8, v8, pos, ex = targs
    rp = bs.OffloadConfig(protocol=bs.OffloadProtocol.RP)
    with bs.use_offload(rp):
        got = bs.decode_attention_combined(q, k8, v8, pos, extra=ex,
                                           pages=table, kv_scales=(ks, vs))
        want = bs.decode_attention_combined(
            q, ref.dequantize_kv_pages(k8, ks),
            ref.dequantize_kv_pages(v8, vs), pos, extra=ex, pages=table)
    assert torch.equal(got, want)
    fused = bs.decode_attention_combined(q, k8, v8, pos, extra=ex,
                                         pages=table, kv_scales=(ks, vs))
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_int8_decode_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(5)
    _, (targs, sc, table) = _int8_case(rng, False)
    with pytest.raises(ValueError, match="CUDA"):
        fa.decode_attention_fused(*targs[:4], kv_scales=sc)

