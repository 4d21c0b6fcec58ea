"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports torch and the port only (the GPU machine has no
JAX); every test here needs an NVIDIA GPU and nvcc, carries the `cuda`
marker and skips without one.  On an H100:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: float32, atol = 1e-5 on outputs (summation order only);
bfloat16, atol = 2e-2 on outputs (one bf16 unit in the last place below
4); the partial kernel's f32 statistics, atol = 1e-4 + rtol 1e-5 (sums
over up to 64 slots); paged == dense bitwise.  The SSD scan against the
sequential recurrence: atol = rtol = 1e-3 on y and on the f32 state
(the kernel's chunked form sums in another order and forms its decays
as exponentials of cumsum differences), plus one bf16 unit (rtol 1e-2)
on a bf16 y.  The dequant-fused matmul against x @ dequantize(W) in f32:
|kernel - plain| <= 1e-5 (|x| @ |W|) (the same products summed in
another order; the sum of their magnitudes bounds what the order can
move), plus one bf16 unit of the plain value for a bf16 output; equal
inputs give equal bits.  The int8 fused decode: the fp tolerances above,
and paged == dense bitwise.  The KNN distances against the plain version
(f32 products summed in another order, then q2 - 2 q.x + x2):
|kernel - plain| <= 1e-5 (|q| + |x|)^2, the square bounding every term of
the sum; a chunk of db gives the bits of the same columns of the whole.
The tensor-core kernels (bf16 flash attention with hd 64, 80, 128 or
256, bf16 KNN with D % 8 == 0, the bf16 decode split, bf16 prefill
quant_matmul) are held to the same tolerances: their bf16 products are exact in f32 (int8
and 4-bit quants are exact in bf16, their scales applied in f32) and the
attention kernels keep P to ~16 bits (a hi and a lo bf16 half), so they
too differ from the plain versions in f32 summation order.  The decode
splits the KV range at fixed logical rows and merges in split order, so
paged == dense and a row run alone == that row in the batch, bitwise.
The SLS kernel walks each bag in slot order with the plain version's
roundings (row * w, then acc + that, in f32), so it equals the plain
version bitwise.  `stream_offload` on the card: BS, RP and AXLE (whose
producers run on a side stream) give equal bits, one launch per chunk.
A graphed speculative server (self:1 draft) equals its eager twin bit
for bit, the draft cache included, and launches one fused decode a
layer for every draft step and every verify query; a full-depth
self-draft accepts every greedy draft at verify row counts below and
above 16.  The host tier: snapshots land in pinned memory through copies
on the side stream that sync nothing; an evicting server (a slot evicted
and admitted into in one fill, requests restored into other slots)
equals a non-evicting one and its eager twin bit for bit; a prefix full
hit equals the no-cache stream bit for bit; the resume's int8 boundary
page write equals the same function on the CPU bit for bit.  A chunked
admission: the streams in flight equal the run without it bit for bit,
no plain segment replays while a slot is reserved, and a chunk syncs
nothing.  The fused partial: its raw statistics at the partial
tolerance, and normalised, alone or as head groups concatenated, the
fused decode's bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build as kbuild               # noqa: E402
from repro_torch.core import backstream as bs                 # noqa: E402
from repro_torch.examples import knn_offload                  # noqa: E402
from repro_torch.kernels import flash_attention as fa         # noqa: E402
from repro_torch.kernels import knn as kknn                   # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.kernels import quant as kquant               # noqa: E402
from repro_torch.kernels import ref                           # noqa: E402
from repro_torch.kernels import sls as ksls                   # noqa: E402
from repro_torch.kernels import ssd as kssd                   # noqa: E402

pytestmark = pytest.mark.cuda
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
B, KH, S, HD, PAGE = 3, 2, 192, 128, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATOL[dtype], err


def _paged_case(dev, dtype, group, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = KH * group
    q = _rand(gen, (B, 1, h, HD), dtype, dev)
    k = _rand(gen, (B, KH, S, HD), dtype, dev)
    v = _rand(gen, (B, KH, S, HD), dtype, dev)
    n = S // PAGE
    table = torch.stack([torch.randperm(n, generator=gen, device=dev)
                         for _ in range(B)]).to(torch.int32)
    pk, pv = torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        for j in range(n):
            p = int(table[b, j])
            pk[b, :, p * PAGE:(p + 1) * PAGE] = k[b, :, j * PAGE:(j + 1) * PAGE]
            pv[b, :, p * PAGE:(p + 1) * PAGE] = v[b, :, j * PAGE:(j + 1) * PAGE]
    extra = (torch.randn((B, h, HD), generator=gen, device=dev),
             torch.randn((B, h), generator=gen, device=dev),
             torch.rand((B, h), generator=gen, device=dev) + 0.5)
    return q, k, v, pk, pv, table, extra


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 12])
def test_decode_fused_kernel(cuda, dtype, group):
    q, k, v, pk, pv, table, extra = _paged_case(cuda, dtype, group, group)
    pos = torch.tensor([0, 70, S - 1], dtype=torch.int32, device=cuda)
    launches = fa.LAUNCHES["decode_attention_fused"]
    for window in (0, 50):
        for ex in (None, extra):
            dense = fa.decode_attention_fused(q, k, v, pos, ex,
                                              window=window, blk_c=PAGE)
            paged = fa.decode_attention_fused(q, pk, pv, pos, ex,
                                              window=window, blk_c=PAGE,
                                              pages=table)
            want = ref.decode_fused_reference(q, k, v, pos, ex,
                                              window=window)
            torch.cuda.synchronize()
            assert torch.equal(dense, paged)
            _close(paged, want, dtype)
    assert fa.LAUNCHES["decode_attention_fused"] == launches + 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,group", [(2, 12), (4, 2), (1, 4)])
def test_fused_partial_head_groups_are_the_fused_decode(cuda, dtype, kh,
                                                         group):
    """The mesh decode's producer: the fused route's raw (acc, m, l),
    within the partial tolerance of the plain version; normalised, the
    fused decode's bits; and n head groups' statistics (the KV heads
    split with them when n | KH, else only q) concatenated and
    normalised, the fused decode's bits too."""
    gen = torch.Generator(device=cuda).manual_seed(kh * 100 + group)
    h = kh * group
    q = _rand(gen, (B, 1, h, HD), dtype, cuda)
    k, v = (_rand(gen, (B, kh, S, HD), dtype, cuda) for _ in range(2))
    table = torch.stack([torch.randperm(S // PAGE, generator=gen,
                                        device=cuda)
                         for _ in range(B)]).to(torch.int32)
    extra = (torch.randn((B, h, HD), generator=gen, device=cuda),
             torch.randn((B, h), generator=gen, device=cuda),
             torch.rand((B, h), generator=gen, device=cuda) + 0.5)
    pos = torch.tensor([0, 70, S - 1], dtype=torch.int32, device=cuda)
    launches = kbuild.LAUNCHES["decode_attention_fused_partial"]
    kw = dict(window=50, blk_c=PAGE, pages=table)
    full = fa.decode_attention_fused(q, k, v, pos, extra, **kw)
    raw = fa.decode_attention_fused_partial(q, k, v, pos, extra, **kw)
    want = ref.decode_fused_partial_reference(
        q, k, v, pos, extra, window=50, pages=table, page_size=PAGE)
    torch.cuda.synchronize()
    for g, w in zip(raw, want):
        assert bool(((g - w).abs() <= 1e-4 + 1e-5 * w.abs()).all())
    assert torch.equal(ref.normalize_fused_partial(raw[0], raw[2], dtype),
                       full)
    calls = 1
    for n in (2, 4):
        if not (kh % n == 0 or (kh == 1 and h % n == 0)):
            continue
        hl, khl = h // n, max(1, kh // n)
        accs, ls = [], []
        for r in range(n):
            hs = slice(r * hl, (r + 1) * hl)
            kvs = slice(r * khl, (r + 1) * khl) if kh % n == 0 \
                else slice(None)
            acc, _, l = fa.decode_attention_fused_partial(
                q[:, :, hs].contiguous(), k[:, kvs].contiguous(),
                v[:, kvs].contiguous(), pos,
                tuple(t[:, hs].contiguous() for t in extra), **kw)
            accs.append(acc)
            ls.append(l)
            calls += 1
        got = ref.normalize_fused_partial(torch.cat(accs, 1),
                                          torch.cat(ls, 1), dtype)
        assert torch.equal(got, full), n
    assert kbuild.LAUNCHES["decode_attention_fused_partial"] == \
        launches + calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_partial_kernel(cuda, dtype):
    q, k, v, _, _, _, _ = _paged_case(cuda, dtype, 4, 7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    valid = torch.rand((B, S), generator=gen, device=cuda) < 0.5
    valid[1] = False
    acc, m, l = fa.decode_attention_partial(q, k, v, valid)
    acc_r, m_r, l_r = ref.decode_partial_reference(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(m), torch.isinf(m_r))
    assert torch.isinf(m[1]).all() and (l[1] == 0).all()
    fin = torch.isfinite(m_r)
    for got, want in ((acc, acc_r), (m[fin], m_r[fin]), (l, l_r)):
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)


# ------------------------------------------- split-KV decode at its edges

# one row per position: the first row, either side of a 64-row split and
# of a 128-row page, the cache's last slot
SPLIT_POS = (0, 63, 64, 127, 128, 1023)


def _split_case(dev, dtype, hd, group, seed, kv="fp", s=1024, page=128):
    """len(SPLIT_POS) rows, 2 KV heads, a shuffled page table: (q, logical
    k, v, physical k, v, table, extra, logical scales, physical scales);
    int8 pools (kv="int8") from quantize_kv_pages."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, kh = len(SPLIT_POS), 2
    h = kh * group
    q = _rand(gen, (b, 1, h, hd), dtype, dev)
    k = _rand(gen, (b, kh, s, hd), dtype, dev)
    v = _rand(gen, (b, kh, s, hd), dtype, dev)
    n = s // page
    table = torch.stack([torch.randperm(n, generator=gen, device=dev)
                         for _ in range(b)]).to(torch.int32)
    sc = psc = None
    if kv == "int8":
        (k, ks), (v, vs) = (ref.quantize_kv_pages(t, page) for t in (k, v))
        sc = (ks, vs)
        psc = (torch.empty_like(ks), torch.empty_like(vs))
    pk, pv = torch.empty_like(k), torch.empty_like(v)
    for r in range(b):
        for j in range(n):
            p = int(table[r, j])
            phys, log = slice(p * page, (p + 1) * page), \
                slice(j * page, (j + 1) * page)
            pk[r, :, phys], pv[r, :, phys] = k[r, :, log], v[r, :, log]
            if sc is not None:
                psc[0][r, :, p], psc[1][r, :, p] = sc[0][r, :, j], sc[1][r, :, j]
    extra = (torch.randn((b, h, hd), generator=gen, device=dev),
             torch.randn((b, h), generator=gen, device=dev),
             torch.rand((b, h), generator=gen, device=dev) + 0.5)
    return q, k, v, pk, pv, table, extra, sc, psc


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("dtype,hd,group", [
    (torch.bfloat16, 128, 12),      # starcoder2_3b: the tensor-core split
    (torch.bfloat16, 64, 1),        # two-tile splits of 128 rows
    (torch.bfloat16, 64, 3),        # granite_moe_3b's group
    (torch.bfloat16, 128, 20),      # more heads than the mma's 16 rows
    (torch.bfloat16, 96, 4),        # no tensor-core instantiation
    (torch.float32, 128, 12),       # the f32 CUDA-core split
    (torch.bfloat16, 256, 2),       # gemma3_12b: the tensor-core split
    (torch.bfloat16, 80, 1),        # opt_2_7b (MHA): the tensor-core split
    (torch.float32, 80, 1),         # opt_2_7b in f32: the CUDA-core split
])
@pytest.mark.parametrize("window", [0, 100])
def test_decode_split_edges(cuda, kv, dtype, hd, group, window):
    """pos on both sides of the 64-row splits (tiles at hd 64) and the
    128-row pages (splits at hd 64), a window crossing splits: paged ==
    dense bitwise, each row run alone ==
    that row in the batch bitwise, close to the plain version; the route
    is the one decode_route names."""
    q, k, v, pk, pv, table, extra, sc, psc = _split_case(
        cuda, dtype, hd, group, seed=hd + group + window, kv=kv)
    pos = torch.tensor(SPLIT_POS, dtype=torch.int32, device=cuda)
    name = ("decode_attention_fused" if kv == "fp"
            else "decode_attention_fused[int8]")
    tc = fa.decode_route(dtype, hd, group) == "tensor_core"
    assert tc == (dtype == torch.bfloat16 and hd in (64, 80, 128, 256)
                  and group <= 16)
    before = (kbuild.LAUNCHES[name], kbuild.LAUNCHES[name + "_tc"])
    dense = fa.decode_attention_fused(q, k, v, pos, extra, window=window,
                                      blk_c=128, kv_scales=sc)
    paged = fa.decode_attention_fused(q, pk, pv, pos, extra, window=window,
                                      blk_c=128, pages=table, kv_scales=psc)
    want = ref.decode_fused_reference(q, pk, pv, pos, extra, window=window,
                                      pages=table, page_size=128,
                                      kv_scales=psc)
    alone = [fa.decode_attention_fused(
        q[r:r + 1], pk[r:r + 1], pv[r:r + 1], pos[r:r + 1],
        tuple(t[r:r + 1] for t in extra), window=window, blk_c=128,
        pages=table[r:r + 1],
        kv_scales=None if psc is None else tuple(t[r:r + 1] for t in psc))
        for r in range(len(SPLIT_POS))]
    torch.cuda.synchronize()
    calls = 2 + len(SPLIT_POS)
    assert (kbuild.LAUNCHES[name] - before[0],
            kbuild.LAUNCHES[name + "_tc"] - before[1]) == (calls, calls * tc)
    assert torch.equal(dense, paged)
    _close(paged, want, dtype)
    for r, one in enumerate(alone):
        assert torch.equal(one, paged[r:r + 1]), r


# whisper_large_v3's cross read: a dense cache of 1500 encoder frames, a
# chunk of 125 (the largest divisor not above 128) and, at hd 64, one
# split a chunk, walked in tiles of 64 and 61 rows; each row up to its
# clip's last frame: the first frame, both sides of a tile and of a
# split, a short clip, and the last two frames
CROSS_POS = (0, 63, 64, 124, 125, 599, 1498, 1499)


def _out_excess(got, want32):
    """Per row, the worst ratio of |got - want32| to 5e-4 + 2^-8 |want32|,
    a bf16 decode output against the plain version in f32: got's rounding
    (2^-9 relative), as much again for the kernel's bf16 products, and
    twice the 2.4e-4 measured at whisper's cross read."""
    return ((got.float() - want32).abs()
            / (5e-4 + 2 ** -8 * want32.abs())).flatten(1).amax(1)


def _split_faults(q, k, v, valid, split):
    """The partial statistics of a split decode that dropped, or read
    twice, the split (of `split` rows) in the middle of each row's valid
    range."""
    j = (valid.sum(dim=1) - 1) // split // 2
    rows = torch.arange(valid.shape[1], device=valid.device)[None]
    one = valid & (rows >= j[:, None] * split) \
        & (rows < (j[:, None] + 1) * split)
    acc, m, l = ref.decode_partial_reference(q, k, v, valid)
    acc_s, m_s, l_s = ref.decode_partial_reference(q, k, v, one)
    w = torch.exp(m_s - m)
    return [ref.decode_partial_reference(q, k, v, valid & ~one),
            (acc + acc_s * w[..., None], m, l + l_s * w)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_dense_cross_read_at_125_row_splits(cuda, dtype):
    """MHA (4 heads), hd 64, S 1500: the fused decode (12 splits of 125
    rows) and the partial over the same mask (12 splits of 128, the last
    of 92), each close to the plain version (bf16: within a limit scaled
    to the output, which a dropped or twice-read split breaks on every
    row of two splits or more), each row alone == its row in the batch,
    bitwise; the launches inside the cross site counted there too."""
    assert fa.dense_chunk(1500, 128) == 125
    split = fa.decode_split(1500, 125, 64)[0]
    assert (split, fa.decode_split(1500, 125, 64)[1]) == (125, 12)
    gen = torch.Generator(device=cuda).manual_seed(23)
    b, h, s, hd = len(CROSS_POS), 4, 1500, 64
    q = _rand(gen, (b, 1, h, hd), dtype, cuda)
    k = _rand(gen, (b, h, s, hd), dtype, cuda)
    v = _rand(gen, (b, h, s, hd), dtype, cuda)
    pos = torch.tensor(CROSS_POS, dtype=torch.int32, device=cuda)
    valid = ref.decode_valid_mask(pos, s, 0)
    sited = ("decode_attention_fused@cross", "decode_attention_partial@cross")
    before = [kbuild.LAUNCHES[n] for n in sited]
    with kbuild.launch_site("cross"):
        out = fa.decode_attention_fused(q, k, v, pos, blk_c=128)
        part = fa.decode_attention_partial(q, k, v, valid)
    assert [kbuild.LAUNCHES[n] - c for n, c in zip(sited, before)] == [1, 1]
    want = ref.decode_fused_reference(q, k, v, pos)
    acc_r, m_r, l_r = ref.decode_partial_reference(q, k, v, valid)
    torch.cuda.synchronize()
    _close(out, want, dtype)
    for got, ref_t in zip(part, (acc_r, m_r, l_r)):
        assert torch.allclose(got, ref_t, atol=1e-4, rtol=1e-5)
    if dtype == torch.bfloat16:
        want32 = ref.normalize_fused_partial(acc_r, l_r, torch.float32)
        assert (_out_excess(out, want32) <= 1).all()
        multi = valid.sum(dim=1) > split
        assert int(multi.sum()) == 4
        for acc_f, _, l_f in _split_faults(q, k, v, valid, split):
            faulty = ref.normalize_fused_partial(acc_f, l_f, dtype)
            assert (_out_excess(faulty, want32)[multi] > 1).all()
    for r in range(b):
        one = slice(r, r + 1)
        assert torch.equal(fa.decode_attention_fused(
            q[one], k[one], v[one], pos[one], blk_c=128), out[one]), r
        alone = fa.decode_attention_partial(q[one], k[one], v[one],
                                            valid[one])
        assert all(torch.equal(a, p[one]) for a, p in zip(alone, part)), r


@pytest.mark.parametrize("dtype,hd,group", [
    (torch.float32, 128, 12), (torch.bfloat16, 128, 12),
    (torch.bfloat16, 256, 2),       # gemma3_12b's heads
    (torch.bfloat16, 80, 1),        # opt_2_7b's (MHA): the tensor cores
    (torch.float32, 80, 1),         # and the CUDA-core split
])
def test_decode_partial_empty_splits_and_rows(cuda, dtype, hd, group):
    """C = 1024: row 0 fully masked, row 1 valid in two splits and at the
    last slot only, row 2 random with its first five splits masked; the
    raw (acc, m, l) against the plain version, empty rows m = -inf and
    l = 0, each row alone == that row in the batch bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, kh, c = 3, 2, 1024
    q = _rand(gen, (b, 1, kh * group, hd), dtype, cuda)
    k = _rand(gen, (b, kh, c, hd), dtype, cuda)
    v = _rand(gen, (b, kh, c, hd), dtype, cuda)
    valid = torch.rand((b, c), generator=gen, device=cuda) < 0.5
    valid[0] = False
    valid[1] = False
    valid[1, 192:256] = True
    valid[1, 650:660] = True
    valid[1, 1023] = True
    valid[2, :320] = False
    name = "decode_attention_partial"
    before = (kbuild.LAUNCHES[name], kbuild.LAUNCHES[name + "_tc"])
    acc, m, l = fa.decode_attention_partial(q, k, v, valid)
    alone = [fa.decode_attention_partial(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                         valid[r:r + 1]) for r in range(b)]
    acc_r, m_r, l_r = ref.decode_partial_reference(q, k, v, valid)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (kbuild.LAUNCHES[name] - before[0],
            kbuild.LAUNCHES[name + "_tc"] - before[1]) == (1 + b, (1 + b) * tc)
    assert torch.isinf(m[0]).all() and (m[0] < 0).all()
    assert (l[0] == 0).all() and (acc[0] == 0).all()
    assert torch.equal(torch.isinf(m), torch.isinf(m_r))
    fin = torch.isfinite(m_r)
    for got, want in ((acc, acc_r), (m[fin], m_r[fin]), (l, l_r)):
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)
    for r, (a1, m1, l1) in enumerate(alone):
        assert torch.equal(a1, acc[r:r + 1]) and torch.equal(l1, l[r:r + 1])
        assert torch.equal(m1, m[r:r + 1])


def test_decode_kernels_refuse_the_tensor_core_route_for_f32(cuda):
    """The C entry points refuse a tensor-core split they have no kernel
    for (f32 q) instead of running another kernel."""
    q, k, v, _, _, _, _ = _paged_case(cuda, torch.float32, 4, 2)
    pos = torch.zeros(B, dtype=torch.int32, device=cuda)
    out = torch.empty_like(q)
    split, n_split = fa.decode_split(S, PAGE, HD)
    ws = torch.empty(B * KH * n_split * 4 * (HD + 2), device=cuda)
    err = fa._fn("rt_decode_fused")(
        0, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        None, 0, None, None, None, None, None, 0, out.data_ptr(),
        ws.data_ptr(), B, 4 * KH, KH, S, HD, PAGE, split, n_split, 0,
        HD ** -0.5, kbuild.stream())
    assert err != 0


# --------------------------------------- the head-dim-64 split route

def _hd64_case(dev, shape, kv, seed):
    """One of the two hd-64 shapes at test size: "cross" (whisper: MHA, 4
    heads, a dense S 1500 in chunks of 125) or "paged" (granite_moe_3b's
    group of 3 on 2 KV heads, S 2048 in pages of 128 under a shuffled
    table).  Returns (q, k, v as the kernel reads them, the logical k, v,
    pos, extra, the call's keywords, the plain version's keywords, the
    keywords of the dense walk over the logical k, v); int8 pools
    (kv="int8") from quantize_kv_pages."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if shape == "cross":
        kh, group, s, page = 4, 1, 1500, 125
        pos = (0, 63, 64, 124, 125, 599, 1498, 1499)
    else:
        kh, group, s, page = 2, 3, 2048, 128
        pos = (0, 127, 128, 300, 1023, 2047)
    b, h = len(pos), kh * group
    q = _rand(gen, (b, 1, h, 64), torch.bfloat16, dev)
    k, v = (_rand(gen, (b, kh, s, 64), torch.bfloat16, dev)
            for _ in range(2))
    sc = None
    if kv == "int8":
        (k, ks), (v, vs) = (ref.quantize_kv_pages(t, page) for t in (k, v))
        sc = (ks, vs)
    kw, pkw = dict(blk_c=page, kv_scales=sc), dict(kv_scales=sc)
    dense_kw = dict(kw)
    pk, pv = k, v
    if shape == "paged":
        n = s // page
        table = torch.stack([torch.randperm(n, generator=gen, device=dev)
                             for _ in range(b)]).to(torch.int32)
        pk, pv = torch.empty_like(k), torch.empty_like(v)
        psc = None if sc is None else tuple(torch.empty_like(t) for t in sc)
        for r in range(b):
            for j in range(n):
                p = int(table[r, j])
                pk[r, :, p * page:(p + 1) * page] = \
                    k[r, :, j * page:(j + 1) * page]
                pv[r, :, p * page:(p + 1) * page] = \
                    v[r, :, j * page:(j + 1) * page]
                if sc is not None:
                    for t, lt in zip(psc, sc):
                        t[r, :, p] = lt[r, :, j]
        kw.update(pages=table, kv_scales=psc)
        pkw.update(pages=table, page_size=page, kv_scales=psc)
    extra = (torch.randn((b, h, 64), generator=gen, device=dev),
             torch.randn((b, h), generator=gen, device=dev),
             torch.rand((b, h), generator=gen, device=dev) + 0.5)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, pk, pv, k, v, pos, extra, kw, pkw, dense_kw


@pytest.mark.parametrize("shape", ["cross", "paged"])
@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("window", [0, 300])
def test_hd64_split_route_against_plain(cuda, shape, kv, window):
    """hd 64 on the tensor-core route at its two shapes (MHA over a dense
    S 1500: 12 splits of 125 rows; a group of 3 over a paged S 2048: 16
    splits of 128), bf16 or int8 pools, with and without a window, extra
    merged: the fused decode within the bf16 tolerance of its plain
    version and (paged) == its dense walk bitwise; the fused partial's
    raw statistics within the partial tolerance, and normalised == the
    fused decode bitwise; (bf16 pools) the partial over the same mask
    within its tolerance; every launch on the tensor-core route."""
    q, k, v, k_log, v_log, pos, extra, kw, pkw, dense_kw = _hd64_case(
        cuda, shape, kv, seed=window + (kv == "int8") + 2 * (shape == "paged"))
    name = "decode_attention_fused" + ("[int8]" if kv == "int8" else "")
    counted = (name, name + "_tc", name.replace("fused", "fused_partial")
               + "_tc", "decode_attention_partial_tc")
    before = [kbuild.LAUNCHES[n] for n in counted]
    out = fa.decode_attention_fused(q, k, v, pos, extra, window=window, **kw)
    raw = fa.decode_attention_fused_partial(q, k, v, pos, extra,
                                            window=window, **kw)
    want = ref.decode_fused_reference(q, k, v, pos, extra, window=window,
                                      **pkw)
    want_raw = ref.decode_fused_partial_reference(q, k, v, pos, extra,
                                                  window=window, **pkw)
    torch.cuda.synchronize()
    _close(out, want, torch.bfloat16)
    for g, w in zip(raw, want_raw):
        assert bool(((g - w).abs() <= 1e-4 + 1e-5 * w.abs()).all())
    assert torch.equal(ref.normalize_fused_partial(raw[0], raw[2],
                                                   torch.bfloat16), out)
    fused = 1
    if "pages" in kw:
        dense = fa.decode_attention_fused(q, k_log, v_log, pos, extra,
                                          window=window, **dense_kw)
        assert torch.equal(dense, out)
        fused += 1
    if kv == "fp":
        valid = ref.decode_valid_mask(pos, k.shape[2], window)
        part = fa.decode_attention_partial(q, k_log, v_log, valid)
        want_p = ref.decode_partial_reference(q, k_log, v_log, valid)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(part[1]), torch.isinf(want_p[1]))
        fin = torch.isfinite(want_p[1])
        for g, w in ((part[0], want_p[0]), (part[1][fin], want_p[1][fin]),
                     (part[2], want_p[2])):
            assert torch.allclose(g, w, atol=1e-4, rtol=1e-5)
    got = [kbuild.LAUNCHES[n] - c for n, c in zip(counted, before)]
    assert got == [fused, fused, 1, int(kv == "fp")], got


def test_hd64_route_bitwise_across_calls_and_graph_replays(cuda):
    """The route's workspace is the call's own and carries nothing from
    one call to the next: a workspace block left full of garbage by its
    last user, two calls back to back, and one captured graph replayed
    twice all give the eager call's bits, for the fused decode, the fused
    partial and the partial."""
    q, k, v, _, _, pos, extra, kw, _, _ = _hd64_case(cuda, "paged", "fp", 5)
    valid = ref.decode_valid_mask(pos, k.shape[2], 0)
    b, kh, s, hd = k.shape
    n_split = fa.decode_split(s, kw["blk_c"], hd)[1]
    ws_floats = b * kh * n_split * (q.shape[2] // kh) * (hd + 2)

    def calls():
        return (fa.decode_attention_fused(q, k, v, pos, extra, **kw),
                *fa.decode_attention_fused_partial(q, k, v, pos, extra, **kw),
                *fa.decode_attention_partial(q, k, v, valid))

    eager = calls()
    junk = [torch.full((ws_floats,), -1, dtype=torch.int32, device=cuda)
            for _ in range(4)]
    del junk                          # their blocks go back to the cache
    again = calls()
    twice = calls()
    torch.cuda.synchronize()
    for outs in (again, twice):
        assert all(torch.equal(a, b) for a, b in zip(outs, eager))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()                       # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    for _ in range(2):
        for t in captured:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def test_hd64_route_on_two_streams_at_once(cuda):
    """Two streams running the route at once, on different inputs, with
    no sync between their launches: each call gives its own inputs' bits
    (a call's splits and merge share no buffer with another call)."""
    cases = [_hd64_case(cuda, shape, "fp", 11 + i)
             for i, shape in enumerate(("paged", "cross"))]

    def call(c):
        q, k, v, _, _, pos, extra, kw, _, _ = c
        return fa.decode_attention_fused(q, k, v, pos, extra, **kw)

    want = [call(c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, (st, c) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                got[i].append(call(c))
    torch.cuda.synchronize()
    for i, outs in enumerate(got):
        assert all(torch.equal(o, want[i]) for o in outs), i


def _flash_case(dev, dtype, s, window, hd=HD, causal=True, kh=2, group=12,
                seed=None):
    """B = 2, `group` query heads per KV head (12 by default); returns the
    launch counts the call added (all, tensor-core)."""
    seed = s + window + hd if seed is None else seed
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _rand(gen, (2, s, group * kh, hd), dtype, dev)
    k = _rand(gen, (2, s, kh, hd), dtype, dev)
    v = _rand(gen, (2, s, kh, hd), dtype, dev)
    before = (kbuild.LAUNCHES["flash_attention"],
              kbuild.LAUNCHES["flash_attention_tc"])
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)
    return (kbuild.LAUNCHES["flash_attention"] - before[0],
            kbuild.LAUNCHES["flash_attention_tc"] - before[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(8, 0), (40, 0), (200, 0), (200, 33)])
def test_flash_attention_kernel(cuda, dtype, s, window):
    """q (2,s,12,HD) on 2 KV heads (a group of 6): f32 takes the CUDA-core
    kernel, bf16 the tensor-core one."""
    tc = int(dtype == torch.bfloat16)
    assert _flash_case(cuda, dtype, s, window, group=6,
                       seed=s + window) == (1, tc)


@pytest.mark.parametrize("s,window", [(8, 0), (200, 33), (512, 0)])
def test_flash_attention_kernel_f32_group_12(cuda, s, window):
    """starcoder2_3b's group of 12 on the f32 CUDA-core kernel."""
    assert _flash_case(cuda, torch.float32, s, window) == (1, 0)


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("window", [0, 33])
@pytest.mark.parametrize("s", [1, 8, 63, 65, 200, 512, 1000])
def test_flash_attention_tensor_core_kernel(cuda, hd, s, window):
    """bf16 with hd 64, 80, 128 and 256: ragged S around the 64-row (32
    at hd 256) KV tiles, a window that empties whole KV tiles; every launch
    on the tensor cores."""
    assert _flash_case(cuda, torch.bfloat16, s, window, hd=hd) == (1, 1)


@pytest.mark.parametrize("window", [0, 100])
def test_flash_attention_tensor_core_kernel_non_causal(cuda, window):
    assert _flash_case(cuda, torch.bfloat16, 300, window, causal=False,
                       kh=1) == (1, 1)


@pytest.mark.parametrize("hd,kh,group", [(256, 8, 2), (80, 32, 1)])
@pytest.mark.parametrize("s,window", [(1100, 1024), (2048, 1024)])
def test_flash_attention_long_window(cuda, hd, kh, group, s, window):
    """gemma3_12b's local layers (hd 256, 8 KV heads of 2) and opt_2_7b's
    MHA (hd 80) at prompts past a 1024-row window, which empties the
    early KV tiles of the late q tiles: both on the tensor cores."""
    assert _flash_case(cuda, torch.bfloat16, s, window, hd=hd, kh=kh,
                       group=group) == (1, 1)


@pytest.mark.parametrize("s,window", [(1100, 1024), (2048, 1024)])
def test_flash_attention_long_window_f32(cuda, s, window):
    """opt_2_7b's MHA in f32 past the window: the CUDA-core kernel."""
    assert _flash_case(cuda, torch.float32, s, window, hd=80, kh=32,
                       group=1) == (1, 0)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 96),
                                      (torch.bfloat16, 32),
                                      (torch.float32, 64),
                                      (torch.float32, 80),
                                      (torch.bfloat16, 72)])
def test_flash_attention_other_inputs_take_the_cuda_core_kernel(cuda, dtype,
                                                                hd):
    assert _flash_case(cuda, dtype, 130, 0, hd=hd) == (1, 0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 4, HD), device=cuda, dtype=torch.float16)
    k = torch.zeros((1, 2, 64, HD), device=cuda, dtype=torch.float16)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa.decode_attention_fused(q, k, k, pos)
    q, k = q.float(), k.float()
    with pytest.raises(ValueError, match="contiguous"):
        fa.decode_attention_fused(q, k.transpose(2, 3), k, pos)
    with pytest.raises(ValueError, match="pos"):
        fa.decode_attention_fused(q, k, k, pos.long())


def _ssd_inputs(dev, dtype, s, seed, b=1, h=32, p=64, n=128):
    """The full-width prefill's shapes and draw: dt = softplus(N(0,1))
    (~0.8), A = -1 (A_log = 0), so cumsums inside a chunk reach ~-50."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _rand(gen, (b, s, h, p), dtype, dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.ones((h,), device=dev)
    B = _rand(gen, (b, s, n), dtype, dev)
    C = _rand(gen, (b, s, n), dtype, dev)
    return x, dt, A, B, C


def _ssd_close(got, want, dtype):
    (y, fin), (y_r, fin_r) = got, want
    assert torch.isfinite(y.float()).all() and torch.isfinite(fin).all()
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    assert torch.allclose(y.float(), y_r.float(), atol=1e-3, rtol=rtol)
    assert torch.allclose(fin, fin_r, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 8, 63, 64, 65, 200, 300, 512])
def test_ssd_scan_kernel(cuda, dtype, s):
    """bf16 takes the tensor-core route (three kernels, one call), f32 the
    CUDA-core kernel; within the tolerance, and a repeat gives equal
    bits."""
    args = _ssd_inputs(cuda, dtype, s, seed=s)
    launches = (kbuild.LAUNCHES["ssd_scan"], kbuild.LAUNCHES["ssd_scan_tc"])
    got = kssd.ssd_scan(*args)
    again = kssd.ssd_scan(*args)
    want = ref.ssd_reference(*args)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert (kbuild.LAUNCHES["ssd_scan"] - launches[0],
            kbuild.LAUNCHES["ssd_scan_tc"] - launches[1]) == (2, 2 * tc)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _ssd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [65, 300])
def test_ssd_scan_rows_alone_equal_rows_in_batch(cuda, dtype, s):
    """Row b of a B = 2 call equals that row run alone, bitwise, with and
    without an init_state."""
    x, dt, A, B, C = _ssd_inputs(cuda, dtype, s, seed=5, b=2)
    init = torch.randn((2, 32, 64, 128), device=cuda) * 0.1
    for st in (None, init):
        got = kssd.ssd_scan(x, dt, A, B, C, init_state=st)
        for b in range(2):
            one = kssd.ssd_scan(*(t[b:b + 1].contiguous() for t in (x, dt)),
                                A, *(t[b:b + 1].contiguous() for t in (B, C)),
                                init_state=None if st is None
                                else st[b:b + 1].contiguous())
            assert torch.equal(one[0], got[0][b:b + 1])
            assert torch.equal(one[1], got[1][b:b + 1])
        _ssd_close(got, ref.ssd_reference(x, dt, A, B, C, init_state=st),
                   dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_padded_tail_and_handoff(cuda, dtype):
    """dt = 0 past 300 leaves the state the 300-token prompt's; two
    halves with the state handed across (ragged split) equal one scan."""
    x, dt, A, B, C = _ssd_inputs(cuda, dtype, 512, seed=3)
    dt_pad = dt.clone()
    dt_pad[:, 300:] = 0.0
    _, fin_pad = kssd.ssd_scan(x, dt_pad, A, B, C)
    _, fin_300 = ref.ssd_reference(x[:, :300].contiguous(),
                                   dt[:, :300].contiguous(), A,
                                   B[:, :300].contiguous(),
                                   C[:, :300].contiguous())
    torch.cuda.synchronize()
    assert torch.allclose(fin_pad, fin_300, atol=1e-3, rtol=1e-3)
    h = 233
    first = kssd.ssd_scan(*(t[:, :h].contiguous() for t in (x, dt)), A,
                          *(t[:, :h].contiguous() for t in (B, C)))
    second = kssd.ssd_scan(*(t[:, h:].contiguous() for t in (x, dt)), A,
                           *(t[:, h:].contiguous() for t in (B, C)),
                           init_state=first[1])
    whole = ref.ssd_reference(x, dt, A, B, C)
    torch.cuda.synchronize()
    _ssd_close((torch.cat([first[0], second[0]], 1), second[1]), whole,
               dtype)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, torch.float32, 16, seed=1, h=4)
    with pytest.raises(ValueError, match="CUDA"):
        kssd.ssd_scan(x.cpu(), dt, A, B, C)
    with pytest.raises(ValueError, match="dtype"):
        kssd.ssd_scan(x.half(), dt, A, B.half(), C.half())
    with pytest.raises(ValueError, match="dtype"):
        kssd.ssd_scan(x, dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError, match="dt"):
        kssd.ssd_scan(x, dt.double(), A, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        kssd.ssd_scan(torch.cat([x, x], -1)[..., :64], dt, A, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        kssd.ssd_scan(x, dt, A, B, C,
                      init_state=torch.zeros((1, 4, 128, 64),
                                             device=cuda).transpose(2, 3))


# ------------------------------------------------ dequant-fused matmul

def _quant_close(got, x, qt):
    w = kquant.dequantize_tensor(qt)
    want = ref.quant_matmul_reference(x, qt).float()
    mag = x.float().abs() @ w.abs()
    tol = 1e-5 * mag
    if x.dtype == torch.bfloat16:
        _, e = torch.frexp(want)
        tol = tol + torch.ldexp(torch.ones_like(want), e - 8)
    err = (got.float() - want).abs()
    assert bool((err <= tol).all()), (err - tol).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
@pytest.mark.parametrize("m,d,n", [
    (4, 3072, 12288),      # decode: w_gate / w_up, bf16 on the tensor cores
    (4, 12288, 3072),      # decode: w_down
    (4, 3072, 3072),       # decode: wq / wo
    (4, 3072, 256),        # decode: wk / wv, on the CUDA cores
    (13, 3072, 1040),      # skinny: 4 row groups, a ragged column tile
    (7, 80, 48),           # ragged m and d (16 padded lanes), one split
    (3, 200, 37),          # ragged n: byte loads
    (16, 24576, 96),       # skinny: two x windows of 64 quant blocks
    (4, 24576, 1024),      # the same on the tensor cores (bf16)
    (512, 3072, 1024),     # prefill: tiled, no split
    (64, 3072, 256),       # prefill: tiled, split
    (100, 97, 130),        # tiled, ragged m, d and n
])
def test_quant_matmul_kernel(cuda, fmt, dtype, m, d, n):
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    w = torch.randn((d, n), generator=gen, device=cuda) * 0.05
    qt = kquant.quantize_tensor(w, fmt)
    x = _rand(gen, (m, d), dtype, cuda)
    name = f"quant_matmul[{fmt}]"
    launches = kbuild.LAUNCHES[name]
    got = kquant.quant_matmul(x, qt)
    again = kquant.quant_matmul(x, qt)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES[name] == launches + 2
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, again)
    _quant_close(got, x, qt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
@pytest.mark.parametrize("m,d,n", [(4, 3072, 12288), (4, 12288, 3072),
                                   (4, 3072, 3072), (4, 3072, 256),
                                   (16, 200, 37)])
def test_quant_matmul_skinny_row_alone_equals_row_in_batch(cuda, fmt, dtype,
                                                           m, d, n):
    """The decode route: one launch (no split-K pass), and each row of x
    run alone gives that row's bits of the batched call."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    qt = kquant.quantize_tensor(
        torch.randn((d, n), generator=gen, device=cuda) * d ** -0.5, fmt)
    x = _rand(gen, (m, d), dtype, cuda)
    name = f"quant_matmul[{fmt}]"
    before = {k: kbuild.LAUNCHES[name + k] for k in ("", "_skinny", "_splitk")}
    got = kquant.quant_matmul(x, qt)
    assert {k: kbuild.LAUNCHES[name + k] - v for k, v in before.items()} == \
        {"": 1, "_skinny": 1, "_splitk": 0}
    for i in range(m):
        assert torch.equal(kquant.quant_matmul(x[i:i + 1].contiguous(), qt),
                           got[i:i + 1])
    _quant_close(got, x, qt)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
@pytest.mark.parametrize("m", [17, 64, 300, 512])
@pytest.mark.parametrize("d,n", [
    (3072, 1040),          # ragged n: 8 column tiles and 16 columns
    (200, 272),            # ragged d: a last block of 8 lanes
    (3072, 256),           # wk / wv: split over d
])
def test_quant_matmul_tensor_core_route(cuda, fmt, m, d, n):
    """bf16 x with m > 16 takes tc_kernel: within the tolerance of the
    plain version, repeat calls bitwise, one tensor-core launch each."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    w = torch.randn((d, n), generator=gen, device=cuda) * d ** -0.5
    qt = kquant.quantize_tensor(w, fmt)
    x = _rand(gen, (m, d), torch.bfloat16, cuda)
    assert kquant.quant_route(x.dtype, m, d, n) == "tensor_core"
    name = f"quant_matmul[{fmt}]"
    before = (kbuild.LAUNCHES[name], kbuild.LAUNCHES[name + "_tc"])
    got = kquant.quant_matmul(x, qt)
    again = kquant.quant_matmul(x, qt)
    torch.cuda.synchronize()
    assert (kbuild.LAUNCHES[name] - before[0],
            kbuild.LAUNCHES[name + "_tc"] - before[1]) == (2, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.equal(got, again)
    _quant_close(got, x, qt)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
@pytest.mark.parametrize("case", ["f32", "d_not_8", "unaligned"])
def test_quant_matmul_other_prefill_inputs_take_the_tiled_kernel(cuda, fmt,
                                                                 case):
    """f32 x, d % 8 != 0 and an x 2 bytes into its storage stay on the
    CUDA-core tiled kernel, with its tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    m, d, n = 300, 100 if case == "d_not_8" else 512, 384
    qt = kquant.quantize_tensor(torch.randn((d, n), generator=gen,
                                            device=cuda) * 0.05, fmt)
    if case == "f32":
        x = _rand(gen, (m, d), torch.float32, cuda)
    elif case == "unaligned":
        x = _rand(gen, (m * d + 1,), torch.bfloat16, cuda)[1:].view(m, d)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    else:
        x = _rand(gen, (m, d), torch.bfloat16, cuda)
    name = f"quant_matmul[{fmt}]"
    before = (kbuild.LAUNCHES[name], kbuild.LAUNCHES[name + "_tc"])
    got = kquant.quant_matmul(x, qt)
    torch.cuda.synchronize()
    assert (kbuild.LAUNCHES[name] - before[0],
            kbuild.LAUNCHES[name + "_tc"] - before[1]) == (1, 0)
    _quant_close(got, x, qt)


def test_quant_kernel_refuses_the_tensor_core_route_for_f32(cuda):
    qt = kquant.quantize_tensor(torch.randn((64, 32), device=cuda), "q8_0")
    x = torch.zeros((32, 64), device=cuda)
    out = torch.empty((32, 32), device=cuda)
    err = kquant.function("rt_quant_matmul", kquant._SIGNATURE)(
        0, 0, x.data_ptr(), qt.quants.data_ptr(), qt.scales.data_ptr(), None,
        out.data_ptr(), None, 32, 64, 32, 2, 1, 2,
        kquant.ROUTE_CODE["tensor_core"], 1, kbuild.stream())
    assert err != 0
    # nor does rt_quant_matmul take the skinny route, which has its own
    # entry point, nor that one a cluster of more than 8 blocks
    err = kquant.function("rt_quant_matmul", kquant._SIGNATURE)(
        0, 0, x.data_ptr(), qt.quants.data_ptr(), qt.scales.data_ptr(), None,
        out.data_ptr(), None, 4, 64, 32, 2, 1, 2,
        kquant.ROUTE_CODE["skinny"], 1, kbuild.stream())
    assert err != 0
    err = kquant.function("rt_quant_skinny", kquant._SKINNY_SIGNATURE)(
        0, 0, x.data_ptr(), qt.quants.data_ptr(), qt.scales.data_ptr(), None,
        out.data_ptr(), 4, 64, 32, 2, 32, 16, 1, 1, 1, 0, kbuild.stream())
    assert err != 0


def test_quant_matmul_on_a_layer_slice(cuda):
    """A layer of a stacked weight (a view at an offset) goes through the
    16-byte loads as the whole stack's first layer does."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qt = kquant.quantize_tensor(
        torch.randn((3, 256, 512), generator=gen, device=cuda), "q4_k")
    x = _rand(gen, (4, 256), torch.bfloat16, cuda)
    for i in range(3):
        _quant_close(kquant.quant_matmul(x, qt.layer(i)), x, qt.layer(i))


def test_quant_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    qt = kquant.quantize_tensor(torch.randn((64, 32), device=cuda), "q8_0")
    with pytest.raises(ValueError, match="dtype"):
        kquant.quant_matmul(torch.zeros((4, 64), device=cuda).half(), qt)
    with pytest.raises(ValueError, match="contiguous"):
        kquant.quant_matmul(torch.zeros((64, 4), device=cuda).t(), qt)
    with pytest.raises(ValueError, match="device"):
        kquant.quant_matmul(torch.zeros((4, 64), device=cuda),
                            kquant.quantize_tensor(torch.randn(64, 32),
                                                   "q8_0"))


# --------------------------------------------- int8 fused decode kernel

def _int8_pools(k, v, table):
    """Logical int8 pools with per-page scales, and the physical pools and
    scales a shuffled table places them in."""
    (k8, ks), (v8, vs) = (ref.quantize_kv_pages(t, PAGE) for t in (k, v))
    pk, pv = torch.empty_like(k8), torch.empty_like(v8)
    pks, pvs = torch.empty_like(ks), torch.empty_like(vs)
    for b in range(B):
        for j in range(S // PAGE):
            p = int(table[b, j])
            pk[b, :, p * PAGE:(p + 1) * PAGE] = k8[b, :, j * PAGE:(j + 1) * PAGE]
            pv[b, :, p * PAGE:(p + 1) * PAGE] = v8[b, :, j * PAGE:(j + 1) * PAGE]
            pks[b, :, p], pvs[b, :, p] = ks[b, :, j], vs[b, :, j]
    return (k8, v8, (ks, vs)), (pk, pv, (pks, pvs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 12])
def test_decode_fused_int8_kernel(cuda, dtype, group):
    q, k, v, _, _, table, extra = _paged_case(cuda, dtype, group, group + 20)
    (k8, v8, sc), (pk, pv, psc) = _int8_pools(k, v, table)
    pos = torch.tensor([0, 70, S - 1], dtype=torch.int32, device=cuda)
    name = "decode_attention_fused[int8]"
    launches = kbuild.LAUNCHES[name]
    for window in (0, 50):
        for ex in (None, extra):
            dense = fa.decode_attention_fused(q, k8, v8, pos, ex,
                                              window=window, kv_scales=sc)
            paged = fa.decode_attention_fused(q, pk, pv, pos, ex,
                                              window=window, blk_c=PAGE,
                                              pages=table, kv_scales=psc)
            want = ref.decode_fused_reference(q, pk, pv, pos, ex,
                                              window=window, pages=table,
                                              page_size=PAGE, kv_scales=psc)
            torch.cuda.synchronize()
            assert torch.equal(dense, paged)
            _close(paged, want, dtype)
    assert kbuild.LAUNCHES[name] == launches + 8


def test_int8_decode_wrapper_refuses_mismatched_scales(cuda):
    q, k, v, _, _, table, _ = _paged_case(cuda, torch.float32, 4, 1)
    (k8, v8, (ks, vs)), _ = _int8_pools(k, v, table)
    pos = torch.zeros(B, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        fa.decode_attention_fused(q, k, v, pos, kv_scales=(ks, vs))
    with pytest.raises(ValueError, match="page size"):
        fa.decode_attention_fused(q, k8, v8, pos, blk_c=PAGE // 2,
                                  pages=table, kv_scales=(ks, vs))
    with pytest.raises(ValueError, match="kv_scales"):
        fa.decode_attention_fused(q, k8, v8, pos,
                                  kv_scales=(ks.double(), vs))


# ------------------------------------------------------------ knn and sls

def _knn_close(got, queries, db):
    want = ref.knn_distances_reference(queries, db)
    qn = queries.float().norm(dim=1)[:, None]
    xn = db.float().norm(dim=1)[None, :]
    err = (got - want).abs()
    assert bool((err <= 1e-5 * (qn + xn) ** 2).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,n,d", [(1, 1, 1), (3, 70, 33), (64, 128, 256),
                                   (65, 129, 40), (100, 1000, 1024),
                                   (1, 1, 64), (65, 129, 1024),
                                   (256, 5000, 1024), (300, 1000, 72)])
def test_knn_kernel(cuda, dtype, q, n, d):
    """Ragged Q, N and D (scalar loads when D % 8 != 0; TMA zero fill past
    the edges on the tensor cores), repeat calls and a chunk of db giving
    the same columns' bits; bf16 with D % 8 == 0 takes the wgmma kernel,
    everything else the CUDA-core one."""
    gen = torch.Generator(device=cuda).manual_seed(q + n + d)
    queries, db = _rand(gen, (q, d), dtype, cuda), _rand(gen, (n, d), dtype,
                                                         cuda)
    wgmma = int(dtype == torch.bfloat16 and d % 8 == 0)
    assert kknn.knn_route(dtype, d) == ("wgmma" if wgmma else "cuda_core")
    launches = (kbuild.LAUNCHES["knn_distances"],
                kbuild.LAUNCHES["knn_distances_wgmma"])
    got = kknn.knn_distances(queries, db)
    again = kknn.knn_distances(queries, db)
    part = kknn.knn_distances(queries, db[n // 3:].contiguous())
    torch.cuda.synchronize()
    assert (kbuild.LAUNCHES["knn_distances"],
            kbuild.LAUNCHES["knn_distances_wgmma"]) == (launches[0] + 3,
                                                        launches[1] + 3 * wgmma)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, n)
    _knn_close(got, queries, db)
    assert torch.equal(again, got)
    assert torch.equal(part, got[:, n // 3:])


def test_knn_unaligned_bf16_takes_the_cuda_core_kernel(cuda):
    """A contiguous view 8 bytes into its storage: no TMA, same values."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    flat = _rand(gen, (4 + 70 * 64,), torch.bfloat16, cuda)
    db = flat[4:].view(70, 64)
    queries = _rand(gen, (5, 64), torch.bfloat16, cuda)
    assert db.is_contiguous() and db.data_ptr() % 16 != 0
    launches = kbuild.LAUNCHES["knn_distances_wgmma"]
    got = kknn.knn_distances(queries, db)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["knn_distances_wgmma"] == launches
    _knn_close(got, queries, db)


def test_knn_topk_ties_on_the_card(cuda):
    """Exact distances (small integers) tying in threes: the kernel path's
    ids are the plain path's, lowest id first."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    base = torch.randint(-3, 4, (10, 16), generator=gen, device=cuda).float()
    db = torch.cat([base, base, base])
    queries = torch.randint(-3, 4, (12, 16), generator=gen,
                            device=cuda).float()
    got = ops.knn_topk(queries, db, 8)
    with ops.reference_mode():
        want = ops.knn_topk(queries, db, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _sls_bags(dev, dtype, v, d, b, l, seed):
    """Padded bags (lengths uniform in 1..l, -1 after), with some indices
    past the table and below -1, and weights in [0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = _rand(gen, (v, d), dtype, dev)
    idx = torch.randint(0, v, (b, l), generator=gen, device=dev,
                        dtype=torch.int32)
    lengths = torch.randint(1, l + 1, (b, 1), generator=gen, device=dev)
    idx[torch.arange(l, device=dev)[None, :] >= lengths] = -1
    idx[0, 0] = v
    idx[-1, -1] = -7
    w = torch.rand((b, l), generator=gen, device=dev)
    return table, idx, w


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "no_w"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,l", [(1000, 256, 13, 100), (500, 100, 7, 5),
                                     (300, 600, 9, 33), (50, 8, 1, 1)])
def test_sls_kernel(cuda, dtype, weighted, v, d, b, l):
    """Any B, ragged D (scalar loads when D % 8 != 0), D over several
    256-column slices, and indices outside the table adding nothing."""
    table, idx, w = _sls_bags(cuda, dtype, v, d, b, l, seed=v + d + b)
    w = w if weighted else None
    launches = kbuild.LAUNCHES["sls"]
    got = ksls.sls(table, idx, w)
    want = ref.sls_reference(table, idx, w)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["sls"] == launches + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, d)
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_knn_and_sls_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        kknn.knn_distances(x, x.cpu())
    with pytest.raises(ValueError, match="one dtype"):
        kknn.knn_distances(x, x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        kknn.knn_distances(x, torch.zeros((8, 4), device=cuda).T)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        ksls.sls(x, idx.cpu())
    with pytest.raises(ValueError, match="int32"):
        ksls.sls(x, idx.long())
    with pytest.raises(ValueError, match="weights"):
        ksls.sls(x, idx, torch.zeros((2, 3), device=cuda).half())


def test_stream_offload_on_the_card(cuda):
    """KNN and SLS streamed in chunks: BS, RP and AXLE give equal bits
    with one launch per chunk; AXLE's producers ran on a side stream,
    the same one in a second AXLE call; the streamed results equal one
    call over the whole input."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    queries = _rand(gen, (48, 96), torch.bfloat16, cuda)
    db = _rand(gen, (6000, 96), torch.bfloat16, cuda)
    table, idx, w = _sls_bags(cuda, torch.float32, 5000, 256, 1000, 20, 6)
    main = torch.cuda.current_stream()
    knn_out, sls_out, streams, side = {}, {}, [], set()

    def sls_producer(i):
        streams.append(torch.cuda.current_stream())
        rows = slice(i * 125, (i + 1) * 125)
        return i, ops.sls(table, idx[rows], w[rows])

    def sls_consumer(out, partial):
        i, pooled = partial
        out[i * 125:(i + 1) * 125] = pooled
        return out

    for proto in bs.OffloadProtocol:
        with bs.use_offload(bs.OffloadConfig(protocol=proto, ring_depth=3)):
            kbuild.reset_launch_counts()
            knn_out[proto] = knn_offload.knn_stream(queries, db, 8, 6, proto,
                                                    global_ids=True)
            streams.clear()
            sls_out[proto] = bs.stream_offload(
                sls_producer, sls_consumer,
                torch.zeros((1000, 256), device=cuda), 8, proto)
            torch.cuda.synchronize()
            assert kbuild.LAUNCHES["knn_distances"] == 6
            assert kbuild.LAUNCHES["knn_distances_wgmma"] == 6
            assert kbuild.LAUNCHES["sls"] == 8
            on_side = [s != main for s in streams]
            assert all(on_side) if proto == bs.OffloadProtocol.AXLE \
                else not any(on_side)
            side.update(s for s in streams if s != main)
    streams.clear()
    bs.stream_offload(sls_producer, sls_consumer,
                      torch.zeros((1000, 256), device=cuda), 8,
                      bs.OffloadProtocol.AXLE)
    assert len(side) == 1 and set(streams) == side
    whole_knn = ops.knn_topk(queries, db, 8)
    whole_sls = ops.sls(table, idx, w)
    torch.cuda.synchronize()
    for proto in bs.OffloadProtocol:
        assert torch.equal(knn_out[proto][0], whole_knn[0])
        assert torch.equal(knn_out[proto][1], whole_knn[1])
        assert torch.equal(sls_out[proto], whole_sls)


# --------------------------------------------------------------------------
# The decode segment as CUDA graphs, and the sampling inside it
# --------------------------------------------------------------------------

from repro_torch.core import prng                             # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402
from repro_torch.launch.steps import QuantConfig              # noqa: E402


class _Eager(tserve.BatchedServer):
    """The server with its segments run launch by launch."""

    def _segment_fns(self, fns, *statics):
        return fns


def _serve_smoke(cls, arch, *, stream, params=None, **kw):
    srv = cls(arch, smoke=True, device="cuda", batch_slots=2, max_seq=64,
              seg_len=4, stream=stream, params=params, **kw)
    rng = np.random.default_rng(3)
    for i in range(4):
        pr = rng.integers(1, srv.cfg.vocab, int(rng.integers(3, 9)))
        sp = (tserve.SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                    seed=i) if i % 2 == 0 else
              tserve.SamplingParams(stop_tokens=(7,)) if i == 1 else None)
        srv.submit(tserve.Request(i, pr.astype(np.int32), 12, sampling=sp))
    kbuild.reset_launch_counts()
    srv.run_until_drained()
    torch.cuda.synchronize()
    return srv, {r.rid: r.generated for r in srv.completed}, \
        dict(kbuild.LAUNCHES)


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("arch,kw", [
    ("starcoder2_3b", dict(protocol="axle")),
    ("starcoder2_3b", dict(protocol="rp")),
    ("starcoder2_3b", dict(protocol="axle",
                           quant=QuantConfig(weights="q8_0", kv="int8"))),
    ("mamba2_370m", dict(protocol="axle")),
    ("granite_moe_3b", dict(protocol="axle")),
    ("jamba_1_5_large", dict(protocol="axle"))])
def test_graphed_serve_equals_eager_bitwise(cuda, arch, kw, stream):
    """Tokens, the cache at drain, the ledger and the launch counts of the
    graphed server equal the eager twin's; every segment is a replay."""
    g, g_toks, g_launches = _serve_smoke(tserve.BatchedServer, arch,
                                         stream=stream, **kw)
    e_kw = dict(kw, quant=QuantConfig(kv=kw["quant"].kv)) \
        if "quant" in kw else kw
    e, e_toks, e_launches = _serve_smoke(_Eager, arch, stream=stream,
                                         params=g.params, **e_kw)
    assert g_toks == e_toks
    assert all(torch.equal(g.cache[k], e.cache[k]) for k in g.cache)
    assert (g.pages_allocated, g.pages_freed, g.pages_resident_peak) == \
        (e.pages_allocated, e.pages_freed, e.pages_resident_peak)
    assert g_launches == e_launches
    assert g.graph_replays == (g.segments_dispatched if stream else g.steps)
    assert e.graph_replays == 0


def test_captured_segment_refuses_another_cache(cuda):
    srv = tserve.BatchedServer("starcoder2_3b", smoke=True, device="cuda",
                               batch_slots=2, max_seq=64)
    srv.cache["page_table"] = srv.cache["page_table"].clone()
    with pytest.raises(RuntimeError, match="captured"):
        srv.step_fn(srv.params, srv.cache, srv.state)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_prng_on_the_card_equals_the_cpu(cuda, seed):
    """Integer ops: the same bits on both devices; the Gumbel draws within
    1e-6 (the two devices' `log` round apart)."""
    keys = [prng.PRNGKey(seed), prng.PRNGKey(seed, cuda)]
    for fn in (lambda k: prng.split(k, 5), lambda k: prng.fold_in(k, 9),
               lambda k: prng.bits(k, 49152),
               lambda k: prng.uniform(k, 49152, 1e-38, 1.0).view(
                   torch.int32)):
        assert torch.equal(fn(keys[0]), fn(keys[1]).cpu())
    torch.testing.assert_close(prng.gumbel(keys[1], 49152).cpu(),
                               prng.gumbel(keys[0], 49152), rtol=0,
                               atol=1e-6)


def test_sampling_on_the_card(cuda):
    """capped == full bitwise, greedy rows argmax, the vocab bound held,
    at the full vocabulary (B = 4, V = 49,152)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    lf = torch.randn((4, 49152), generator=gen, device=cuda) * 4
    keys = torch.stack([prng.PRNGKey(i, cuda) for i in range(4)])
    t = torch.tensor([0.0, 0.8, 1.0, 8.0], device=cuda)
    k = torch.tensor([0, 50, 0, 0], dtype=torch.int32, device=cuda)
    p = torch.tensor([1.0, 0.95, 0.9, 0.9999], device=cuda)
    m = torch.tensor([0.0, 0.0, 0.05, 0.0], device=cuda)
    full = ref.sample_tokens_reference(lf, t, k, p, m, keys, 49000)
    assert torch.equal(ref.sample_tokens_capped(lf, t, k, p, m, keys, 49000),
                       full)
    assert full[0] == lf[0].argmax()
    assert bool((full[1:] < 49000).all())


# --------------------------------------------------------------------------
# Speculative segments as CUDA graphs
# --------------------------------------------------------------------------

SPEC_K = 2


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("arch,kw", [
    ("starcoder2_3b", dict(protocol="axle")),
    ("starcoder2_3b", dict(protocol="axle",
                           quant=QuantConfig(weights="q8_0", kv="int8"))),
    ("mamba2_370m", dict(protocol="axle")),
    ("granite_moe_3b", dict(protocol="axle"))])
def test_graphed_spec_serve_equals_eager_bitwise(cuda, arch, kw, stream):
    """A spec server (self:1 draft, spec_k 2): tokens, the target's AND
    the draft's cache at drain, the ledger, the accept counts and the
    launch counts of the graphed server equal the eager twin's; every
    segment is a replay."""
    spec = dict(spec=True, spec_k=SPEC_K, draft_arch="self:1")
    g, g_toks, g_launches = _serve_smoke(tserve.BatchedServer, arch,
                                         stream=stream, **spec, **kw)
    e_kw = dict(kw, quant=QuantConfig(kv=kw["quant"].kv)) \
        if "quant" in kw else kw
    e, e_toks, e_launches = _serve_smoke(_Eager, arch, stream=stream,
                                         params=g.params, **spec, **e_kw)
    assert g_toks == e_toks
    for a, b in ((g.cache, e.cache), (g.draft_cache, e.draft_cache)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert (g.pages_allocated, g.pages_freed, g.pages_resident_peak) == \
        (e.pages_allocated, e.pages_freed, e.pages_resident_peak)
    assert (g.draft_accepted, g.draft_proposed) == \
        (e.draft_accepted, e.draft_proposed)
    assert g_launches == e_launches
    assert g.graph_replays == (g.segments_dispatched if stream
                               else g.steps // (SPEC_K + 1))
    assert e.graph_replays == 0


def test_spec_verify_launches_one_fused_decode_per_query(cuda):
    """Every draft step and every verify query is one fused decode launch
    a layer: rounds x (k + 1) x (draft layers + target layers)."""
    srv, _, launches = _serve_smoke(tserve.BatchedServer, "starcoder2_3b",
                                    stream=True, protocol="axle", spec=True,
                                    spec_k=SPEC_K, draft_arch="self:1")
    rounds = srv.steps // (SPEC_K + 1)
    assert rounds == srv.segments_dispatched * srv.seg_len
    assert launches["decode_attention_fused"] == rounds * (SPEC_K + 1) * (
        srv.draft_cfg.n_layers + srv.cfg.n_layers)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
@pytest.mark.parametrize("slots,k", [(2, 2), (5, 3)])
def test_full_depth_spec_accepts_every_draft_at_any_verify_rows(cuda, arch,
                                                               slots, k):
    """A full-depth self-draft on the card accepts every greedy draft at
    verify row counts B (k + 1) of 6 and 20: the draft steps run padded
    to the verify's rows, whatever they are, so cuBLAS's choice of kernel
    by the row count cannot part the draft from the verify."""
    n = tserve.get_smoke_config(arch).n_blocks
    srv = tserve.BatchedServer(arch, smoke=True, device="cuda",
                               batch_slots=slots, max_seq=64, seg_len=4,
                               stream=True, spec=True, spec_k=k,
                               draft_arch=f"self:{n}")
    rng = np.random.default_rng(5)
    for i in range(slots):
        # the prefill's token and 6 whole rounds: no round is cut by the
        # budget, which would emit fewer tokens than it accepted
        pr = rng.integers(1, srv.cfg.vocab, int(rng.integers(3, 9)))
        srv.submit(tserve.Request(i, pr.astype(np.int32), 1 + 6 * (k + 1)))
    srv.run_until_drained()
    assert srv.graph_replays == srv.segments_dispatched
    assert srv.draft_accepted == srv.draft_proposed > 0


# --------------------------------------------------------------------------
# The MoE FFN on the card (plain torch, no kernel of ours)
# --------------------------------------------------------------------------

def test_moe_ffn_on_the_card_syncs_nothing(cuda):
    """`layers.moe_ffn` at granite_moe_3b's widths (D 1536, F 512, E 40,
    top-8) over 16 bf16 rows: no host sync (CUDA sync debug mode
    "error") and a captured graph's replay == the eager call bitwise.
    At a decode step's 4 rows (cap 8: nothing drops), a row's output does
    not depend on its batch-mates or its place among them, bitwise: the
    products keep their row count, and the combine adds each row's own
    slots in expert order.  (cuBLAS picks its kernel by the row count, so
    one row alone, 1 row where the batch has 4, may take other bits: the
    server always decodes its 4 slots.)"""
    from repro_torch.models import layers as L
    gen = torch.Generator(device=cuda).manual_seed(0)
    d, f, e, k = 1536, 512, 40, 8
    x = _rand(gen, (16, d), torch.bfloat16, cuda)
    router = torch.randn((d, e), generator=gen, device=cuda) * d ** -0.5
    w = [_rand(gen, s, torch.bfloat16, cuda) * s[1] ** -0.5
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    eager = L.moe_ffn(x, router, *w, k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = L.moe_ffn(x, router, *w, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again, eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = L.moe_ffn(x, router, *w, k)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    rows = x[:4]
    base = L.moe_ffn(rows, router, *w, k)
    for shift in (1, 2, 3):
        rolled = L.moe_ffn(rows.roll(shift, 0), router, *w, k)
        assert torch.equal(rolled.roll(-shift, 0), base), shift
    mates = torch.cat([rows[:1], x[8:11]])
    assert torch.equal(L.moe_ffn(mates, router, *w, k)[0], base[0])


# --------------------------------------------------------------------------
# The host tier: pinned snapshots on the side stream, evict / restore
# --------------------------------------------------------------------------

from repro_torch.models import transformer as T               # noqa: E402


def _tier_cache(dev, kv_quant=None):
    """A smoke starcoder2_3b cache of 3 rows on `dev`, random contents,
    permuted page tables of 4-row pages."""
    cfg = tserve.get_smoke_config("starcoder2_3b")
    cache = T.init_cache(cfg, 3, 16, device=dev, page_size=4,
                         kv_quant=kv_quant)
    gen = torch.Generator(device=dev).manual_seed(0)
    for k, v in cache.items():
        if k == "page_table":
            v.copy_(torch.stack([torch.randperm(4, generator=gen, device=dev)
                                 for _ in range(3)]).to(torch.int32))
        elif v.is_floating_point():
            v.copy_(torch.randn(v.shape, generator=gen, device=dev))
        elif k != "pos":
            v.copy_(torch.randint(-127, 128, v.shape, generator=gen,
                                  device=dev))
    return cfg, cache


def test_snapshot_is_pinned_and_copied_on_the_side_stream(cuda):
    """Evicted pages land in pinned host tensors through copies that wait
    on nothing the host does (sync debug mode "error") and run on the side
    stream: they finish while work queued on the serving stream after
    them still runs, and a restore's copies finish while work queued
    before them still runs.  The round trip is bitwise; a pageable leaf
    bound for the card raises."""
    cfg, cache = _tier_cache(cuda, "int8")
    main = torch.cuda.current_stream()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        leaves = T.extract_slot_cache(cfg, cache, 1)
        snap = bs.stream_offload_to_host(leaves, chunks=3)
        torch.cuda._sleep(2_000_000_000)       # ~1 s on the serving stream
    finally:
        torch.cuda.set_sync_debug_mode("default")
    snap.event.synchronize()
    assert not main.query(), "the copies waited for later serving work"
    host = snap.materialize()
    assert all(t.is_pinned() and t.device.type == "cpu"
               for t in host.values())
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    back = bs.stream_offload_to_device(host, cuda, chunks=3)
    bs._side_stream(cuda).synchronize()
    assert not main.query(), "the restore's copies waited for the stream"
    zero = {k: (v if k in ("pos", "page_table") else torch.zeros_like(v))
            for k, v in cache.items()}
    T.insert_slot_cache(cfg, zero, back, 1)
    for k, v in cache.items():
        if k not in ("pos", "page_table"):
            assert torch.equal(zero[k][:, 1], v[:, 1]), k
    with pytest.raises(ValueError, match="pinned"):
        bs.stream_offload_to_device({"x": torch.zeros(4)}, cuda)


class _Tracked(tserve.BatchedServer):
    """Records where each request was evicted from and restored to, and
    the fills that admitted into a slot evicted in the same fill."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.moves, self.same_fill, self._evicted_now = [], 0, set()

    def _fill_slots(self):
        self._evicted_now = set()
        super()._fill_slots()

    def suspend_slot(self, slot):
        self.moves.append(("out", self.active[slot].rid, slot))
        self._evicted_now.add(slot)
        super().suspend_slot(slot)

    def _restore(self, slot, req):
        self.moves.append(("in", req.rid, slot))
        return super()._restore(slot, req)

    def _admit(self, slot, req):
        self.same_fill += slot in self._evicted_now
        return super()._admit(slot, req)


class _TrackedEager(_Tracked):
    def _segment_fns(self, fns, *statics):
        return fns


def _tier_serve(cls, arch, *, params=None, **kw):
    srv = cls(arch, smoke=True, device="cuda", batch_slots=2, max_seq=64,
              seg_len=4, stream=True, params=params, **kw)
    rng = np.random.default_rng(5)
    for i in range(5):
        pr = rng.integers(1, srv.cfg.vocab, int(rng.integers(4, 10)))
        max_new = int(rng.integers(6, 20))
        sp = (tserve.SamplingParams(temperature=0.8, top_p=0.9, seed=i)
              if i % 2 else None)
        srv.submit(tserve.Request(i, pr.astype(np.int32), max_new,
                                  sampling=sp))
    kbuild.reset_launch_counts()
    srv.run_until_drained()
    torch.cuda.synchronize()
    return srv, {r.rid: r.generated for r in srv.completed}


@pytest.mark.parametrize("arch,kw", [
    ("starcoder2_3b", {}),
    ("starcoder2_3b", dict(quant=QuantConfig(kv="int8"))),
    ("starcoder2_3b", dict(spec=True, spec_k=2, draft_arch="self:1")),
    ("mamba2_370m", {})])
def test_evict_admit_restore_elsewhere_bitwise(cuda, arch, kw):
    """5 requests over 2 slots, evict_after 1, graphed: some slot is
    evicted and admitted into in one fill, some request restored into
    another slot than it left, and every stream equals the non-evicting
    server's and the eager evicting twin's (the cache at drain too)."""
    srv, toks = _tier_serve(_Tracked, arch, host_offload=True, **kw)
    _, base = _tier_serve(tserve.BatchedServer, arch, params=srv.params,
                          **kw)
    eager, e_toks = _tier_serve(_TrackedEager, arch, params=srv.params,
                                host_offload=True, **kw)
    assert toks == base == e_toks
    assert srv.same_fill > 0
    left = {rid: slot for way, rid, slot in srv.moves if way == "out"}
    assert any(way == "in" and left[rid] != slot
               for way, rid, slot in srv.moves)
    assert srv.restores + srv.restored_dead == srv.evictions > 0
    assert srv.graph_replays == srv.segments_dispatched
    assert all(torch.equal(srv.cache[k], eager.cache[k]) for k in srv.cache)
    assert srv.moves == eager.moves


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
def test_prefix_cache_on_the_card(cuda, arch):
    """A miss, a full hit and a partial hit, graphed: the full hit's
    stream (first token from the stored logits) equals the no-cache
    server's bitwise; mamba's resume runs the scan kernel from the
    restored state (one `ssd_scan_init` launch a layer)."""
    rng = np.random.default_rng(3)
    vocab = tserve.get_smoke_config(arch).vocab
    common = rng.integers(1, vocab, 9)
    ext = np.concatenate([common, rng.integers(1, vocab, 5)])

    def run(prefix_cache, params=None):
        srv = tserve.BatchedServer(arch, smoke=True, device="cuda",
                                   batch_slots=2, max_seq=64, seg_len=4,
                                   stream=True, params=params,
                                   prefix_cache=prefix_cache)
        for i, pr in enumerate((common, common, ext)):
            srv.submit(tserve.Request(i, pr.astype(np.int32), 8))
        kbuild.reset_launch_counts()
        srv.run_until_drained()
        torch.cuda.synchronize()
        return srv, {r.rid: r.generated for r in srv.completed}, \
            dict(kbuild.LAUNCHES)

    pc, got, launches = run(True)
    _, want, _ = run(False, pc.params)
    assert (pc.prefix_hits_full, pc.prefix_hits_partial,
            pc.prefix_misses) == (1, 1, 1)
    assert got[0] == want[0] and got[1] == want[1]
    if arch == "mamba2_370m":
        assert launches["ssd_scan_init"] == pc.cfg.n_layers
        assert launches["ssd_scan"] == 2 * pc.cfg.n_layers


def test_resume_int8_boundary_page_on_the_card(cuda):
    """`quant_kv_write_rows` from start 130 (a boundary page of 128 rows
    merging with the restored prefix's scale) on the card equals the same
    function on the CPU bit for bit, and syncs nothing."""
    l, b, kh, s, hd, ps = 2, 3, 8, 1024, 128, 128
    gen = torch.Generator().manual_seed(0)
    pool = torch.randint(-127, 128, (l, b, kh, s, hd), generator=gen,
                         dtype=torch.int8)
    scales = torch.rand((l, b, kh, s // ps), generator=gen) * 0.03
    vals = torch.randn((l, 200, kh, hd), generator=gen) * 3
    prow = torch.randperm(s // ps, generator=gen).to(torch.int32)
    dev = [t.to(cuda) for t in (pool, scales, vals.bfloat16().float(),
                                prow)]
    want = T.quant_kv_write_rows(pool.clone(), scales.clone(),
                                 vals.bfloat16().float(), 1, prow, ps, 130)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = T.quant_kv_write_rows(dev[0], dev[1], dev[2], 1, dev[3], ps,
                                    130)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_slot_state_writes_sync_nothing(cuda):
    """Admitting, saving and restoring a slot's state, and a seed's key,
    wait on nothing (CUDA sync debug mode "error"): their host values
    reach the card as fill arguments, not as copies.  The restored row
    equals the saved one."""
    from repro_torch.launch import steps
    state = steps.init_slot_state(3, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        key = prng.PRNGKey(3, cuda)
        state = steps.admit_slot(state, 1, token=7, position=11, key=key,
                                 remaining=6, temperature=0.7, top_k=12,
                                 top_p=0.9, min_p=0.05, stop=(5, 9))
        snap = bs.stream_offload_to_host(steps.save_slot_state(state, 1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    saved = snap.materialize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        back = steps.restore_slot(state, 2, saved)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for t in steps.state_tensors(back):
        assert torch.equal(t[2], t[1])


class _Chunked(tserve.BatchedServer):
    """Records each dispatched segment's variant beside whether a slot was
    reserved, each request's decode syncs at retirement, and runs every
    chunk but the last (whose first token is the admission's sync), and
    the reservation's upload, under CUDA's sync debug mode "error"."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.variants, self.retire_syncs = [], {}

    def _run_segment(self, fn):
        self.variants.append((fn in (self.segment_plain_fn,
                                     self.step_plain_fn),
                              bool(self.prefilling)))
        return super()._run_segment(fn)

    def _consume_segment(self, *a, **kw):
        super()._consume_segment(*a, **kw)
        for r in self.completed:
            self.retire_syncs.setdefault(r.rid, self.decode_syncs)

    def _begin_chunked(self, slot, req):
        torch.cuda.set_sync_debug_mode("error")
        try:
            super()._begin_chunked(slot, req)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def _pump_prefill(self):
        st = self.prefilling.get(min(self.prefilling, default=-1))
        last = st is None or st["next"] == len(st["plan"]) - 1
        torch.cuda.set_sync_debug_mode("default" if last else "error")
        try:
            super()._pump_prefill()
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
def test_chunked_admission_on_the_card(cuda, arch):
    """Graphed, every row greedy: three requests in flight and a 40-token
    prompt admitted in chunks of 16: the in-flight streams equal the run
    without it bit for bit and retire at the same decode sync; every
    segment while the slot was reserved replays the write-masked graph,
    the plain one before and after; a chunk syncs nothing."""
    rng = np.random.default_rng(8)

    def run(long_prompt, params=None):
        srv = _Chunked(arch, smoke=True, device="cuda", batch_slots=4,
                       max_seq=64, seg_len=4, stream=True, params=params,
                       prefill_chunk=16)
        for i, p in enumerate(prompts + ([long_prompt] if long_prompt is not
                                         None else [])):
            srv.submit(tserve.Request(i, p, 16))
        kbuild.reset_launch_counts()
        srv.run_until_drained()
        torch.cuda.synchronize()
        return srv, {r.rid: r.generated for r in srv.completed}

    vocab = tserve.get_smoke_config(arch).vocab
    prompts = [rng.integers(1, vocab, int(n)).astype(np.int32)
               for n in rng.integers(4, 12, 3)]
    long_p = rng.integers(1, vocab, 40).astype(np.int32)
    base, base_toks = run(None)
    srv, toks = run(long_p, params=base.params)
    assert {r: toks[r] for r in base_toks} == base_toks
    assert {r: srv.retire_syncs[r] for r in base_toks} == base.retire_syncs
    assert srv.prefill_chunks == 3 and len(toks[3]) == 16
    reserved = [plain for plain, res in srv.variants if res]
    assert reserved and not any(reserved)
    assert any(plain for plain, res in srv.variants if not res)
    assert srv.graph_replays == srv.segments_dispatched
    assert srv.pages_allocated == srv.pages_freed
