"""The split-KV decode's plan and arithmetic, on the CPU.

`flash_attention.decode_split` is the split of the KV range that the
decode kernels run (`csrc/attention.cu`): one block per split of
`decode_split_rows(blk_c, hd)` logical rows (a whole chunk of up to 128
rows at hd 64, at most 64 at the other head dims), the splits merged in
split order.  The tensor-core block walks its split in 64-row tiles,
folding each into its running (acc, m, l) by the online softmax, and the
last block of each (row, KV head) to finish merges the splits in the same
launch.  The model here is that reduction in plain torch: each split's
raw (acc, m, l) formed tile by tile, then the splits folded in order (the
largest m, each non-empty split weighted by exp(m_j - m)), then `extra`
and the normalisation.  It is held against the plain versions and, on the
same numbers, the JAX package's Pallas kernels in interpret mode.  It
shows that a split and its merge compute the function, not that the
kernels split right: tests/test_torch_cuda.py holds the kernels against
the plain versions on the card.

Tolerance: f32 throughout, atol = rtol = 1e-5: the same exponentials and
products, summed per tile and split and then across them instead of in
one pass (the outputs here are below 4 and the sums run over at most 1024
slots)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import flash_attention as jfa              # noqa: E402
from repro_torch.kernels import flash_attention as fa         # noqa: E402
from repro_torch.kernels import ref                           # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# one row per position: the first row, either side of a 64-row split and
# of a 128-row page, the cache's last slot
POS = np.array([0, 63, 64, 127, 128, 1023], np.int32)
KH, G, HD, S, PAGE = 2, 2, 16, 1024, 128


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("blk_c", [1, 7, 16, 48, 50, 64, 96, 100, 125, 128,
                                   1024])
@pytest.mark.parametrize("n_pages", [1, 3, 8])
def test_decode_split_covers_each_row_once_inside_one_page(blk_c, n_pages,
                                                           hd):
    """Every logical row of [0, S) in exactly one split, no split across a
    page, at most 128 rows a split at hd 64 (64 at the others), and the
    plan a function of (S, blk_c, hd) alone; the dense walk (chunk
    `dense_chunk(S, page)`) and the paged walk (chunk = page) get the same
    splits, which is what keeps them bitwise equal."""
    s = n_pages * blk_c
    split, n_split = fa.decode_split(s, blk_c, hd)
    assert fa.decode_split(s, blk_c, hd) == (split, n_split)
    cap = 128 if hd == 64 else 64
    assert 1 <= split <= cap and blk_c % split == 0
    assert split == max(r for r in range(1, min(cap, blk_c) + 1)
                        if blk_c % r == 0)
    rows = []
    for j in range(n_split):
        r0, r1 = j * split, min((j + 1) * split, s)
        assert r0 < r1
        assert r0 // blk_c == (r1 - 1) // blk_c, (j, r0, r1)
        rows.extend(range(r0, r1))
    assert rows == list(range(s))
    assert fa.decode_split(s, fa.dense_chunk(s, blk_c), hd) == \
        (split, n_split)


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("c", [1, 63, 64, 65, 1000, 1024, 1500])
def test_decode_partial_split_is_64_rows(c, hd):
    """The partial's chunk has no pages: splits of 64 rows (128 at hd 64,
    two tiles), the last ragged."""
    split, n_split = fa.decode_split(c, fa.PARTIAL_CHUNK, hd)
    assert split == (128 if hd == 64 else 64)
    assert (n_split - 1) * split < c <= n_split * split


def test_the_two_hd64_shapes_plans():
    """whisper's cross read: 1,500 frames in dense chunks of 125 take one
    split a chunk, 12 a row, each walked as tiles of 64 and 61 rows (the
    partial over the same frames: 11 splits of 128 and one of 92);
    granite_moe_3b's pages of 128 take 16 splits of 128 rows over 2,048
    slots.  The other head dims keep one tile a split."""
    assert fa.dense_chunk(1500, 128) == 125
    assert fa.decode_split(1500, 125, 64) == (125, 12)
    assert fa.decode_split(1500, fa.PARTIAL_CHUNK, 64) == (128, 12)
    assert fa.decode_split(2048, 128, 64) == (128, 16)
    for hd in (80, 128, 256):
        assert fa.decode_split(2048, 128, hd) == (64, 32)
        assert fa.decode_split(1500, 125, hd) == (25, 60)


class _Launch:
    """Stands in for the fused decode's entry points: records the plan the
    wrapper passes (split, n_split: the 5th and 4th arguments from the
    end), returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args[-5:-3])
        return 0


@pytest.mark.parametrize("hd,page", [(64, 128), (64, 125), (128, 128)])
def test_the_wrappers_plan_ignores_batch_heads_pos_and_pages(monkeypatch, hd,
                                                             page):
    """The plan the fused and fused-partial wrappers hand the kernel, read
    at the entry point's arguments: the same for B 1 and 4, for any pos,
    for 8 KV heads of 3 query heads and for one of them (a head group of
    the mesh), and for the paged and the dense walk of the same chunk."""
    launch = _Launch()
    monkeypatch.setattr(fa, "_fn", lambda name: launch)
    monkeypatch.setattr(fa, "check_inputs", lambda *a: None)
    monkeypatch.setattr(fa, "check", lambda *a: None)
    monkeypatch.setattr(fa, "stream", lambda: 0)
    monkeypatch.setattr(fa, "count_site", lambda name: None)
    s = 2048 if page == 128 else 1500
    plans = set()
    for b, kh, g in ((1, 8, 3), (4, 8, 3), (4, 1, 3), (4, 8, 1)):
        q = torch.zeros((b, 1, kh * g, hd), dtype=torch.bfloat16)
        kv = torch.zeros((b, kh, s, hd), dtype=torch.bfloat16)
        for pos in ([0] * b, [s - 1] * b):
            pos = torch.tensor(pos, dtype=torch.int32)
            fa.decode_attention_fused(q, kv, kv, pos, blk_c=page)
            fa.decode_attention_fused_partial(q, kv, kv, pos, blk_c=page)
            if s % page == 0:
                table = torch.zeros((b, s // page), dtype=torch.int32)
                fa.decode_attention_fused(q, kv, kv, pos, blk_c=page,
                                          pages=table)
        plans |= set(launch.calls)
    assert plans == {fa.decode_split(s, fa.dense_chunk(s, page), hd)}, plans


# ------------------------------------------ the split-then-merge model

def tile_walk(q, k, v, valid, tile=fa.DECODE_TILE):
    """One split's raw (acc, m, l) in the tensor-core block's order: its
    rows in tiles of `tile`; each tile's largest score folded into the
    running m, the running l and acc rescaled by exp(m_old - m_new) (the
    online softmax), then the tile's exp(s - m_new) summed and multiplied
    by V; m = -inf where nothing was valid."""
    b, _, h, hd = q.shape
    group = h // k.shape[1]
    qf = q[:, 0].float() * hd ** -0.5
    m = torch.full((b, h), float("-inf"))
    l = torch.zeros((b, h))
    acc = torch.zeros((b, h, hd))
    for r0 in range(0, k.shape[2], tile):
        kt, vt = (t[:, :, r0:r0 + tile].float().repeat_interleave(
            group, dim=1).transpose(1, 2) for t in (k, v))
        ok = valid[:, None, r0:r0 + tile]
        s = torch.einsum("bhd,bchd->bhc", qf, kt).masked_fill(
            ~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        safe = torch.where(torch.isfinite(m_new), m_new,
                           torch.zeros_like(m_new))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe),
                            torch.zeros_like(m))
        p = torch.where(ok, torch.exp(s - safe[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhc,bchd->bhd", p, vt)
        m = m_new
    return acc, m, l


def split_merge(q, k, v, valid, split, extra=None):
    """(acc, m, l) of the splits of [0, C), each formed tile by tile
    (`tile_walk`), merged in split order; m = -inf where every split is
    empty."""
    c = k.shape[2]
    parts = [tile_walk(q, k[:, :, r0:r0 + split], v[:, :, r0:r0 + split],
                       valid[:, r0:r0 + split])
             for r0 in range(0, c, split)]
    m = torch.stack([p[1] for p in parts]).amax(0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for acc_j, m_j, l_j in parts:
        w = torch.where(torch.isfinite(m_j), torch.exp(m_j - m_safe),
                        torch.zeros_like(m_j))
        acc = acc + acc_j * w[..., None]
        l = l + l_j * w
    if extra is not None:
        acc, m, l = ref.merge_fused_partial_pair(acc, m, l, *extra)
    return acc, m, l


def _inputs(seed, extra):
    rng = np.random.default_rng(seed)
    b, h = len(POS), KH * G
    q = rng.standard_normal((b, 1, h, HD)).astype(np.float32)
    k = rng.standard_normal((b, KH, S, HD)).astype(np.float32)
    v = rng.standard_normal((b, KH, S, HD)).astype(np.float32)
    table = np.stack([rng.permutation(S // PAGE)
                      for _ in range(b)]).astype(np.int32)
    ex = None
    if extra:
        ex = (rng.standard_normal((b, h, HD)).astype(np.float32),
              rng.standard_normal((b, h)).astype(np.float32),
              (rng.random((b, h)) + 0.5).astype(np.float32))
    return q, k, v, table, ex


def _pool(kv, table):
    """The physical pool that `table` places the logical pages in."""
    pool = np.empty_like(kv)
    for r in range(kv.shape[0]):
        for j, p in enumerate(table[r]):
            pool[r, :, p * PAGE:(p + 1) * PAGE] = \
                kv[r, :, j * PAGE:(j + 1) * PAGE]
    return pool


@pytest.mark.parametrize("plan_hd", [64, 128])
@pytest.mark.parametrize("window,extra,interpret", [
    (0, False, False), (0, True, True), (100, False, True),
    (100, True, False), (300, True, False)])
def test_split_merge_is_the_fused_decode(window, extra, interpret, plan_hd):
    """pos around the tile, split and page edges, a window crossing tiles
    and splits: the split-then-merge model on the plan of head dim
    `plan_hd` (8 splits of two tiles at 64, 16 of one at 128) against
    ref.decode_fused_reference on a paged pool and (interpret) the Pallas
    kernel over the same pool."""
    q, k, v, table, ex = _inputs(window + int(extra), extra)
    t = {n: torch.from_numpy(a) for n, a in
         (("q", q), ("k", k), ("v", v), ("table", table), ("pos", POS))}
    tex = None if ex is None else tuple(torch.from_numpy(a) for a in ex)
    split, n_split = fa.decode_split(S, PAGE, plan_hd)
    assert (split, n_split) == ((128, 8) if plan_hd == 64 else (64, 16))
    valid = ref.decode_valid_mask(t["pos"], S, window)
    acc, m, l = split_merge(t["q"], t["k"], t["v"], valid, split, tex)
    got = ref.normalize_fused_partial(acc, l, torch.float32)
    pk, pv = _pool(k, table), _pool(v, table)
    want = ref.decode_fused_reference(
        t["q"], torch.from_numpy(pk), torch.from_numpy(pv), t["pos"], tex,
        window=window, pages=t["table"], page_size=PAGE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    want_raw = ref.decode_fused_partial_reference(
        t["q"], t["k"], t["v"], t["pos"], tex, window=window)
    for a, b in zip((acc, m, l), want_raw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    if interpret:
        jex = None if ex is None else tuple(jnp.asarray(a) for a in ex)
        pallas = jfa.decode_attention_fused(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(POS), jex, window=window, blk_c=PAGE,
            pages=jnp.asarray(table), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("plan_hd", [64, 128])
@pytest.mark.parametrize("interpret", [False, True])
def test_split_merge_is_the_partial_with_empty_splits_and_rows(interpret,
                                                               plan_hd):
    """Row 0 fully masked (every split empty), row 1 valid in two splits
    (one tile of a two-tile split at hd 64) and at the last slot, the
    rest random with their first 320 slots masked (a tile of a split
    empty at hd 64): the model's raw (acc, m, l) on the plan of head dim
    `plan_hd` against the plain partial and (interpret) the Pallas kernel;
    an empty row has m = -inf and l = 0."""
    q, k, v, _, _ = _inputs(11, False)
    rng = np.random.default_rng(12)
    valid = rng.random((len(POS), S)) < 0.5
    valid[0] = False
    valid[1] = False
    valid[1, 192:256] = True
    valid[1, 650:660] = True
    valid[1, S - 1] = True
    valid[2:, :320] = False
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    acc, m, l = split_merge(tq, tk, tv, tvalid,
                            fa.decode_split(S, fa.PARTIAL_CHUNK, plan_hd)[0])
    assert bool(torch.isinf(m[0]).all()) and bool((m[0] < 0).all())
    assert bool((l[0] == 0).all()) and bool((acc[0] == 0).all())
    wants = [ref.decode_partial_reference(tq, tk, tv, tvalid)]
    if interpret:
        wants.append(jfa.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(valid), interpret=True))
    for want in wants:
        want = [np.asarray(w) for w in want]
        assert np.array_equal(np.isinf(m.numpy()), np.isinf(want[1]))
        fin = np.isfinite(want[1])
        np.testing.assert_allclose(acc.numpy(), want[0], **TOL)
        np.testing.assert_allclose(m.numpy()[fin], want[1][fin], **TOL)
        np.testing.assert_allclose(l.numpy(), want[2], **TOL)
