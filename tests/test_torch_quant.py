"""Parity of the port's weight quantization with the JAX package: the
q8_0 / q4_k quantizers and their inverses, the plain dequant-then-matmul
against the Pallas kernel (interpret mode) and the reference's CPU path,
`quantize_params` on the two ported archs, and the weight bridge for a
quantized tree.  Inputs are drawn from a seed with numpy and handed to
both packages.

Tolerances: the quantizers and dequantizers are bitwise (the same f32
divisions, rounding half to even).  quant_matmul in f32: |port - jax| <=
1e-5 * (|x| @ |W|) element-wise — the two sum the same products in
another order, and that sum of magnitudes bounds what reordering can
move; in bf16: one bf16 unit in the last place of the JAX value (both
round an f32 result that differs in summation order only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as jops                          # noqa: E402
from repro.kernels import quant as jquant                      # noqa: E402
from repro.models import quantize as jquantize                 # noqa: E402
from repro.models import transformer as JT                     # noqa: E402
from repro_torch import interop                                # noqa: E402
from repro_torch.kernels import ops, ref                       # noqa: E402
from repro_torch.kernels import quant                          # noqa: E402
from repro_torch.models import quantize                        # noqa: E402

CPU = torch.device("cpu")
FORMATS = quant.WEIGHT_FORMATS


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _weight(rng, shape, dtype):
    w = rng.standard_normal(shape).astype(np.float32) \
        * rng.uniform(0.01, 4.0, size=shape[:-2] + (1, shape[-1]))
    return jnp.asarray(w, dtype)


def _qt_leaves(qt):
    return [qt.scales, qt.quants] + ([qt.mins] if qt.mins is not None
                                     else [])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantizers_bitwise_equal_jax(fmt, dtype):
    """Stacked L=2, ragged d_in=80 (3 blocks, 16 padded lanes), n=48."""
    w = _weight(np.random.default_rng(0), (2, 80, 48), dtype)
    jq = jquant.quantize_tensor(w, fmt)
    tq = quant.quantize_tensor(_t(w), fmt)
    assert (tq.fmt, tq.d_in, tq.shape) == (jq.fmt, jq.d_in, jq.shape)
    assert (tq.mins is None) == (jq.mins is None)
    for got, want in zip(_qt_leaves(tq), _qt_leaves(jq)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(quant.dequantize_tensor(tq)),
                                  _np(jquant.dequantize_tensor(jq)))
    assert tq.nbytes == jq.nbytes


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_error_bound_holds(fmt):
    """|dequant(quant(w)) - w| <= quant_error_bound element-wise, over
    ragged widths on each side of the block edges."""
    rng = np.random.default_rng(1)
    for d in (1, 31, 32, 33, 80, 97):
        w = torch.from_numpy(np.array(_weight(rng, (d, 7), "float32")))
        qt = quant.quantize_tensor(w, fmt)
        nb = qt.scales.shape[0]
        err = (quant.dequantize_tensor(qt) - w).abs()
        err = torch.cat([err, err.new_zeros((nb * 32 - d, 7))])
        bound = ref.quant_error_bound(fmt, qt.scales)[:, None, :]
        assert bool((err.reshape(nb, 32, 7) <= bound + 1e-6).all()), (fmt, d)


def _assert_matmul_close(got, want, x, w, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        mag = np.abs(np.asarray(x, np.float32)) @ np.abs(w)
        assert np.all(np.abs(got - want) <= 1e-5 * mag)
    else:
        _, e = np.frexp(want)
        unit = np.ldexp(np.ones_like(want), e - 8)       # bf16 ulp of want
        assert np.all(np.abs(got - want) <= unit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m,d,n", [(5, 80, 37), (1, 97, 48), (19, 64, 130)])
def test_quant_matmul_matches_jax(fmt, dtype, m, d, n):
    """The port's plain quant_matmul against the Pallas kernel in
    interpret mode and against the reference's CPU path; ragged m, n and
    d (d = 80 and 97 pad their last block)."""
    rng = np.random.default_rng(m * 1000 + d + n)
    w = _weight(rng, (d, n), "float32")
    x = jnp.asarray(rng.standard_normal((m, d)), dtype)
    jq = jquant.quantize_tensor(w, fmt)
    tq = quant.quantize_tensor(_t(w), fmt)
    got = ops.quant_matmul(_t(x), tq)
    assert got.dtype == _t(x).dtype and got.shape == (m, n)
    w_deq = np.asarray(jquant.dequantize_tensor(jq))
    for want in (jquant.quant_matmul(x, jq, interpret=True),
                 jops.quant_matmul(x, jq)):
        _assert_matmul_close(got, jnp.asarray(want, jnp.float32), x, w_deq,
                             dtype)


def test_quant_matmul_flattens_leading_axes():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    qt = quant.quantize_tensor(w, "q8_0")
    out = ops.quant_matmul(x, qt)
    assert out.shape == (2, 3, 24)
    assert torch.equal(out.reshape(6, 24),
                       ops.quant_matmul(x.reshape(6, 40), qt))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_params_same_leaves_as_jax(arch, fmt):
    """The same leaves are quantized, bit for bit the same; the rest are
    the very tensors given."""
    jp = JT.init_params(jax_smoke_config(arch), jax.random.key(0))
    jq = jquantize.quantize_params(jp, fmt)
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    tq = quantize.quantize_params(tp, fmt)
    jleaves = dict(_paths(jq))
    tleaves = dict(_paths(tq))
    fp = dict(_paths(tp))
    assert jleaves.keys() == tleaves.keys()
    n_q = 0
    for path, leaf in tleaves.items():
        want = jleaves[path]
        assert isinstance(leaf, quant.QTensor) \
            == isinstance(want, jquant.QTensor), path
        if isinstance(leaf, quant.QTensor):
            n_q += 1
            assert path[-1] in quantize.QUANT_WEIGHT_NAMES
            for got, exp in zip(_qt_leaves(leaf), _qt_leaves(want)):
                np.testing.assert_array_equal(_np(got), _np(exp))
        else:
            assert leaf is fp[path], path
    assert n_q == len([p for p in jleaves
                       if isinstance(jleaves[p], jquant.QTensor)]) > 0


def test_interop_carries_quantized_tree_bitwise():
    """A JAX-quantized tree, mapped to numpy, crosses as the port's
    QTensors: every leaf bit for bit, format and input width kept."""
    jp = JT.init_params(jax_smoke_config("starcoder2_3b"), jax.random.key(0))
    for fmt in FORMATS:
        jq = jquantize.quantize_params(jp, fmt)
        tq = interop.params_from_jax(jax.tree.map(np.asarray, jq), CPU)
        for sub, name in (("attn", "wq"), ("attn", "wo"), ("ffn", "w_down")):
            got, want = tq["blocks"][0][sub][name], jq["blocks"][0][sub][name]
            assert isinstance(got, quant.QTensor)
            assert (got.fmt, got.d_in, got.shape) == \
                (want.fmt, want.d_in, want.shape)
            for a, b in zip(_qt_leaves(got), _qt_leaves(want)):
                np.testing.assert_array_equal(_np(a), _np(b))
        assert tq["embed"].dtype == torch.bfloat16


def test_layer_slices_are_views():
    w = torch.randn(3, 40, 16)
    qt = quant.quantize_tensor(w, "q4_k")
    one = qt.layer(1)
    assert one.shape == (40, 16) and one.fmt == "q4_k" and one.d_in == 40
    assert one.quants.data_ptr() == qt.quants[1].data_ptr()
    assert torch.equal(quant.dequantize_tensor(one),
                       quant.dequantize_tensor(qt)[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n,d", [(4, 12288, 3072), (4, 3072, 12288),
                                   (4, 256, 3072), (4, 3072, 3072),
                                   (512, 12288, 3072), (64, 256, 3072),
                                   (7, 37, 80), (1, 16, 32),
                                   (512, 3072, 3072), (512, 256, 3072),
                                   (17, 1040, 200), (300, 3072, 12288),
                                   (100, 130, 97)])
def test_quant_plan_covers_every_block_once(m, n, d, dtype):
    """The kernel's route and split of d: a function of the shape (and for
    the route, the dtype) only, every quant block in exactly one split,
    the main path's decode products spread over at least the card's SMs,
    and its bf16 prefill products on the tensor cores, split over d only
    where the output tiles alone leave SMs idle."""
    nb = -(-d // quant.QUANT_BLOCK)
    route = quant.quant_route(dtype, m, d, n)
    assert quant.quant_route(dtype, m, d, n) == route
    if m <= quant.SKINNY_MAX_M:
        assert route == "skinny"
    elif dtype == torch.bfloat16 and d % 8 == 0 and n % 16 == 0:
        assert route == "tensor_core"
        assert quant.quant_route(dtype, m, d, n, aligned=False) == "tiled"
    else:
        assert route == "tiled"
    splits, per = quant.quant_plan(m, n, nb, route)
    assert quant.quant_plan(m, n, nb, route) == (splits, per)
    assert 1 <= per <= nb and (splits - 1) * per < nb <= splits * per
    tile = (quant.skinny_plan(n, nb)[0] if route == "skinny"
            else quant.TILE_COLS)
    cols = -(-n // tile)
    rows = -(-m // {"skinny": quant.SKINNY_ROWS, "tiled": quant.TILED_ROWS,
                    "tensor_core": quant.TC_ROWS}[route])
    if (m, d) in ((4, 3072), (4, 12288)) and n >= 3072:
        assert cols * rows * splits >= quant.SMS
    if route != "skinny" and cols * rows >= quant.SMS:
        assert splits == 1
    if route == "skinny":
        # one launch: the splits are the blocks of a cluster
        assert splits <= quant.SKINNY_MAX_CLUSTER


# the decode projections of starcoder2_3b at 4 slots: (name, d, n)
DECODE_SHAPES = [("w_gate", 3072, 12288), ("w_down", 12288, 3072),
                 ("wq", 3072, 3072), ("wk", 3072, 256)]


@pytest.mark.parametrize("n,d", [(n, d) for _, d, n in DECODE_SHAPES]
                         + [(37, 200), (48, 80), (1040, 3072), (130, 97),
                            (96, 24576), (16, 32), (49152, 3072)])
def test_skinny_plan_covers_every_block_once_with_no_idle_lane(n, d):
    """The skinny kernel's grid, a pure function of (n, quant blocks): each
    quant block in exactly one split of a cluster, no split empty; every
    one of a block's 128 threads on every quant block of its split (16
    column groups x 8 row groups of 4 rows, the row groups covering the
    32 rows of a block); clusters of a power of two up to 8 blocks, whose
    ranks split the 4 x tile partial evenly; a stage of at most 8 KB of
    q8_0 quants and at most one split's blocks, dividing the x window;
    the grid within one wave of three blocks a SM."""
    nb = -(-d // quant.QUANT_BLOCK)
    tile, splits, per, ks = quant.skinny_plan(n, nb)
    assert quant.skinny_plan(n, nb) == (tile, splits, per, ks)
    assert tile in quant.SKINNY_TILES
    blocks = [kb for s in range(splits)
              for kb in range(s * per, min(nb, (s + 1) * per))]
    assert blocks == list(range(nb))
    assert all(s * per < nb for s in range(splits))
    assert splits & (splits - 1) == 0 and splits <= quant.SKINNY_MAX_CLUSTER
    assert (quant.SKINNY_ROWS * tile) % splits == 0
    assert quant.SKINNY_ROW_GROUPS * 4 == quant.QUANT_BLOCK
    assert quant.SKINNY_COL_GROUPS * quant.SKINNY_ROW_GROUPS == 128
    assert tile % quant.SKINNY_COL_GROUPS == 0
    assert ks & (ks - 1) == 0 and 1 <= ks <= per
    assert quant.SKINNY_X_WINDOW % ks == 0
    assert ks * quant.QUANT_BLOCK * tile <= quant.SKINNY_STAGE_BYTES
    tiles = -(-n // tile)
    assert tiles * splits <= max(tiles, quant.SKINNY_BLOCKS_PER_SM * quant.SMS)


@pytest.mark.parametrize("n,d", [(n, d) for _, d, n in DECODE_SHAPES]
                         + [(1040, 3072), (130, 97), (96, 24576)])
def test_skinny_tensor_core_plan_covers_every_block_once(n, d):
    """The tensor-core skinny kernel's grid: 128-column tiles (4 warps of 32
    columns), each quant block in exactly one non-empty split, the most
    splits a cluster takes (8) where d has the blocks for them, and a
    stage of 4 quant blocks where the grid is under a wave of two blocks a
    SM, else 2 (the kernel unrolls them)."""
    nb = -(-d // quant.QUANT_BLOCK)
    tile, splits, per, ks = quant.skinny_plan(n, nb, tensor_core=True)
    assert tile == 128
    blocks = [kb for s in range(splits)
              for kb in range(s * per, min(nb, (s + 1) * per))]
    assert blocks == list(range(nb))
    assert all(s * per < nb for s in range(splits))
    assert splits & (splits - 1) == 0 and splits <= quant.SKINNY_MAX_CLUSTER
    if nb >= 2 * quant.SKINNY_MAX_CLUSTER:
        assert splits == quant.SKINNY_MAX_CLUSTER
    assert ks == (4 if -(-n // tile) * splits <= 2 * quant.SMS else 2)


def test_skinny_tensor_core_route():
    """bf16 x with d % 8 == 0, aligned leaves and at least 8 column tiles
    of 128 takes the tensor cores; f32 x, wk / wv (n = 256), odd d and
    unaligned inputs the CUDA cores."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert quant.skinny_tensor_core(bf16, 3072, 12288, True)
    assert quant.skinny_tensor_core(bf16, 12288, 3072, True)
    assert quant.skinny_tensor_core(bf16, 3072, 1024, True)
    assert not quant.skinny_tensor_core(bf16, 3072, 256, True)
    assert not quant.skinny_tensor_core(bf16, 3072, 896, True)
    assert not quant.skinny_tensor_core(f32, 3072, 12288, True)
    assert not quant.skinny_tensor_core(bf16, 3076, 12288, True)
    assert not quant.skinny_tensor_core(bf16, 3072, 12288, False)


@pytest.mark.parametrize("name,d,n", DECODE_SHAPES)
def test_skinny_plan_fills_the_card_at_the_decode_shapes(name, d, n):
    """At the served decode shapes the column tile divides n (no column
    lane idle).  On the CUDA cores the grid fills the SMs in one wave of
    three blocks a SM: 384 blocks for w_gate / w_up, w_down, wq / wo;
    wk / wv, 0.9 MB, get 64 (launch latency sets their time).  The bf16
    serve puts all but wk / wv on the tensor cores: 768 blocks for w_gate /
    w_up, 192 for w_down, wq / wo."""
    nb = d // quant.QUANT_BLOCK
    tile, splits, per, ks = quant.skinny_plan(n, nb)
    assert n % tile == 0 and nb % splits == 0
    blocks = n // tile * splits
    slots = quant.SKINNY_BLOCKS_PER_SM * quant.SMS
    assert blocks <= slots
    if name == "wk":
        assert (tile, splits, blocks) == (32, 8, 64)
    else:
        assert blocks > 2 * quant.SMS, (name, tile, splits, blocks)
    tc = quant.skinny_tensor_core(torch.bfloat16, d, n, True)
    assert tc == (name != "wk")
    if tc:
        tile, splits, _, _ = quant.skinny_plan(n, nb, tensor_core=True)
        assert n % tile == 0 and n // tile * splits == \
            {"w_gate": 768, "w_down": 192, "wq": 192}[name]


def fold_per_block(x, qt):
    """The tensor-core route's arithmetic in plain torch: per 32-row quant
    block kb, part = x_kb @ q_kb (the integer quants, exact as bf16), then
    acc += scale[kb] * part (+ min[kb] * rowsum(x_kb) for q4_k), in f32."""
    m, d = x.shape
    nb, n = qt.scales.shape
    block = quant.QUANT_BLOCK
    xf = torch.cat([x.float(), x.new_zeros((m, nb * block - d)).float()], 1)
    if qt.fmt == "q8_0":
        q = qt.quants.float()
    else:
        q = torch.stack([(qt.quants & 0xF).float(),
                         (qt.quants >> 4).float()], 2).reshape(nb, block, n)
    acc = torch.zeros((m, n))
    for kb in range(nb):
        xb = xf[:, kb * block:(kb + 1) * block]
        acc = acc + qt.scales[kb] * (xb @ q[kb])
        if qt.fmt == "q4_k":
            acc = acc + qt.mins[kb] * xb.sum(1, keepdim=True)
    return acc


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m,d,n", [(17, 200, 48), (5, 80, 37), (33, 97, 130),
                                   (64, 256, 16)])
def test_per_block_scale_fold_matches_the_plain_version(fmt, m, d, n):
    """sum_kb s (x q)_kb [+ min sum x] against x @ dequantize(W) (the plain
    version, f32) and the Pallas kernel in interpret mode, within
    1e-5 (|x| @ |W|): the same function regrouped per block, the products
    exact, each scale applied in f32; ragged d pads its last block."""
    rng = np.random.default_rng(m + d + n)
    w = _weight(rng, (d, n), "float32")
    x = jnp.asarray(rng.standard_normal((m, d)), "bfloat16").astype(
        jnp.float32)
    jq = jquant.quantize_tensor(w, fmt)
    tq = quant.quantize_tensor(_t(w), fmt)
    got = fold_per_block(_t(x), tq)
    w_deq = np.asarray(jquant.dequantize_tensor(jq))
    mag = np.abs(np.asarray(x)) @ np.abs(w_deq)
    for want in (ref.quant_matmul_reference(_t(x), tq),
                 jquant.quant_matmul(x, jq, interpret=True)):
        err = np.abs(got.numpy() - np.asarray(want, np.float32))
        assert np.all(err <= 1e-5 * mag), (err - 1e-5 * mag).max()


def skinny_order(x, qt, tensor_core=False):
    """The skinny kernels' arithmetic in plain torch, in their order.  On
    the CUDA cores (`skinny_kernel`), for each split of `skinny_plan` and
    each of the 8 row groups (rows 4 rg .. 4 rg + 3 of every quant block),
    per quant block part = x q over the group's 4 rows in row order, then
    acc += scale part (+ min * the sum of x over those rows for q4_k); the
    split's partial adds the row groups' acc in order.  On the tensor cores
    (`skinny_tc_kernel`) part is x q over the whole block (an mma's f32
    sum) and the min multiplies the block's sum of x, in row order.  The
    output adds the splits' partials in split order.  All in f32 (two
    roundings where the kernel's FMA has one)."""
    m, d = x.shape
    nb, n = qt.scales.shape
    block = quant.QUANT_BLOCK
    _, splits, per, _ = quant.skinny_plan(n, nb, tensor_core)
    groups = 1 if tensor_core else quant.SKINNY_ROW_GROUPS
    xf = torch.cat([x.float(), x.new_zeros((m, nb * block - d)).float()], 1)
    rows = block // groups
    xb = xf.reshape(m, nb, groups, rows)
    if qt.fmt == "q8_0":
        q = qt.quants.float()
    else:
        q = torch.stack([(qt.quants & 0xF).float(),
                         (qt.quants >> 4).float()], 2).reshape(nb, block, n)
    qb = q.reshape(nb, groups, rows, n)
    out = torch.zeros((m, n))
    for s in range(splits):
        acc = torch.zeros((groups, m, n))
        for kb in range(s * per, min(nb, (s + 1) * per)):
            xk = xb[:, kb].permute(1, 0, 2)              # (groups, m, rows)
            part = xk[..., 0, None] * qb[kb, :, 0, None]  # (groups, m, n)
            px = xk[..., 0]
            for j in range(1, rows):
                part = part + xk[..., j, None] * qb[kb, :, j, None]
                px = px + xk[..., j]
            acc = acc + qt.scales[kb] * part
            if qt.fmt == "q4_k":
                acc = acc + qt.mins[kb] * px[..., None]
        partial = acc[0]
        for g in range(1, groups):
            partial = partial + acc[g]
        out = out + partial
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,d,n", [(4, 200, 48), (5, 97, 130), (16, 300, 37),
                                   (1, 64, 16), (4, 1024, 64), (4, 96, 1024),
                                   (3, 800, 1040)])
def test_skinny_order_matches_the_plain_version_and_pallas(fmt, xdtype, m,
                                                          d, n):
    """The skinny kernels' regrouped sums (CUDA cores for any x, tensor
    cores for bf16 x) against x @ dequantize(W) (the plain version, f32)
    and the Pallas kernel in interpret mode, within 1e-5 (|x| @ |W|), for
    bf16-valued x (exact products) and for f32 x (whose products round:
    the bound still holds); ragged d pads its last block, several splits
    add in order.  A row alone gives its bits of the batch."""
    rng = np.random.default_rng(m * d + n)
    w = _weight(rng, (d, n), "float32")
    x = jnp.asarray(rng.standard_normal((m, d)), xdtype).astype(jnp.float32)
    jq = jquant.quantize_tensor(w, fmt)
    tq = quant.quantize_tensor(_t(w), fmt)
    tensor_core = quant.skinny_tensor_core(getattr(torch, xdtype), d, n,
                                           True)
    got = skinny_order(_t(x), tq, tensor_core)
    w_deq = np.asarray(jquant.dequantize_tensor(jq))
    mag = np.abs(np.asarray(x)) @ np.abs(w_deq)
    for want in (ref.quant_matmul_reference(_t(x), tq),
                 jquant.quant_matmul(x, jq, interpret=True)):
        err = np.abs(got.numpy() - np.asarray(want, np.float32))
        assert np.all(err <= 1e-5 * mag), (err - 1e-5 * mag).max()
    for i in range(m):
        assert torch.equal(skinny_order(_t(x)[i:i + 1], tq, tensor_core),
                           got[i:i + 1])


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_shapes():
    qt = quant.quantize_tensor(torch.randn(64, 32), "q8_0")
    with pytest.raises(ValueError, match="CUDA"):
        quant.quant_matmul(torch.randn(4, 64), qt)
    with pytest.raises(ValueError, match="d_in"):
        quant.check_args(torch.randn(4, 40), qt)
    with pytest.raises(ValueError, match="unstacked"):
        quant.check_args(torch.randn(4, 64),
                         quant.quantize_tensor(torch.randn(2, 64, 32),
                                               "q8_0"))
    bad = quant.QTensor(qt.scales, qt.quants.to(torch.uint8), None, "q8_0",
                        64)
    with pytest.raises(ValueError, match="quants"):
        quant.check_args(torch.randn(4, 64), bad)
    assert quant.check_args(torch.randn(4, 64), qt) == (4, 32, 2)


def test_matmul_dispatches_on_the_leaf():
    x = torch.randn(3, 64)
    w = torch.randn(64, 32)
    assert torch.equal(quantize.matmul(x, w), x @ w)
    qt = quant.quantize_tensor(w, "q8_0")
    assert torch.equal(quantize.matmul(x, qt),
                       ref.quant_matmul_reference(x, qt))


def test_transformer_module_holds_quantized_leaves():
    """A quantized tree registers as buffers under the JAX pytree paths
    and comes back as the same QTensors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("starcoder2_3b")
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    tq = quantize.quantize_params(tp, "q4_k")
    model = T.Transformer(cfg, tq)
    keys = set(model.state_dict())
    assert {"blocks.0.attn.wq.scales", "blocks.0.attn.wq.quants",
            "blocks.0.attn.wq.mins", "blocks.0.ffn.w_down.quants",
            "blocks.0.attn.ln", "embed"} <= keys
    back = model.params["blocks"][0]["ffn"]["w_up"]
    want = tq["blocks"][0]["ffn"]["w_up"]
    assert isinstance(back, quant.QTensor) and back.fmt == "q4_k"
    assert back.quants is want.quants and back.d_in == want.d_in
