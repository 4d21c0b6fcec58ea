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
    cols = -(-n // quant.TILE_COLS)
    rows = -(-m // {"skinny": quant.SKINNY_ROWS, "tiled": quant.TILED_ROWS,
                    "tensor_core": quant.TC_ROWS}[route])
    if (m, d) in ((4, 3072), (4, 12288)) and n >= 3072:
        assert cols * rows * splits >= quant.SMS
    if route != "skinny" and cols * rows >= quant.SMS:
        assert splits == 1


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
