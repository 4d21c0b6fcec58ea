"""Parity of the port's Mamba2 SSD scan (`repro_torch.kernels`) with the
JAX package, on the CPU: the plain version `ref.ssd_reference` against
JAX's `ref.ssd_reference` (the sequential oracle) and against the Pallas
kernel run in interpret mode, on the same numpy inputs.  The CUDA kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py).

Tolerances:
  * float32 against JAX's oracle: atol = rtol = 1e-5 — the same
    sequential recurrence, the two frameworks order the sums over p and n
    differently;
  * bfloat16 y against JAX's oracle: atol 2e-2, rtol 1e-2 — both round
    the same f32 value to bf16, and a last-bit difference in f32 can move
    it by one bf16 unit (2^-7 relative at most); the final state stays
    f32 and keeps the f32 tolerance;
  * against the Pallas kernel (chunked, exp of cumsum differences):
    atol = rtol = 1e-3 in f32;
  * inside the port: a dt = 0 tail and the init_state handoff are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as jops                         # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro_torch.kernels import build as kbuild               # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels import ssd as kssd                   # noqa: E402

SHAPES = [(1, 8, 2, 16, 16), (2, 37, 3, 8, 32), (1, 64, 4, 16, 128)]


def _inputs(b, s, h, p, n, seed, full_width_dt=False):
    """x, B, C ~ N(0,1); dt = softplus(N(0,1)); A = -exp(0.3 N) or, for
    the full-width draw, A = -1 as `A_log = 0` gives."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    if full_width_dt:
        A = -np.ones((h,), np.float32)
    else:
        A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _torch(arrs, dtype):
    """x, B, C in `dtype`; dt and A stay f32."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrs)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def _jax(targs):
    """The port's inputs, bit for bit, as JAX arrays (bf16 through f32,
    which is exact)."""
    return tuple(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in targs)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_reference_matches_jax_oracle(shape, dtype):
    targs = _torch(_inputs(*shape, seed=sum(shape)), dtype)
    y, fin = ref.ssd_reference(*targs)
    y_j, fin_j = jref.ssd_reference(*_jax(targs))
    assert y.dtype == dtype and fin.dtype == torch.float32
    assert tuple(fin.shape) == (shape[0], shape[2], shape[3], shape[4])
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(y), _np(y_j), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(y), _np(y_j), atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(fin), _np(fin_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 16), (2, 128, 3, 8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_reference_matches_pallas_kernel_interpret(shape):
    targs = _torch(_inputs(*shape, seed=7), torch.float32)
    init = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (shape[0], shape[2], shape[3], shape[4])).astype(np.float32))
    for st in (None, init):
        y, fin = ref.ssd_reference(*targs, init_state=st)
        y_k, fin_k = jops.ssd_scan(
            *_jax(targs), None if st is None else jnp.asarray(st.numpy()),
            blk_s=32, interpret=True)
        np.testing.assert_allclose(_np(y), _np(y_k), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(_np(fin), _np(fin_k), atol=1e-3,
                                   rtol=1e-3)


def test_ssd_reference_full_width_dt_stays_finite():
    """dt ~ 0.8 and A = -1 over 512 steps: the decay of a long prefix
    reaches exp(-400), far below f32's range, and must stay 0, not nan."""
    targs = _torch(_inputs(1, 512, 2, 8, 16, seed=3, full_width_dt=True),
                   torch.float32)
    y, fin = ref.ssd_reference(*targs)
    y_j, fin_j = jref.ssd_reference(*_jax(targs))
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    np.testing.assert_allclose(_np(y), _np(y_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(fin), _np(fin_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_zero_dt_tail_leaves_state_exactly(dtype):
    """A padded prompt: dt = 0 past `length` decays by exp(0) = 1 and adds
    0, so the final state is the prompt's own, bit for bit, and the rows
    before `length` are the prompt's y."""
    length = 21
    x, dt, A, B, C = _torch(_inputs(2, 40, 3, 8, 16, seed=11), dtype)
    dt_pad = dt.clone()
    dt_pad[:, length:] = 0.0
    y_pad, fin_pad = ref.ssd_reference(x, dt_pad, A, B, C)
    y, fin = ref.ssd_reference(x[:, :length], dt[:, :length], A,
                               B[:, :length], C[:, :length])
    assert torch.equal(fin_pad, fin)
    assert torch.equal(y_pad[:, :length], y)
    _, fin_j = jref.ssd_reference(*_jax((x, dt_pad, A, B, C)))
    np.testing.assert_allclose(_np(fin_pad), _np(fin_j), atol=1e-5,
                               rtol=1e-5)


def test_ssd_init_state_handoff():
    """Two halves with the state handed across equal one scan: bitwise in
    the plain version, and as JAX's oracle gives them."""
    x, dt, A, B, C = _torch(_inputs(1, 50, 2, 16, 32, seed=12),
                            torch.float32)
    y_full, fin_full = ref.ssd_reference(x, dt, A, B, C)
    h = 23
    y1, st = ref.ssd_reference(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h])
    y2, fin = ref.ssd_reference(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:],
                                init_state=st)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(fin, fin_full)
    y2_j, fin_j = jref.ssd_reference(
        *_jax((x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:])),
        init_state=jnp.asarray(st.numpy()))
    np.testing.assert_allclose(_np(y2), _np(y2_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(fin), _np(fin_j), atol=1e-5, rtol=1e-5)


def test_ops_sends_cpu_tensors_to_the_plain_version():
    targs = _torch(_inputs(1, 12, 2, 8, 16, seed=13), torch.float32)
    before = dict(kbuild.LAUNCHES)
    y, fin = ops.ssd_scan(*targs)
    y_r, fin_r = ref.ssd_reference(*targs)
    assert torch.equal(y, y_r) and torch.equal(fin, fin_r)
    assert kbuild.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper raises on a CPU tensor rather than quietly running the
    plain version, and counts no launch."""
    targs = _torch(_inputs(1, 8, 2, 8, 16, seed=14), torch.float32)
    before = kbuild.LAUNCHES["ssd_scan"]
    with pytest.raises(ValueError, match="CUDA"):
        kssd.ssd_scan(*targs)
    assert kbuild.LAUNCHES["ssd_scan"] == before
