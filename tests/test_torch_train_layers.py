"""Parity of the port's training layers (`repro_torch.models.layers`) with
the JAX package, values and gradients, at small shapes in float32: the
same numpy inputs (seeded) go through the JAX function and the port's,
and one seeded cotangent through `jax.vjp` and `torch.autograd.grad`.

Tolerance (both f32, the same products and sums in another order):
every output and every gradient within rtol 1e-4 and atol 1e-5 x its
max |reference|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.models import layers as JL                         # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def _check(jfn, tfn, inputs, seed=0, n_out=1):
    """jfn / tfn on the same f32 inputs: each output, and the gradient of
    <cotangent, outputs> for every input."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(a, jnp.float32) for a in inputs]
    tx = [torch.tensor(np.asarray(a, np.float32), requires_grad=True)
          for a in inputs]
    tout = tfn(*tx)
    if n_out == 1:
        tout = (tout,)
    cots = [rng.standard_normal(tuple(o.shape)).astype(np.float32)
            for o in tout]

    @jax.jit
    def value_and_vjp(args, cot):
        out, vjp = jax.vjp(jfn, *args)
        return out, vjp(cot if n_out > 1 else cot[0])

    jout, jgrads = value_and_vjp(jx, tuple(jnp.asarray(c) for c in cots))
    if n_out == 1:
        jout = (jout,)
    for i, (j, t) in enumerate(zip(jout, tout)):
        _close(t, j, f"output {i}")
    tgrads = torch.autograd.grad(
        tout, tx, grad_outputs=[torch.from_numpy(c) for c in cots])
    for i, (j, t) in enumerate(zip(jgrads, tgrads)):
        _close(t, j, f"grad of input {i}")


@pytest.mark.parametrize("s,window", [(32, 8), (16, 16), (12, 16)])
def test_sliding_attention(s, window):
    """S a multiple of the window (the banded path), S == window and S <
    window (causal blocked attention)."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 4, 16))
    k, v = (rng.standard_normal((2, s, 2, 16)) for _ in range(2))
    _check(lambda *a: JL.sliding_attention(*a, window=window),
           lambda *a: L.sliding_attention(*a, window=window), [q, k, v])


def test_sliding_attention_band_differs_from_causal():
    """Past the window the band masks what causal attention sees."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    band = L.sliding_attention(q, k, v, window=4)
    full = L.blocked_attention(q, k, v, causal=True)
    assert torch.allclose(band[:, :4], full[:, :4], atol=1e-5)
    assert not torch.allclose(band[:, 8:], full[:, 8:], atol=1e-2)


@pytest.mark.parametrize("causal,q_tile,block", [
    (True, 512, 1024), (True, 8, 8), (False, 8, 12)])
def test_blocked_attention_gradients(causal, q_tile, block):
    """Its gradients, one tile or several, causal or not, GQA."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 24, 4, 16))
    k, v = (rng.standard_normal((2, 24, 2, 16)) for _ in range(2))
    kw = dict(causal=causal, q_tile=q_tile, block=block)
    _check(lambda *a: JL.blocked_attention(*a, **kw),
           lambda *a: L.blocked_attention(*a, **kw), [q, k, v])


def test_segsum():
    x = -np.abs(np.random.default_rng(7).standard_normal((3, 2, 9)))
    _check(JL._segsum, L._segsum, [x])


def _ssd_inputs(seed, b=2, s=32, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))   # softplus
    a = -np.exp(0.3 * rng.standard_normal(h))
    bm, cm = (rng.standard_normal((b, s, n)) for _ in range(2))
    return [x, dt, a, bm, cm], rng.standard_normal((b, h, p, n))


@pytest.mark.parametrize("chunk", [8, 32, 256])
def test_ssd_chunked(chunk):
    """y and the final state, S over several chunks (8), one (32) and a
    chunk past S (256 -> 32)."""
    inputs, _ = _ssd_inputs(11)
    _check(lambda *a: JL.ssd_chunked(*a, chunk=chunk),
           lambda *a: L.ssd_chunked(*a, chunk=chunk), inputs, n_out=2)


def test_ssd_chunked_init_state():
    inputs, s0 = _ssd_inputs(13)
    _check(lambda *a: JL.ssd_chunked(*a[:5], chunk=8, init_state=a[5]),
           lambda *a: L.ssd_chunked(*a[:5], chunk=8, init_state=a[5]),
           inputs + [s0], n_out=2)


def test_ssd_chunked_is_the_recurrence():
    """The chunked scan equals stepping `ssd_decode_step` token by token
    (the port's own decode arithmetic) within the f32 tolerance."""
    inputs, s0 = _ssd_inputs(17, s=16)
    x, dt, a, bm, cm = (torch.from_numpy(np.asarray(t, np.float32))
                        for t in inputs)
    y, final = L.ssd_chunked(x, dt, a, bm, cm, chunk=4,
                             init_state=torch.from_numpy(
                                 s0.astype(np.float32)))
    state = torch.from_numpy(s0.astype(np.float32))
    ys = []
    for t in range(x.shape[1]):
        yt, state = L.ssd_decode_step(state, x[:, t], dt[:, t], a,
                                      bm[:, t], cm[:, t])
        ys.append(yt)
    _close(y, torch.stack(ys, 1).numpy(), "y")
    _close(final, state.numpy(), "final state")


def test_moe_aux_loss():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((40, 16))
    router = rng.standard_normal((16, 6)) * 0.25
    _check(lambda a, r: JL.moe_aux_loss(a, r, 2),
           lambda a, r: L.moe_aux_loss(a, r, 2), [x, router])


@pytest.mark.parametrize("chunk,vocab", [(8, 50), (32, 0), (512, 64)])
def test_xent_loss_chunked(chunk, vocab):
    """Chunks shorter than S, and the padded rows past `vocab` masked."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 32, 16)) * 0.5
    emb = rng.standard_normal((64, 16)) * 0.25
    labels = rng.integers(0, vocab or 64, (2, 32)).astype(np.int32)
    labels[:, -1] = 0
    _check(lambda a, e: JL.xent_loss_chunked(a, e, jnp.asarray(labels),
                                             chunk=chunk, vocab=vocab),
           lambda a, e: L.xent_loss_chunked(a, e, torch.from_numpy(labels),
                                            chunk=chunk, vocab=vocab),
           [x, emb])
