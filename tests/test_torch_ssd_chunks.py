"""The chunk-parallel SSD scan of the tensor-core route, on the CPU.

`csrc/ssd.cu` runs bf16 scans with P = 64 and N = 128 in three launches:
every chunk's local state from a zero state, an ordered pass over the
chunk states, then every chunk's outputs from the state entering it, with
every product on bf16 tensor cores and every f32 operand (x o w, G o
decay, the state) split into a hi and a lo bf16 half.  The model here is
that algorithm in plain torch, in its order: the cumsum as the kernel's
warp scan (two 32-row halves, Hillis-Steele, the first half's total added
to the second), the halves rounded through bf16 as the kernel rounds them,
f32 sums.  It is held against the plain version (`ref.ssd_reference`),
the JAX oracle and the Pallas kernel in interpret mode, on the same numpy
inputs.  It shows that the chunked arithmetic computes the function; the
kernels themselves are held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, those of chip_smoke.py and the GPU tests: y within 1e-3 +
1e-3 |want| in f32 (the same recurrence in chunks, its decays as
exponentials of cumsum differences, each f32 operand kept to ~16 bits),
one bf16 unit more (rtol 1e-2) for a bf16 y; the f32 state within 1e-3 +
1e-3 |want|.  Bitwise: a dt = 0 tail leaves the state the unpadded
prompt's, and row b of a B = 2 batch is that row alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as jops                         # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro_torch.kernels import ref                           # noqa: E402
from repro_torch.kernels import ssd as kssd                   # noqa: E402

CL = kssd.CHUNK


def _halves(v):
    """hi = bf16(v), lo = bf16(v - hi), as the kernel splits an f32
    operand; both returned in f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _warp_scan(a):
    """The kernel's inclusive cumsum over the last axis (64 rows): a
    Hillis-Steele scan over each 32-row half, then the first half's total
    added to the second half."""
    halves = []
    for v in (a[..., :32], a[..., 32:]):
        for o in (1, 2, 4, 8, 16):
            v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], -1)
        halves.append(v)
    return torch.cat([halves[0], halves[1] + halves[0][..., -1:]], -1)


def ssd_chunks(x, dt, A, B, C, init_state=None):
    """The tensor-core route's algorithm in plain torch.  x: (b,s,h,p);
    dt: (b,s,h) f32; A: (h,); B, C: (b,s,n); init_state (b,h,p,n) or
    None.  Returns (y in x's dtype, final state f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // CL)
    pad = nc * CL - s

    def chunked(t):     # (b, s, ...) -> (b, nc, CL, ...), zero rows past s
        t = torch.cat([t.float(), t.new_zeros((b, pad) + t.shape[2:]).float()],
                      1)
        return t.reshape((b, nc, CL) + t.shape[2:])

    xc, dtc, Bc, Cc = chunked(x), chunked(dt), chunked(B), chunked(C)
    # 1. per chunk: the cumsum of dt A, the local state from zero, C B^T
    cum = _warp_scan((dtc * A.float()).transpose(2, 3))   # (b, nc, h, CL)
    dth = dtc.transpose(2, 3)
    w = torch.exp(cum[..., -1:] - cum) * dth               # (b, nc, h, CL)
    xw = xc.permute(0, 1, 3, 2, 4) * w[..., None]          # (b, nc, h, CL, p)
    hi, lo = _halves(xw)
    Bh = Bc[:, :, None]                                    # (b, nc, 1, CL, n)
    local = hi.transpose(-1, -2) @ Bh + lo.transpose(-1, -2) @ Bh
    cb = Cc @ Bc.transpose(-1, -2)                         # (b, nc, CL, CL)
    # 2. the ordered pass: the state entering each chunk
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n)))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cum[:, c, :, -1])[..., None, None] \
            + local[:, c]
    s_in = torch.stack(entering, 1)                        # (b, nc, h, p, n)
    # 3. per chunk: y = (G o decay) x + (C state^T) exp(cum_i)
    i = torch.arange(CL)
    causal = i[None, :] <= i[:, None]
    decay = torch.exp(cum[..., :, None] - cum[..., None, :])
    g = torch.where(causal, cb[:, :, None] * decay * dth[..., None, :],
                    torch.zeros(()))                       # (b, nc, h, CL, CL)
    g_hi, g_lo = _halves(g)
    xh = xc.permute(0, 1, 3, 2, 4)
    gx = g_hi @ xh + g_lo @ xh
    s_hi, s_lo = _halves(s_in)
    Ch = Cc[:, :, None]
    cs = Ch @ s_hi.transpose(-1, -2) + Ch @ s_lo.transpose(-1, -2)
    y = cs * torch.exp(cum)[..., None] + gx                # (b, nc, h, CL, p)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * CL, h, p)[:, :s]
    return y.to(x.dtype), state


def _inputs(b, s, h, p, n, seed, dtype=torch.float32):
    """The full-width draw: x, B, C ~ N(0,1); dt = softplus(N(0,1)) (~0.8);
    A = -1, so a chunk's cumsum reaches ~-50."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((b, s, h)))).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    return x.to(dtype), dt, -torch.ones(h), B.to(dtype), C.to(dtype)


def _jax(targs):
    return tuple(None if t is None else jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in targs)


def _close(got, want, dtype):
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    for g, w, rt in ((got[0], want[0], rtol), (got[1], want[1], 1e-3)):
        g = torch.as_tensor(np.asarray(g, np.float32)) if not isinstance(
            g, torch.Tensor) else g.float()
        w = torch.as_tensor(np.array(jnp.asarray(w, jnp.float32))) \
            if not isinstance(w, torch.Tensor) else w.float()
        assert torch.isfinite(g).all()
        err = (g - w).abs()
        assert bool((err <= 1e-3 + rt * w.abs()).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
def test_chunks_match_the_plain_version_and_jax_oracle(s, dtype):
    """Ragged S (one row, either side of a chunk, two chunks and a bit)."""
    targs = _inputs(1, s, 3, 16, 32, seed=s, dtype=dtype)
    got = ssd_chunks(*targs)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _close(got, ref.ssd_reference(*targs), dtype)
    _close(got, jref.ssd_reference(*_jax(targs)), dtype)


@pytest.mark.parametrize("s", [64, 192])
def test_chunks_match_the_pallas_kernel_interpret(s):
    """Against the Pallas kernel in interpret mode (chunks of 64), with and
    without an init_state."""
    targs = _inputs(1, s, 2, 16, 32, seed=7)
    init = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 2, 16, 32)).astype(np.float32))
    for st in (None, init):
        got = ssd_chunks(*targs, init_state=st)
        want = jops.ssd_scan(*_jax(targs), *_jax((st,)), blk_s=CL,
                             interpret=True)
        _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chunks_zero_dt_tail_leaves_the_state_exactly(dtype):
    """A prompt of 100 rows padded to 200 with dt = 0: the padded rows add
    exactly 0 and the all-padding chunks decay by exp(0) = 1, so the final
    state and the first 100 rows of y are the unpadded prompt's, bit for
    bit."""
    x, dt, A, B, C = _inputs(1, 200, 2, 16, 32, seed=11, dtype=dtype)
    dt_pad = dt.clone()
    dt_pad[:, 100:] = 0.0
    y_pad, fin_pad = ssd_chunks(x, dt_pad, A, B, C)
    y, fin = ssd_chunks(x[:, :100], dt[:, :100], A, B[:, :100], C[:, :100])
    assert torch.equal(fin_pad, fin)
    assert torch.equal(y_pad[:, :100], y)
    _close((y, fin), ref.ssd_reference(x[:, :100], dt[:, :100], A,
                                       B[:, :100], C[:, :100]), dtype)


def test_chunks_init_state_handoff():
    """Two ragged parts with the state handed across equal one scan, within
    the tolerance (the chunk boundaries differ)."""
    x, dt, A, B, C = _inputs(1, 150, 2, 16, 32, seed=12)
    whole = ref.ssd_reference(x, dt, A, B, C)
    k = 77
    y1, st = ssd_chunks(x[:, :k], dt[:, :k], A, B[:, :k], C[:, :k])
    y2, fin = ssd_chunks(x[:, k:], dt[:, k:], A, B[:, k:], C[:, k:],
                         init_state=st)
    _close((torch.cat([y1, y2], 1), fin), whole, torch.float32)


def test_chunks_rows_of_a_batch():
    """B = 2: each row within the tolerance of the oracles, and equal to
    that row run alone, bit for bit."""
    x, dt, A, B, C = _inputs(2, 100, 2, 16, 32, seed=13,
                             dtype=torch.bfloat16)
    init = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, 2, 16, 32)).astype(np.float32)) * 0.1
    got = ssd_chunks(x, dt, A, B, C, init_state=init)
    _close(got, ref.ssd_reference(x, dt, A, B, C, init_state=init),
           torch.bfloat16)
    _close(got, jref.ssd_reference(*_jax((x, dt, A, B, C)),
                                   init_state=jnp.asarray(init.numpy())),
           torch.bfloat16)
    for b in range(2):
        one = ssd_chunks(x[b:b + 1], dt[b:b + 1], A, B[b:b + 1], C[b:b + 1],
                         init_state=init[b:b + 1])
        assert torch.equal(one[0], got[0][b:b + 1])
        assert torch.equal(one[1], got[1][b:b + 1])


def test_route_and_workspace():
    """bf16 at mamba2_370m's P = 64, N = 128 with aligned inputs takes the
    tensor cores; f32, other widths and unaligned inputs the CUDA cores.
    The workspace holds every chunk's state, C B^T and cumsum."""
    assert kssd.ssd_route(torch.bfloat16, 64, 128) == "tensor_core"
    assert kssd.ssd_route(torch.bfloat16, 64, 128, aligned=False) \
        == "cuda_core"
    assert kssd.ssd_route(torch.float32, 64, 128) == "cuda_core"
    assert kssd.ssd_route(torch.bfloat16, 32, 128) == "cuda_core"
    assert kssd.ssd_route(torch.bfloat16, 64, 64) == "cuda_core"
    assert kssd.ssd_workspace(1, 512, 32, 64, 128) == \
        8 * (32 * 64 * 128 + 64 * 64 + 32 * 64)
    assert kssd.ssd_workspace(2, 65, 1, 64, 128) == \
        4 * (64 * 128 + 64 * 64 + 64)
