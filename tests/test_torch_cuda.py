"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports torch and the port only (the GPU machine has no
JAX); every test here needs an NVIDIA GPU and nvcc, carries the `cuda`
marker and skips without one.  On an H100:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: float32, atol = 1e-5 on outputs (summation order only);
bfloat16, atol = 2e-2 on outputs (one bf16 unit in the last place below
4); the partial kernel's f32 statistics, atol = 1e-4 + rtol 1e-5 (sums
over up to 64 slots); paged == dense bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa         # noqa: E402
from repro_torch.kernels import ref                           # noqa: E402

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(8, 0), (40, 0), (200, 0), (200, 33)])
def test_flash_attention_kernel(cuda, dtype, s, window):
    gen = torch.Generator(device=cuda).manual_seed(s + window)
    q = _rand(gen, (2, s, 12, HD), dtype, cuda)
    k = _rand(gen, (2, s, 2, HD), dtype, cuda)
    v = _rand(gen, (2, s, 2, HD), dtype, cuda)
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    _close(got, want, dtype)


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
