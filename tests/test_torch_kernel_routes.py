"""Which hand-written kernel takes which inputs, and the arithmetic of the
tensor-core flash kernel's P split, on the CPU.

`flash_route`, `decode_route` and `knn_route` are the wrappers' dispatch
between a tensor-core kernel and the CUDA-core kernel of the same
function (`quant.quant_route`, tested in test_torch_quant.py, does the
same for quant_matmul): a rule on what each kernel takes, never a
fallback on failure.  The P split
(`csrc/attention.cu`, flash_tc_kernel) feeds the softmax weights to the
bf16 tensor cores as p_hi = bf16(p) and p_lo = bf16(p - p_hi), two
products into one f32 accumulator; the model here is that arithmetic in
plain torch, against f64.  It shows what the split buys, not that the
kernel splits right: the GPU tests hold flash_tc_kernel against
`mha_reference` for that."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa          # noqa: E402
from repro_torch.kernels import knn as kknn                    # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,hd,aligned,route", [
    (BF16, 128, True, "tensor_core"),      # starcoder2_3b's head dim
    (BF16, 64, True, "tensor_core"),
    (BF16, 128, False, "cuda_core"),       # cp.async needs 16-byte bases
    (BF16, 96, True, "cuda_core"),         # no instantiation for 96
    (BF16, 32, True, "cuda_core"),
    (BF16, 256, True, "tensor_core"),      # gemma3_12b's head dim
    (BF16, 80, True, "tensor_core"),       # opt_2_7b's: 5 k steps of 16
    (F32, 128, True, "cuda_core"),         # f32 keeps the f32 kernel
    (F32, 64, True, "cuda_core"),
    (BF16, 80, False, "cuda_core"),
    (BF16, 72, True, "cuda_core"),         # no instantiation for 72
    (F32, 80, True, "cuda_core"),
])
def test_flash_route(dtype, hd, aligned, route):
    assert fa.flash_route(dtype, hd, aligned) == route


def test_flash_route_names_the_compiled_head_dims():
    assert fa.TC_HEAD_DIMS == (64, 80, 128, 256)
    assert [hd for hd in range(1, 513)
            if fa.flash_route(BF16, hd) == "tensor_core"] == [64, 80, 128,
                                                               256]


@pytest.mark.parametrize("dtype,d,aligned,route", [
    (BF16, 1024, True, "wgmma"),           # the offload's D
    (BF16, 72, True, "wgmma"),             # a ragged last slab of 64
    (BF16, 8, True, "wgmma"),
    (BF16, 1024, False, "cuda_core"),      # TMA needs 16-byte bases
    (BF16, 33, True, "cuda_core"),         # row stride not 16-byte aligned
    (BF16, 1, True, "cuda_core"),
    (BF16, 1020, True, "cuda_core"),
    (F32, 1024, True, "cuda_core"),        # f32 keeps the f32 kernel
    (F32, 64, True, "cuda_core"),
])
def test_knn_route(dtype, d, aligned, route):
    assert kknn.knn_route(dtype, d, aligned) == route


@pytest.mark.parametrize("dtype,hd,group,aligned,route", [
    (BF16, 128, 12, True, "tensor_core"),  # starcoder2_3b
    (BF16, 64, 1, True, "tensor_core"),
    (BF16, 128, 16, True, "tensor_core"),  # the mma's 16 rows, full
    (BF16, 128, 17, True, "cuda_core"),    # more heads than 16 rows
    (BF16, 128, 12, False, "cuda_core"),   # cp.async needs 16-byte bases
    (BF16, 96, 4, True, "cuda_core"),      # no instantiation for 96
    (BF16, 256, 2, True, "tensor_core"),   # gemma3_12b
    (BF16, 80, 1, True, "tensor_core"),    # opt_2_7b: MHA, 1 of 16 rows
    (F32, 128, 12, True, "cuda_core"),     # f32 keeps the CUDA-core split
    (BF16, 88, 1, True, "cuda_core"),      # no instantiation for 88
    (F32, 80, 1, True, "cuda_core"),
])
def test_decode_route(dtype, hd, group, aligned, route):
    assert fa.decode_route(dtype, hd, group, aligned) == route


def _p_and_v(seed, rows, kv, hd):
    """Softmax-like weights in [0, 1] and bf16 values, from numpy."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.random((rows, kv), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((kv, hd),
                                             dtype=np.float32)).to(BF16)
    return p, v


def _split(p):
    hi = p.to(BF16)
    lo = (p - hi.float()).to(BF16)
    return hi, lo


def test_p_split_keeps_sixteen_bits_of_each_weight():
    p, _ = _p_and_v(0, 64, 4096, 1)
    hi, lo = _split(p)
    split_err = ((hi.double() + lo.double()) - p.double()).abs()
    bf16_err = (hi.double() - p.double()).abs()
    rel = p.double()
    assert bool((split_err <= 2.0 ** -16 * rel).all())
    # a bf16-only P: up to a half unit of 8 significant bits (2^-8
    # relative), and on this draw past 2^-9
    assert bool((bf16_err <= 2.0 ** -8 * rel).all())
    assert bool((bf16_err > 2.0 ** -9 * rel).any())


@pytest.mark.parametrize("kv", [64, 512])
def test_p_split_product_is_far_closer_to_the_f32_weights(kv):
    """P V with the split (products of bf16 halves summed in f32) against
    the f32-P product in f64: at least 2^6 times closer than a bf16-only
    P V, the rounding SDPA does."""
    p, v = _p_and_v(1, 64, kv, 128)
    want = p.double() @ v.double()
    hi, lo = _split(p)
    split = hi.float() @ v.float() + lo.float() @ v.float()
    bf16_only = hi.float() @ v.float()
    split_err = (split.double() - want).abs().max().item()
    bf16_err = (bf16_only.double() - want).abs().max().item()
    assert split_err * 2 ** 6 <= bf16_err, (split_err, bf16_err)


def test_sass_compare_counts_changed_gone_and_new_functions(monkeypatch,
                                                            capsys):
    """`kernels/sass_compare.py` on two synthetic `cuobjdump -sass` dumps:
    the anonymous namespace's path hash is ignored, an unchanged body
    counts as identical, and a changed or missing function fails."""
    from repro_torch.kernels import sass_compare

    def dump(ns, bodies):
        return "".join(f"\n\t\tFunction : _ZN_GLOBAL__N__{ns}_8_a_cu_{name}\n"
                       f"        /*0000*/ {body} ;\n" for name, body in bodies)

    dumps = {"old.so": dump("0a1b", [("f", "HMMA"), ("g", "IADD")]),
             "new.so": dump("9f9f", [("f", "HMMA"), ("g", "IADD"),
                                     ("h", "FFMA")]),
             "bad.so": dump("9f9f", [("f", "FFMA")])}
    monkeypatch.setattr(sass_compare, "nvcc_path", lambda: "/x/bin/nvcc")
    monkeypatch.setattr(
        sass_compare.subprocess, "run",
        lambda cmd, **kw: type("P", (), {"stdout": dumps[cmd[-1]]})())
    assert sass_compare.main(["old.so", "new.so"]) == 0
    assert "identical in the new library 2, different 0, missing 0; new 1" \
        in capsys.readouterr().out
    assert sass_compare.main(["old.so", "bad.so"]) == 1
    out = capsys.readouterr().out
    assert "different 1, missing 1" in out and "DIFF" in out
