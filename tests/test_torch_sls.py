"""Parity of the port's SparseLengthsSum (`repro_torch.kernels`) with the
JAX package, on the CPU: the plain version `ref.sls_reference` against
the Pallas kernel run in interpret mode on padded bags, and against JAX's
`ref.sls_reference` on unpadded bags, on the same numpy inputs.  The CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Padding: the Pallas kernel masks the index -1 (its docstring: "-1 =
pad"), while JAX's `ref.sls_reference` takes rows with `jnp.take`, which
wraps -1 to the table's last row.  The port follows the kernel, so the
reference oracle is used only on bags without padding, and one test
states the difference.  An index >= V adds nothing in the port either
(the kernel never reads outside the table); the reference leaves it
undefined (nan from `jnp.take`, the last row from the kernel in
interpret mode).

Tolerance: atol = 1e-5 * L, rtol = 1e-5, for a float32 and a bfloat16
table alike.  A bfloat16 row widens to float32 exactly and both sides add
the slots in the same order in float32, so they differ only where XLA
fuses acc + row * w into one rounding (about 1 ulp of the sum);
unweighted and unpadded bags agree bitwise.  Padded slots add exactly
nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as jops                         # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro_torch.kernels import build as kbuild               # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402
from repro_torch.kernels import sls as ksls                   # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 1e-5)}


def _bags(v, d, b, l, dtype, seed, padded):
    """A table ~ N(0,1), uniform indices and weights in [0, 1); padded
    bags have lengths uniform in 1..l, the rest -1.  Returns the torch
    (table, idx, w) and the JAX triple with the same bits."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    if padded:
        lengths = rng.integers(1, l + 1, b)
        idx[np.arange(l)[None, :] >= lengths[:, None]] = -1
    w = rng.random((b, l)).astype(np.float32)
    tdt, jdt, _ = DTYPES[dtype]
    table = table.to(tdt)
    jtable = jnp.asarray(table.float().numpy()).astype(jdt)
    return ((table, torch.from_numpy(idx), torch.from_numpy(w)),
            (jtable, jnp.asarray(idx), jnp.asarray(w)))


def _close(got, want, l, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol * l, rtol=tol)


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "no_w"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("v,d,b,l", [(512, 64, 16, 8), (1024, 128, 8, 32)])
def test_sls_reference_matches_pallas_kernel_interpret_padded(v, d, b, l,
                                                              dtype,
                                                              weighted):
    (table, idx, w), (jt, ji, jw) = _bags(v, d, b, l, dtype, seed=v + l,
                                          padded=True)
    assert bool((idx == -1).any())
    got = ref.sls_reference(table, idx, w if weighted else None)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, d)
    want = jops.sls(jt, ji, jw if weighted else None, blk_b=8,
                    interpret=True)
    _close(got, want, l, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("v,d,b,l", [(512, 64, 16, 8), (1024, 128, 8, 32),
                                     (300, 37, 5, 3)])
def test_sls_reference_matches_jax_oracle_unpadded(v, d, b, l, dtype):
    (table, idx, w), (jt, ji, jw) = _bags(v, d, b, l, dtype, seed=d,
                                          padded=False)
    for weights, jweights in ((w, jw), (None, None)):
        _close(ops.sls(table, idx, weights),
               jref.sls_reference(jt, ji, jweights), l, DTYPES[dtype][2])


def test_reference_wraps_padding_where_the_kernel_masks_it():
    """Why the port follows the Pallas kernel: on the same padded bags
    the JAX oracle adds the table's last row for every -1."""
    table = np.arange(128, dtype=np.float32).reshape(32, 4)
    idx = np.array([[0, 1, -1, -1], [2, -1, -1, -1]], np.int32)
    kernel = np.asarray(jops.sls(jnp.asarray(table), jnp.asarray(idx), None,
                                 blk_b=2, interpret=True))
    oracle = np.asarray(jref.sls_reference(jnp.asarray(table),
                                           jnp.asarray(idx)))
    np.testing.assert_array_equal(kernel, [[4, 6, 8, 10], [8, 9, 10, 11]])
    np.testing.assert_array_equal(oracle, [[252, 256, 260, 264],
                                           [380, 384, 388, 392]])
    port = ref.sls_reference(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(port.numpy(), kernel)


def test_sls_index_outside_the_table_adds_nothing():
    table = torch.arange(128, dtype=torch.float32).reshape(32, 4)
    idx = torch.tensor([[0, 32, 1, 10 ** 6], [-5, 2, -1, 31]],
                       dtype=torch.int32)
    w = torch.full((2, 4), 0.5)
    want = torch.stack([(table[0] + table[1]) * 0.5,
                        (table[2] + table[31]) * 0.5])
    torch.testing.assert_close(ops.sls(table, idx, w), want, rtol=0, atol=0)


def test_sls_walks_each_bag_in_slot_order():
    """acc + row * w, one slot after the other, rounded in f32 at each
    step: 1e8 + 1 - 1e8 gives 0 in that order."""
    table = torch.tensor([[1e8], [1.0], [-1e8]])
    idx = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    assert ops.sls(table, idx).item() == 0.0


def test_ops_sends_cpu_tensors_to_the_plain_version():
    (table, idx, w), _ = _bags(64, 8, 4, 5, "f32", seed=0, padded=True)
    before = dict(kbuild.LAUNCHES)
    torch.testing.assert_close(ops.sls(table, idx, w),
                               ref.sls_reference(table, idx, w),
                               rtol=0, atol=0)
    assert kbuild.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    (table, idx, w), _ = _bags(64, 8, 4, 5, "f32", seed=0, padded=True)
    with pytest.raises(ValueError, match="CUDA"):
        ksls.sls(table, idx, w)


def _refusals():
    t, i = torch.zeros((16, 8)), torch.zeros((3, 5), dtype=torch.int32)
    return {
        "1-d table": (torch.zeros(16), i, None),
        "1-d indices": (t, torch.zeros(5, dtype=torch.int32), None),
        "int64 indices": (t, i.long(), None),
        "int table": (t.int(), i, None),
        "empty bags": (t, torch.zeros((0, 5), dtype=torch.int32), None),
        "weights shape": (t, i, torch.zeros((3, 4))),
        "weights dtype": (t, i, torch.zeros((3, 5), dtype=torch.bfloat16)),
        "indices not contiguous": (t, torch.zeros((5, 3),
                                                  dtype=torch.int32).T, None),
        "too wide": (torch.empty((1, ksls.MAX_D + 1), device="meta"), i,
                     None),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_sls_check_args_refuses(case):
    table, idx, w = _refusals()[case]
    with pytest.raises(ValueError):
        ksls.check_args(table, idx, w)


def test_sls_check_args_takes_any_bag_count():
    assert ksls.check_args(torch.zeros((10, 300), dtype=torch.bfloat16),
                           torch.zeros((13, 7), dtype=torch.int32),
                           torch.zeros((13, 7))) == (13, 7, 10, 300)
