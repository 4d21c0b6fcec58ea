"""Parity of the port's KNN distances and top-k (`repro_torch.kernels`)
with the JAX package, on the CPU: the plain version
`ref.knn_distances_reference` against the Pallas kernel run in interpret
mode and against JAX's `ref.knn_distances_reference`, on the same numpy
inputs, and `ops.knn_topk` and the plain `ref.knn_topk_reference`
against JAX's `ref.knn_topk_reference`
(`jax.lax.top_k`), ties included.  The CUDA kernel itself is held to the
plain version on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances, those of tests/test_kernels.py for the Pallas kernel: atol =
tol * D, rtol = tol, with tol = 1e-4 in float32 and 5e-2 in bfloat16 —
the two frameworks sum the D products of q.x in another order.  Top-k
ids are compared exactly: on data whose distances are exact in f32
(small integers) the two packages compute equal distances, so any
difference is a different order of ties.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as jops                         # noqa: E402
from repro.kernels import ref as jref                         # noqa: E402
from repro_torch.kernels import build as kbuild               # noqa: E402
from repro_torch.kernels import knn as kknn                   # noqa: E402
from repro_torch.kernels import ops, ref                      # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def _inputs(q, n, d, dtype, seed):
    """Queries and db ~ N(0,1) from numpy, as a torch pair and the JAX
    pair with the same bits (bf16 rounded once, in torch)."""
    rng = np.random.default_rng(seed)
    tq = torch.from_numpy(rng.standard_normal((q, d)).astype(np.float32))
    tx = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    tdt, jdt, _ = DTYPES[dtype]
    tq, tx = tq.to(tdt), tx.to(tdt)
    return (tq, tx), tuple(jnp.asarray(t.float().numpy()).astype(jdt)
                           for t in (tq, tx))


def _close(got, want, d, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol * d, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q,n,d", [(128, 256, 64), (64, 128, 512),
                                   (128, 128, 32)])
def test_knn_distances_reference_matches_pallas_kernel_interpret(q, n, d,
                                                                 dtype):
    (tq, tx), (jq, jx) = _inputs(q, n, d, dtype, seed=q + n + d)
    got = ref.knn_distances_reference(tq, tx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, n)
    want = jops.knn_distances(jq, jx, blk_q=64, blk_n=64, interpret=True)
    _close(got, want, d, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q,n,d", [(128, 256, 64), (64, 128, 512),
                                   (40, 200, 33)])
def test_knn_distances_reference_matches_jax_oracle(q, n, d, dtype):
    """Also at a ragged N and D, which the Pallas kernel does not take."""
    (tq, tx), (jq, jx) = _inputs(q, n, d, dtype, seed=q * n + d)
    _close(ops.knn_distances(tq, tx), jref.knn_distances_reference(jq, jx),
           d, DTYPES[dtype][2])


TOPK = {"ops": lambda q, x, k: ops.knn_topk(q, x, k),
        "ref": lambda q, x, k: ref.knn_topk_reference(q, x, k)}


@pytest.mark.parametrize("topk", list(TOPK))
def test_knn_topk_ids_match_jax_oracle(topk):
    (tq, tx), (jq, jx) = _inputs(64, 256, 128, "f32", seed=6)
    dist, ids = TOPK[topk](tq, tx, 8)
    dist_j, ids_j = jref.knn_topk_reference(jq, jx, 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j),
                               atol=1e-4 * 128, rtol=1e-4)
    assert bool((dist[:, 1:] >= dist[:, :-1]).all())


@pytest.mark.parametrize("topk", list(TOPK))
@pytest.mark.parametrize("k", [1, 3, 4, 8])
def test_knn_topk_ties_go_lowest_index_first(k, topk):
    """Every db row appears 3 times (rows j, j + 10, j + 20) and the data
    are small integers, so distances are exact and tie in threes; k = 4
    and 8 cut through a tie (the k-th and (k+1)-th are equal)."""
    rng = np.random.default_rng(11)
    base = rng.integers(-3, 4, (10, 16)).astype(np.float32)
    db = np.concatenate([base, base, base])
    qs = rng.integers(-3, 4, (12, 16)).astype(np.float32)
    dist, ids = TOPK[topk](torch.from_numpy(qs), torch.from_numpy(db), k)
    dist_j, ids_j = jref.knn_topk_reference(jnp.asarray(qs), jnp.asarray(db),
                                            k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(dist_j))


def test_smallest_k_orders_by_value_then_column():
    d = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0, 0.0, -0.0, -5.0]])
    vals, cols = ref.smallest_k(d, 6)
    neg, cols_j = jax.lax.top_k(jnp.asarray(-d.numpy()), 6)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(cols_j))
    np.testing.assert_array_equal(cols.numpy(), [[7, 6, 5, 1, 2, 4]])
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_ops_sends_cpu_tensors_to_the_plain_version():
    (tq, tx), _ = _inputs(8, 16, 4, "f32", seed=0)
    before = dict(kbuild.LAUNCHES)
    torch.testing.assert_close(ops.knn_distances(tq, tx),
                               ref.knn_distances_reference(tq, tx),
                               rtol=0, atol=0)
    ops.knn_topk(tq, tx, 3)
    assert kbuild.LAUNCHES == before


def test_cuda_wrapper_refuses_cpu_tensors():
    (tq, tx), _ = _inputs(8, 16, 4, "f32", seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        kknn.knn_distances(tq, tx)


def _refusals():
    f = torch.zeros((4, 8))
    return {
        "1-d queries": (torch.zeros(8), f),
        "D differs": (f, torch.zeros((5, 7))),
        "empty db": (f, torch.zeros((0, 8))),
        "int dtype": (f.int(), f.int()),
        "dtypes differ": (f, f.to(torch.bfloat16)),
        "not contiguous": (f, torch.zeros((8, 5)).T),
        "too many queries": (torch.empty((kknn.MAX_QUERIES + 1, 1),
                                         device="meta"),
                             torch.empty((1, 1), device="meta")),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_knn_check_args_refuses(case):
    queries, db = _refusals()[case]
    with pytest.raises(ValueError):
        kknn.check_args(queries, db)


def test_knn_check_args_takes_ragged_shapes():
    assert kknn.check_args(torch.zeros((3, 33)),
                           torch.zeros((1001, 33))) == (3, 1001, 33)
