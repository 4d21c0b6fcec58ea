"""Hopper CUDA KNN squared-L2 distances and their wrapper.

The kernel lives in `csrc/knn.cu` (its source note names the Pallas
kernel of `repro/kernels/knn.py` it replaces and what bounds it on an
H100).  `build.py` compiles it with the port's other kernels at first use
and binds it with `ctypes`; nothing is built when this module is imported.

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its output with `torch.empty`, launches on
`torch.cuda.current_stream()` and raises if the launch fails.  It never
falls back to the plain PyTorch version: `ops.knn_distances` dispatches
CPU tensors there before the wrapper is reached.  Each launch adds one to
`build.LAUNCHES["knn_distances"]`, and one to
`build.LAUNCHES["knn_distances_wgmma"]` when it took the tensor-core
kernel.

Two kernels: `knn_wgmma_kernel` (TMA and wgmma) takes bf16 with D % 8 == 0
and 16-byte-aligned bases, `knn_kernel` on the CUDA cores takes the rest.
`knn_route` is that rule, a dispatch on what each kernel takes: a refused
launch of either still raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import (DTYPE_CODE, LAUNCHES, check,
                                       check_inputs, function, raise_on,
                                       stream)

# the kernel takes its sizes as C ints; its grid has one block per 64 x 64
# output tile, the query tiles on the y axis (at most 65535 of them)
MAX_QUERIES = 65535 * 64
MAX_INT = 2 ** 31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _I, _I, _I, _P]


def knn_route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The distance kernel that takes these inputs: "wgmma" for bf16 with
    D a multiple of 8 (TMA wants a row stride of a multiple of 16 bytes)
    and 16-byte-aligned queries and db (`aligned`), else "cuda_core"."""
    if dtype == torch.bfloat16 and d % 8 == 0 and aligned:
        return "wgmma"
    return "cuda_core"


def check_args(queries: torch.Tensor, db: torch.Tensor
               ) -> Tuple[int, int, int]:
    """Everything the kernel asks of its inputs apart from the device:
    shapes, dtypes, contiguity, one device.  Returns (Q, N, D)."""
    name = "knn_distances"
    check(queries.dim() == 2 and db.dim() == 2,
          f"{name}: queries (Q,D) and db (N,D) expected, got "
          f"{tuple(queries.shape)} and {tuple(db.shape)}")
    (nq, d), n = queries.shape, db.shape[0]
    check(db.shape[1] == d,
          f"{name}: queries have D={d}, db rows D={db.shape[1]}")
    check(nq >= 1 and n >= 1 and d >= 1,
          f"{name}: empty input: Q={nq} N={n} D={d}")
    check(nq <= MAX_QUERIES and max(n, d) <= MAX_INT,
          f"{name}: Q={nq} N={n} D={d} past the kernel's grid")
    check(queries.dtype in DTYPE_CODE,
          f"{name}: dtype {queries.dtype} not supported (float32 or "
          "bfloat16)")
    check(db.dtype == queries.dtype,
          f"{name}: queries and db must share one dtype")
    check(queries.is_contiguous() and db.is_contiguous(),
          f"{name}: inputs must be contiguous")
    check(queries.device == db.device, f"{name}: inputs must be on one device")
    return nq, n, d


def knn_distances(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances on the card, as `ref.knn_distances_reference`
    computes them: queries (Q,D) and db (N,D), both f32 or both bf16, any
    Q, N, D.  Returns (Q,N) float32."""
    name = "knn_distances"
    check_inputs(name, queries, db)
    nq, n, d = check_args(queries, db)
    out = torch.empty((nq, n), dtype=torch.float32, device=queries.device)
    qp, xp = queries.data_ptr(), db.data_ptr()
    args = (qp, xp, out.data_ptr(), nq, n, d, stream())
    wgmma = knn_route(queries.dtype, d, (qp | xp) % 16 == 0) == "wgmma"
    if wgmma:
        err = function("rt_knn_distances_wgmma", _SIGNATURE[1:])(*args)
    else:
        err = function("rt_knn_distances", _SIGNATURE)(
            DTYPE_CODE[queries.dtype], *args)
    raise_on(err, name)
    LAUNCHES[name] += 1
    if wgmma:
        LAUNCHES["knn_distances_wgmma"] += 1
    return out


def knn_topk(queries: torch.Tensor, db: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The port of the reference's `knn.knn_topk`: the distance kernel
    (`knn_distances`), then the k smallest of each row on the device
    (`ref.smallest_k`: nearest first, ties lowest id first, as
    `jax.lax.top_k(-d, k)`).  Returns (dists (Q,k) f32, ids (Q,k)
    int64)."""
    return _ref.smallest_k(knn_distances(queries, db), k)
