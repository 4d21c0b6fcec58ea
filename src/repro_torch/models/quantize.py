"""Weight quantization over a parameter tree, the port of
`repro/models/quantize.py`.

`quantize_params` rewrites every dense projection stack (a rank-3
(n_blocks, d, n) leaf named below) into a block-quantized `QTensor`.
Embeddings (tied to the logits head), norms, conv filters and the SSM's
small B / C / dt projections stay fp, as in the reference.

`matmul` is the dispatch point the model layers call instead of `@`: a
QTensor goes through `ops.quant_matmul` (the dequant-fused kernel on the
card), a tensor through the ordinary product.

cuBLAS picks its GEMM kernel (tiles, split-K) by the row count, and
torch's row reductions their split, so on an H100 one row can take other
bits at m = 4 than at m = 16 (the bf16 3072 -> 256 and 12288 -> 3072
products of starcoder2_3b do).  Inside `padded_rows(n)` every fp product
and norm over fewer than n rows runs padded with zero rows to n
(`invariant_rows`): the speculative segment runs its draft steps so, at
the verify's row count, and a draft of the target's own blocks then
computes the verify's bits; a server under a data split runs its
segments so, at the whole batch's row count, and each data group's rows
then take the single device's bits.  A nested `padded_rows` keeps the
larger count.  Outside them nothing is padded.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.quant import QTensor, WEIGHT_FORMATS, quantize_tensor

QUANT_WEIGHT_NAMES = frozenset({
    "wq", "wk", "wv", "wo",              # attention projections
    "w_gate", "w_up", "w_down",          # dense gated MLP
    "w_z", "w_x", "out_proj",            # mamba in/out projections
})


def quantize_params(params: Any, fmt: str) -> Any:
    """A copy of the tree with every eligible leaf quantized into `fmt`
    ("q8_0" | "q4_k"): matched by its innermost dict key and rank 3.  The
    other leaves are the same tensors; the fp stacks that were quantized
    are no longer referenced by the copy."""
    if fmt not in WEIGHT_FORMATS:
        raise ValueError(f"unknown quant format: {fmt}")

    def walk(tree: Any, name: str) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, name) for v in tree]
        if name in QUANT_WEIGHT_NAMES and tree.dim() == 3:
            return quantize_tensor(tree, fmt)
        return tree

    return walk(params, "")


_PAD_ROWS: contextvars.ContextVar[int] = contextvars.ContextVar(
    "pad_rows", default=0)


@contextlib.contextmanager
def padded_rows(n: int) -> Iterator[None]:
    """Run every fp product and norm of fewer than n rows padded to n (or
    to an enclosing `padded_rows`' count, when that is larger)."""
    token = _PAD_ROWS.set(max(n, _PAD_ROWS.get()))
    try:
        yield
    finally:
        _PAD_ROWS.reset(token)


def invariant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x (..., d) as (rows, d), padded with zero rows to the `padded_rows`
    count when it has fewer, and its own row count: the result's first
    `rows` rows are x's."""
    rows, pad = x.numel() // x.shape[-1], _PAD_ROWS.get()
    x2 = x.reshape(rows, x.shape[-1])
    if rows < pad:
        x2 = F.pad(x2, (0, 0, 0, pad - rows))
    return x2, rows


def matmul(x: torch.Tensor, w: Union[torch.Tensor, QTensor]) -> torch.Tensor:
    """`x @ w`, with a QTensor through the dequant-fused matmul (whose
    plan does not depend on the row count) and a tensor product over
    `invariant_rows`."""
    if isinstance(w, QTensor):
        return ops.quant_matmul(x, w)
    x2, rows = invariant_rows(x)
    return (x2 @ w)[:rows].reshape(x.shape[:-1] + (w.shape[-1],))
