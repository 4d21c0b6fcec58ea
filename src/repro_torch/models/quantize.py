"""Weight quantization over a parameter tree, the port of
`repro/models/quantize.py`.

`quantize_params` rewrites every dense projection stack (a rank-3
(n_blocks, d, n) leaf named below) into a block-quantized `QTensor`.
Embeddings (tied to the logits head), norms, conv filters and the SSM's
small B / C / dt projections stay fp, as in the reference.

`matmul` is the dispatch point the model layers call instead of `@`: a
QTensor goes through `ops.quant_matmul` (the dequant-fused kernel on the
card), a tensor through the ordinary product.
"""
from __future__ import annotations

from typing import Any, Union

import torch

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


def matmul(x: torch.Tensor, w: Union[torch.Tensor, QTensor]) -> torch.Tensor:
    """`x @ w`, with a QTensor through the dequant-fused matmul."""
    if isinstance(w, QTensor):
        return ops.quant_matmul(x, w)
    return x @ w
