"""The weight bridge: JAX parameter and cache pytrees, handed over as numpy
arrays, become the port's tensors; and the way back, the port's trees
(parameters, optimizer state, gradients) as numpy arrays.

The tests call it; nothing on the card does (that machine has no JAX).
bf16 crosses as raw 16-bit words, so no bf16 numpy type is needed here:
`arr.view(np.uint16)` on this side, `.view(torch.bfloat16)` on the other;
on the way back a bf16 tensor widens to f32, which is exact.
The layout stays the reference's: `embed`, `final_ln`, and
`blocks[i]["attn"|"ffn"][name]` stacked over n_blocks; an encoder-decoder's
`enc_blocks` / `dec_blocks` the same way, its `cross` one dict of stacks,
and `enc_final_ln`.  A quantized tree's
leaves (the reference's `QTensor`, its arrays mapped to numpy) become the
port's `QTensor`, recognised by their attributes.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.kernels.quant import QTensor
from repro_torch.tree import map_leaves


def tensor_from_numpy(arr: np.ndarray,
                      device: Union[str, torch.device]) -> torch.Tensor:
    """One array; bf16 (the ml_dtypes type JAX hands out) by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _is_qtensor(leaf: Any) -> bool:
    return all(hasattr(leaf, a)
               for a in ("scales", "quants", "mins", "fmt", "d_in"))


def tree_from_numpy(tree: Any, device: Union[str, torch.device]) -> Any:
    """A nested dict / tuple / list of arrays; tuples become lists (the
    reference's `blocks` tuple is the port's list), quantized leaves the
    port's `QTensor`."""
    if _is_qtensor(tree):
        return QTensor(
            tensor_from_numpy(tree.scales, device),
            tensor_from_numpy(tree.quants, device),
            None if tree.mins is None else tensor_from_numpy(tree.mins,
                                                             device),
            str(tree.fmt), int(tree.d_in))
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [tree_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def params_from_jax(np_params: Dict[str, Any],
                    device: Union[str, torch.device]) -> Dict[str, Any]:
    """`repro.models.transformer.init_params` or `repro.models.encdec.
    init_params` output, as numpy arrays."""
    return tree_from_numpy(np_params, device)


def cache_from_jax(np_cache: Dict[str, Any],
                   device: Union[str, torch.device]) -> Dict[str, Any]:
    """`repro.models.transformer.init_cache` output (pos, k*/v* panels,
    page_table; int8 pools with their kscale*/vscale* leaves), or
    `repro.models.encdec.init_cache`'s (those plus the 5-dim cross_k /
    cross_v panels and the (B,) enc_pos clock), as numpy arrays."""
    return {k: tensor_from_numpy(v, device) for k, v in np_cache.items()}


def tensor_to_numpy(x: torch.Tensor) -> np.ndarray:
    """One tensor as a host numpy array; bf16 widened to f32 (exact)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


def tree_to_numpy(params: Any) -> Any:
    """The port's tree of tensors (dicts, lists, tuples and NamedTuples
    such as `adamw.OptState`, None kept) as the same structure of numpy
    arrays, so the tests can hold it against a JAX tree leaf by leaf."""
    return map_leaves(tensor_to_numpy, params)
