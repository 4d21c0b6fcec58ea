"""Int8 error-feedback gradient compression, the port of
`repro/optim/compression.py`.

Per-tensor symmetric int8 quantization with an error-feedback residual:
the quantization error of step t is added back to the gradient of step
t + 1, so the compression bias telescopes away (Karimireddy et al.,
2019).  On one device it models the numerics of a compressed all-reduce
exactly; `compressed_bytes` counts its wire bytes (an int8 payload and
one f32 scale a tensor).  On a training mesh each gradient and residual
leaf is the rank's shard (`specs=`): a tensor's scale is its GLOBAL max
|g + r| (one all-reduce max over the mesh for every leaf), and the bytes
count the global tree.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree


class CompressionState(NamedTuple):
    residual: Any        # f32 tree like the grads (the error feedback)


def init(params: Any) -> CompressionState:
    return CompressionState(residual=tree.map_leaves(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32) -> (int8 payload, f32 scale): scale = max|x| / 127 + 1e-12
    (`amax`: that max, when x is a shard of the tensor), the payload
    round(x / scale) clipped to [-127, 127], half to even (`torch.round`,
    as `jnp.round`)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads: Any, state: CompressionState, specs: Any = None
                   ) -> Tuple[Any, CompressionState]:
    """Quantize (grad + residual) to int8 and return what the optimizer
    sees, the dequantized f32 gradient, and the state with the new
    residual (grad + residual - dequantized), written in place.
    `specs`: the leaves are a mesh rank's shards; each scale comes from
    the tensor's global max."""
    residuals = tree.leaves(state.residual)
    for g, r in zip(tree.leaves(grads), residuals):
        r.add_(g.float())                     # g + r, the same f32 sum
    amax = [None] * len(residuals)
    if specs is not None:
        from repro_torch.core import collectives as C
        amax = C.all_reduce_max(torch.stack(
            [torch.max(torch.abs(r)) for r in residuals])).unbind(0)
    deq = []
    for r, m in zip(residuals, amax):
        q, scale = quantize(r, m)
        d = q.float() * scale
        r.sub_(d)
        deq.append(d)
    return tree.unflatten(grads, deq), state


def compressed_bytes(grads: Any, specs: Any = None) -> int:
    """Wire bytes of the int8-compressed gradient (payload + scales) of
    the global tree: with `specs`, each leaf a shard of a tensor that
    many times its size."""
    if specs is None:
        return sum(g.numel() + 4 for g in tree.leaves(grads))
    from repro_torch.core import collectives as C
    return sum(g.numel() * C.shards(sp) + 4
               for g, sp in zip(tree.leaves(grads), tree.leaves(specs)))
