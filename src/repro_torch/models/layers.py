"""Model layers of the main path, ported from `repro/models/layers.py`:
norm, rotary embedding, the decode token's own attention partial, the
partial merge, and the gated MLP.

Conventions as in the reference: activations x (B, S, D) in the model
dtype; attention q (B, S, H, hd), k/v (B, S, KH, hd); softmax and norm
statistics in float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Split halves (not
    interleaved), computed in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs         # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def single_kv_partial(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial-softmax statistics of q against ONE new (k, v) token: the
    current decode token's own contribution, merged with the cache
    partials so the cache write can happen after the layer loop.
    q: (B,1,H,hd); k_new/v_new: (B,1,KH,hd).  Returns contiguous f32
    (acc (B,H,hd), m (B,H), l (B,H))."""
    b, _, h, hd = q.shape
    kh = k_new.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = (q[:, 0].float() * scale).reshape(b, kh, g, hd)
    kf = k_new[:, 0].float()                              # (B,KH,hd)
    s = torch.einsum("bkgd,bkd->bkg", qg, kf)             # (B,KH,G)
    acc = v_new[:, 0].float()[:, :, None, :].expand(b, kh, g, hd)
    # with a single key: m = s, p = exp(0) = 1, l = 1, acc = v
    return (acc.reshape(b, h, hd).contiguous(),
            s.reshape(b, h).contiguous(),
            torch.ones((b, h), dtype=torch.float32, device=q.device))


def merge_attention_partials(accs: torch.Tensor, ms: torch.Tensor,
                             ls: torch.Tensor) -> torch.Tensor:
    """Merge N partial-attention results: accs (N,B,H,hd), ms/ls (N,B,H)
    -> normalised (B,H,hd)."""
    m = ms.max(dim=0).values                              # (B,H)
    alpha = torch.exp(ms - m[None])                       # (N,B,H)
    l = (ls * alpha).sum(dim=0)
    acc = (accs * alpha[..., None]).sum(dim=0)
    return acc / torch.clamp(l, min=1e-20)[..., None]


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
