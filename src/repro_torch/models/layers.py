"""Model layers of the ported serve paths, from `repro/models/layers.py`:
norm, rotary embedding (and Qwen2-VL's multimodal M-RoPE), the decode
token's own attention partial, the partial merge, the gated MLP, and the
Mamba2 single-token SSD step and causal depthwise conv (plain XLA in the
reference, plain torch here).

Conventions as in the reference: activations x (B, S, D) in the model
dtype; attention q (B, S, H, hd), k/v (B, S, KH, hd); softmax and norm
statistics in float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.quantize import invariant_rows, matmul


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The mean square runs over `quantize.invariant_rows`."""
    xf = x.float()
    x2, rows = invariant_rows(xf)
    var = x2.square().mean(dim=-1, keepdim=True)[:rows]
    var = var.reshape(x.shape[:-1] + (1,))
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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal rotary: x (B, S, H, hd); positions3 (B, S, 3) =
    (t, h, w) indices.  The hd/2 frequency bands are partitioned into
    `sections` (t/h/w): each band rotates by the position of its own
    stream, selected by a one-hot product in float32 (exact), with the
    angles and the rotation in float32 and the output in x's dtype.  The
    band map is built with device ops only, so the decode can run inside a
    captured CUDA graph."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    band = torch.arange(hd // 2, device=x.device)
    sec_ids = ((band >= sections[0]).long()
               + (band >= sections[0] + sections[1]).long())   # {0,1,2}
    # select, per frequency band, which of the three position streams
    # applies
    sel = F.one_hot(sec_ids, 3).float()                  # (hd/2, 3)
    pos = torch.einsum("bst,ht->bsh", positions3.float(), sel)
    angles = pos * freqs                                  # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def default_mrope_positions(batch: int, seq: int,
                            device: Optional[torch.device] = None
                            ) -> torch.Tensor:
    """Stub 3D positions for the VLM backbone: text tokens use (i, i, i) as
    in Qwen2-VL; a vision frontend would supply real (t, h, w).  Returns
    (batch, seq, 3) int32."""
    i = torch.arange(seq, dtype=torch.int32, device=device)
    return i[None, :, None].expand(batch, seq, 3)


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


def gated_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """silu(x w_gate) * (x w_up) projected by w_down; each weight a tensor
    or a `QTensor` (through the dequant-fused matmul)."""
    h = F.silu(matmul(x, w_gate)) * matmul(x, w_up)
    return matmul(h, w_down)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update.  state: (b,h,p,n) f32; x: (b,h,p);
    dt: (b,h); B, C: (b,n).  Returns (y (b,h,p) in x's dtype, new_state
    f32)."""
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                       # (b,h)
    xB = torch.einsum("bhp,bn->bhpn", x.float(), B.float())
    new_state = state * dA[..., None, None] + dtf[..., None, None] * xB
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    return y.to(x.dtype), new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv with silu: x (b,s,c), w (width,c), state
    (b,width-1,c) the inputs before x (zeros when None).  Accumulates in
    f32.  Returns (y (b,s,c) in x's dtype, new state = the last width-1
    inputs).  y is contiguous."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                     # (b,s+w-1,c)
    idx = (torch.arange(x.shape[1], device=x.device)[:, None]
           + torch.arange(width, device=x.device)[None, :])
    windows = xp[:, idx]                                  # (b,s,w,c)
    y = torch.einsum("bswc,wc->bsc", windows.float(), w.float())
    # einsum may hand back a (b, c, s)-major layout; the SSD kernel reads
    # y as (b, s, h, p) rows
    return F.silu(y).to(x.dtype).contiguous(), xp[:, -(width - 1):]
