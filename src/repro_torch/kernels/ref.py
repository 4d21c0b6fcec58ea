"""Plain PyTorch versions of the port's kernels, mirroring
`repro/kernels/ref.py`: the attention kernels (without the int8
`kv_scales` branch, which waits for the quantization slice) and the
Mamba2 SSD scan.

They are the numerical ground truth the CUDA kernels are held to on the
card, and the path `ops.py` takes for tensors on the CPU.  All arithmetic
is in float32; outputs return to the input dtype where the JAX oracle's
do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention with GQA.  q: (B,S,H,hd); k,v: (B,S,KH,hd).
    window > 0 => sliding-window causal attention.  Returns (B,S,H,hd)."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    assert h % kh == 0
    group = h // kh
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def decode_partial_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor) -> Partial:
    """Partial-softmax decode attention over one KV chunk.
    q: (B,1,H,hd); k,v: (B,KH,C,hd); valid: (B,C) bool.
    Returns f32 (acc (B,H,hd), m (B,H), l (B,H)); m = -inf for an empty
    row."""
    b, _, h, hd = q.shape
    kh = k.shape[1]
    group = h // kh
    scale = hd ** -0.5
    qf = q[:, 0].float() * scale                          # (B,H,hd)
    kf = k.float().repeat_interleave(group, dim=1).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=1).transpose(1, 2)
    logits = torch.einsum("bhd,bchd->bhc", qf, kf)
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    m = logits.max(dim=-1).values                         # (B,H)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(valid[:, None, :], p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhc,bchd->bhd", p, vf)
    m = torch.where(finite, m, torch.full_like(m, float("-inf")))
    return acc, m, l


def gather_kv_pages(kv: torch.Tensor, pages: torch.Tensor,
                    page_size: int) -> torch.Tensor:
    """Gather a paged KV panel into LOGICAL page order.  kv: (B,KH,S_phys,
    hd), a pool of S_phys // page_size pages per row; pages: (B, n_log)
    page table.  Returns the dense logical view (B,KH,n_log*page_size,hd).
    Once gathered, the dense computation gives the paged result bit for
    bit, for any physical placement."""
    b, kh, s_phys, hd = kv.shape
    assert s_phys % page_size == 0, (s_phys, page_size)
    n_log = pages.shape[1]
    kvr = kv.reshape(b, kh, s_phys // page_size, page_size, hd)
    idx = pages.long()[:, None, :, None, None].expand(
        b, kh, n_log, page_size, hd)
    return torch.gather(kvr, 2, idx).reshape(b, kh, n_log * page_size, hd)


def merge_fused_partial_pair(acc: torch.Tensor, m: torch.Tensor,
                             l: torch.Tensor, acc_e: torch.Tensor,
                             m_e: torch.Tensor, l_e: torch.Tensor) -> Partial:
    """The fused kernel's two-way partial-softmax merge epilogue, with the
    reference's guards: a partial whose m is -inf contributes nothing."""
    mm = torch.maximum(m, m_e)
    mm_fin = torch.isfinite(mm)
    mm_safe = torch.where(mm_fin, mm, torch.zeros_like(mm))
    zero = torch.zeros_like(mm)
    a1 = torch.where(torch.isfinite(m), torch.exp(m - mm_safe), zero)
    a2 = torch.where(torch.isfinite(m_e), torch.exp(m_e - mm_safe), zero)
    acc = acc * a1[..., None] + acc_e.float() * a2[..., None]
    l = l * a1 + l_e * a2
    return acc, torch.where(mm_fin, mm, torch.full_like(mm, float("-inf"))), l


def normalize_fused_partial(acc: torch.Tensor, l: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """Final normalisation of merged decode partials: acc (B,H,hd), l (B,H)
    -> (B,1,H,hd) in `dtype`."""
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out[:, None].to(dtype)


def decode_valid_mask(pos_b: torch.Tensor, s: int,
                      window: int) -> torch.Tensor:
    """(B,S) bool mask of attended cache slots: pos-window < slot <= pos."""
    slots = torch.arange(s, device=pos_b.device)
    valid = slots[None, :] <= pos_b[:, None]
    if window > 0:
        valid &= slots[None, :] > (pos_b - window)[:, None]
    return valid


def decode_fused_partial_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        pos: torch.Tensor, extra: Optional[Partial] = None, *,
        window: int = 0, pages: Optional[torch.Tensor] = None,
        page_size: int = 0) -> Partial:
    """`decode_fused_reference` minus the final normalisation: the raw
    merged statistics (acc (B,H,hd), m (B,H), l (B,H))."""
    if pages is not None:
        assert page_size > 0, "page_size required with pages"
        k = gather_kv_pages(k, pages, page_size)
        v = gather_kv_pages(v, pages, page_size)
    b = q.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=q.device).reshape(-1).expand(b)
    valid = decode_valid_mask(pos_b, k.shape[2], window)
    acc, m, l = decode_partial_reference(q, k, v, valid)
    if extra is not None:
        acc, m, l = merge_fused_partial_pair(acc, m, l, *extra)
    return acc, m, l


def decode_fused_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, extra: Optional[Partial] = None,
                           *, window: int = 0,
                           pages: Optional[torch.Tensor] = None,
                           page_size: int = 0) -> torch.Tensor:
    """Plain version of the fused one-shot flash decode.  q: (B,1,H,hd);
    k,v: (B,KH,S,hd) (physical pools when `pages` is given); pos: (B,) or
    scalar last valid logical slot; `extra` merged before normalisation.
    Returns (B,1,H,hd) in q's dtype."""
    acc, _, l = decode_fused_partial_reference(
        q, k, v, pos, extra, window=window, pages=pages, page_size=page_size)
    return normalize_fused_partial(acc, l, q.dtype)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential (not chunked) SSD recurrence, the exact oracle:
        state_t = exp(dt_t A) state_{t-1} + (dt_t x_t) B_t^T
        y_t = state_t C_t
    x: (b,s,h,p); dt: (b,s,h) f32; A: (h,) f32; B, C: (b,s,n), shared by
    every head; init_state: optional (b,h,p,n) (zeros when None).  One
    step of the loop covers every (b, h) at once.  Returns (y (b,s,h,p)
    in x's dtype, final_state (b,h,p,n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    decay = torch.exp(dtf * A.float())                    # (b,s,h)
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           Bf[:, t])
        state = state * decay[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state
