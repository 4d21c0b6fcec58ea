"""Plain PyTorch versions of the port's kernels, mirroring
`repro/kernels/ref.py`: the attention kernels (with the int8 `kv_scales`
branch of the fused decode), the Mamba2 SSD scan, the block quantizers
with the dequantize-then-matmul `quant_matmul_reference`, the KNN
distances with their top-k, the SLS embedding bags, and per-slot
stochastic sampling (plain torch in the reference's structure, its
Gumbel draws from `core/prng.py`, bitwise `jax.random`'s).

They are the numerical ground truth the CUDA kernels are held to on the
card, and the path `ops.py` takes for tensors on the CPU.  All arithmetic
is in float32; outputs return to the input dtype where the JAX oracle's
do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import prng

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


def decode_valid_mask(pos_b: torch.Tensor, s: int, window: int,
                      start: int = 0) -> torch.Tensor:
    """(B,S) bool mask of attended cache slots: pos-window < slot <= pos,
    for the S slots from `start` (a sequence shard's first slot)."""
    slots = start + torch.arange(s, device=pos_b.device)
    valid = slots[None, :] <= pos_b[:, None]
    if window > 0:
        valid &= slots[None, :] > (pos_b - window)[:, None]
    return valid


def decode_fused_partial_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        pos: torch.Tensor, extra: Optional[Partial] = None, *,
        window: int = 0, pages: Optional[torch.Tensor] = None,
        page_size: int = 0,
        kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        ) -> Partial:
    """`decode_fused_reference` minus the final normalisation: the raw
    merged statistics (acc (B,H,hd), m (B,H), l (B,H)).  With `kv_scales`
    (k_scales, v_scales), each (B,KH,S/page) f32 per PHYSICAL page, k/v
    are int8 pools, dequantized before the pages are gathered."""
    if kv_scales is not None:
        k = dequantize_kv_pages(k, kv_scales[0])
        v = dequantize_kv_pages(v, kv_scales[1])
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
                           page_size: int = 0,
                           kv_scales: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None
                           ) -> torch.Tensor:
    """Plain version of the fused one-shot flash decode.  q: (B,1,H,hd);
    k,v: (B,KH,S,hd) (physical pools when `pages` is given; int8 pools
    with per-page `kv_scales`); pos: (B,) or scalar last valid logical
    slot; `extra` merged before normalisation.  Returns (B,1,H,hd) in q's
    dtype."""
    acc, _, l = decode_fused_partial_reference(
        q, k, v, pos, extra, window=window, pages=pages, page_size=page_size,
        kv_scales=kv_scales)
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


# --------------------------------------------------------------------------
# Block quantization: q8_0 / q4_k weights, int8 KV pages
# --------------------------------------------------------------------------
#
# Bit for bit the reference's quantizers: the same f32 divisions by 127.0
# and 15.0, and rounding half to even (torch.round, as jnp.round).

QUANT_BLOCK = 32


def _pad_blocks(w: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the input axis of w (..., d, n) up to a multiple of
    `block`; returns the blocked f32 view (..., nB, block, n) and the pad."""
    d, n = w.shape[-2], w.shape[-1]
    nb = -(-d // block)
    pad = nb * block - d
    wf = w.float()
    if pad:
        wf = torch.cat([wf, wf.new_zeros(w.shape[:-2] + (pad, n))], dim=-2)
    return wf.reshape(w.shape[:-2] + (nb, block, n)), pad


def quantize_q8_0(w: torch.Tensor, block: int = QUANT_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 8-bit block quantization along the input axis.  w (..., d,
    n) -> (scales (..., nB, n) f32 = absmax / 127, quants (..., nB, block,
    n) int8), nB = ceil(d / block), the ragged last block zero-padded."""
    wb, _ = _pad_blocks(w, block)
    scales = wb.abs().amax(dim=-2) / 127.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(wb / safe[..., None, :]), -127, 127)
    return scales, q.to(torch.int8)


def dequantize_q8_0(scales: torch.Tensor, quants: torch.Tensor,
                    d: int) -> torch.Tensor:
    """Inverse of `quantize_q8_0` -> (..., d, n) f32."""
    w = quants.float() * scales[..., None, :]
    nb, block, n = w.shape[-3:]
    return w.reshape(w.shape[:-3] + (nb * block, n))[..., :d, :]


def quantize_q4_k(w: torch.Tensor, block: int = QUANT_BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric 4-bit block quantization: one f32 scale = (max - min) /
    15 and one f32 min per block, q = round((w - min) / scale) in [0, 15],
    two per byte (element 2j in the low nibble, 2j+1 in the high).  Min
    and max over the valid lanes only.  Returns (scales, mins, packed
    (..., nB, block // 2, n) uint8)."""
    d = w.shape[-2]
    wb, pad = _pad_blocks(w, block)
    if pad:
        lane = torch.arange(wb.shape[-3] * block, device=w.device).reshape(
            wb.shape[-3], block)
        vmask = (lane < d)[..., None]                     # (nB, block, 1)
        wmax = wb.masked_fill(~vmask, float("-inf")).amax(dim=-2)
        wmin = wb.masked_fill(~vmask, float("inf")).amin(dim=-2)
    else:
        wmax = wb.amax(dim=-2)
        wmin = wb.amin(dim=-2)
    scales = (wmax - wmin) / 15.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round((wb - wmin[..., None, :])
                                / safe[..., None, :]), 0, 15).to(torch.uint8)
    packed = q[..., 0::2, :] | (q[..., 1::2, :] << 4)
    return scales, wmin, packed


def dequantize_q4_k(scales: torch.Tensor, mins: torch.Tensor,
                    packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of `quantize_q4_k` -> (..., d, n) f32: nibble * scale + min,
    a product and a sum, each rounded."""
    lo = (packed & 0xF).float()
    hi = (packed >> 4).float()
    q = torch.stack([lo, hi], dim=-2)                     # (..., nB, hb, 2, n)
    nb, hb, _, n = q.shape[-4:]
    q = q.reshape(q.shape[:-4] + (nb, hb * 2, n))
    w = q * scales[..., None, :] + mins[..., None, :]
    return w.reshape(w.shape[:-3] + (nb * hb * 2, n))[..., :d, :]


def quant_error_bound(fmt: str, scales: torch.Tensor) -> torch.Tensor:
    """Worst-case |dequant(quant(w)) - w| per (block, column): half a step
    of the format's grid."""
    if fmt in ("q8_0", "q4_k"):
        return scales * 0.5
    raise ValueError(f"unknown quant format: {fmt}")


def dequantize_weight(fmt: str, scales: torch.Tensor, quants: torch.Tensor,
                      mins: Optional[torch.Tensor], d: int) -> torch.Tensor:
    """The f32 (..., d, n) weight of a block-quantized one."""
    if fmt == "q8_0":
        return dequantize_q8_0(scales, quants, d)
    if fmt == "q4_k":
        return dequantize_q4_k(scales, mins, quants, d)
    raise ValueError(f"unknown quant format: {fmt}")


def quant_matmul_reference(x: torch.Tensor, qt) -> torch.Tensor:
    """Plain version of the dequant-fused matmul: x (m, d_in) against the
    dequantized (d_in, n) weight of the unstacked `quant.QTensor` qt, in
    f32, returned in x's dtype."""
    w = dequantize_weight(qt.fmt, qt.scales, qt.quants, qt.mins, qt.d_in)
    return (x.float() @ w).to(x.dtype)


def quantize_kv_pages(kv: torch.Tensor, page_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 KV pages with one f32 scale per (row, head, page): kv (B, KH,
    S, hd) -> (int8 quants of the same shape, scales (B, KH, S / page) =
    the page's absmax / 127)."""
    b, kh, s, hd = kv.shape
    assert s % page_size == 0, (s, page_size)
    kr = kv.float().reshape(b, kh, s // page_size, page_size, hd)
    scales = kr.abs().amax(dim=(-2, -1)) / 127.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(kr / safe[..., None, None]), -127, 127)
    return q.to(torch.int8).reshape(b, kh, s, hd), scales


def dequantize_kv_pages(quants: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_kv_pages`: each page slab times its scale."""
    b, kh, s, hd = quants.shape
    n_pages = scales.shape[-1]
    kr = quants.float().reshape(b, kh, n_pages, s // n_pages, hd)
    return (kr * scales[..., None, None]).reshape(b, kh, s, hd)


# --------------------------------------------------------------------------
# KNN distances (VectorDB offload target)
# --------------------------------------------------------------------------

def knn_distances_reference(queries: torch.Tensor,
                            db: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances in the matmul form q2 - 2 q.x + x2, in f32.
    queries: (Q,D), db: (N,D) -> (Q,N) float32."""
    qf, xf = queries.float(), db.float()
    q2 = (qf * qf).sum(-1, keepdim=True)                 # (Q,1)
    x2 = (xf * xf).sum(-1)                               # (N,)
    return q2 - 2.0 * (qf @ xf.T) + x2[None, :]


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of the f32 matrix d, ascending,
    ties broken lowest column first, as `jax.lax.top_k(-d, k)` breaks
    them (and in its total order, where -0.0 comes before +0.0).  Returns
    (values (R,k) f32, columns (R,k) int64).

    `torch.topk` promises no order among equal values, so it runs over
    keys that are unique: the float's bits, mapped to an int32 that sorts
    as the float does, times 2^32, plus the column."""
    bits = d.float().contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    cols = torch.arange(d.shape[-1], device=d.device)
    keys = order * (1 << 32) + cols
    top = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    idx = torch.remainder(top, 1 << 32)
    return torch.gather(d, -1, idx), idx


def knn_topk_reference(queries: torch.Tensor, db: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest db rows of each query by squared L2: (dists (Q,k) f32,
    ids (Q,k) int64), nearest first, ties lowest id first."""
    return smallest_k(knn_distances_reference(queries, db), k)


# --------------------------------------------------------------------------
# Sparse Length Sum (DLRM offload target)
# --------------------------------------------------------------------------

def sls_reference(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding-bag pooled sum, walking each bag's slots in order as the
    Pallas kernel does: acc += row * w, both roundings in f32.  table:
    (V,D); indices: (B,L) int32; weights: (B,L) or None (all ones) ->
    (B,D) float32.

    An index outside [0, V) adds nothing: -1 is padding.  This follows
    the Pallas kernel (`repro/kernels/sls.py`), which masks -1, and not
    `repro/kernels/ref.py::sls_reference`, whose `jnp.take` wraps -1 to
    the table's last row (and fills an index >= V with nan, where the
    kernel in interpret mode clamps it to the last row): the kernel's
    docstring defines -1 as padding, and a kernel that reads no row
    outside the table defines the rest."""
    v = table.shape[0]
    idx = indices.long()
    valid = (idx >= 0) & (idx < v)
    rows_at = idx.clamp(0, v - 1)
    acc = torch.zeros((indices.shape[0], table.shape[1]),
                      dtype=torch.float32, device=table.device)
    for slot in range(indices.shape[1]):
        row = table[rows_at[:, slot]].float()
        if weights is not None:
            row = row * weights[:, slot, None].float()
        acc = acc + torch.where(valid[:, slot, None], row, 0.0)
    return acc


# --------------------------------------------------------------------------
# Per-slot stochastic sampling (plain torch in the port, as plain XLA in
# the reference: no kernel)
# --------------------------------------------------------------------------

def sample_tokens_reference(logits: torch.Tensor, temperature: torch.Tensor,
                            top_k: torch.Tensor, top_p: torch.Tensor,
                            min_p: torch.Tensor, keys: torch.Tensor,
                            vocab: int = 0) -> torch.Tensor:
    """Per-slot token selection, the single definition of its semantics.
    logits: (B, V); temperature / top_p / min_p: (B,) f32; top_k: (B,)
    int; keys: (B, 2) int64, one PRNG key per slot; `vocab`: the true
    vocabulary width when V is padded (0: no bound).  Returns (B,) int32.

    A row with temperature <= 0 or top_k == 1 is greedy: argmax(logits),
    its key unused and the vocab bound not applied.  Any other row keeps
    the top_k best tokens (0: all), the smallest descending prefix whose
    mass reaches top_p (a token is kept iff the mass strictly before it
    is < top_p; the best token always), and the tokens whose probability
    is at least min_p times the best one's; then draws argmax(logits / T
    + G), G ~ Gumbel(0, 1) from the row's key, in descending-sorted
    space: the Gumbel draw at RANK r uses the key's counter r, and the
    winning rank maps back through the sort."""
    b, v = logits.shape
    lf = logits.float()
    greedy = (temperature <= 0.0) | (top_k == 1)
    scaled = _scaled_bounded_logits(lf, temperature, vocab)
    order, sorted_logits, keep = _sorted_keep(scaled, top_k, top_p, min_p)
    filtered = torch.where(keep, sorted_logits, float("-inf"))
    rank = (filtered + prng.gumbel(keys, v)).argmax(dim=-1)
    sampled = torch.gather(order, -1, rank[:, None])[:, 0]
    return torch.where(greedy, lf.argmax(dim=-1), sampled).to(torch.int32)


def _scaled_bounded_logits(lf: torch.Tensor, temperature: torch.Tensor,
                           vocab: int) -> torch.Tensor:
    """Temperature scaling, then the pad ids (>= vocab) set to -inf before
    any softmax, so they carry no probability mass."""
    v = lf.shape[-1]
    scaled = lf / torch.clamp(temperature.float(), min=1e-6)[:, None]
    if vocab and vocab < v:
        real = torch.arange(v, device=lf.device)[None, :] < vocab
        scaled = torch.where(real, scaled, float("-inf"))
    return scaled


# The rank width of the partial-sort path (`sample_tokens_capped`).  The
# cumulative mass over ranks [0, SAMPLE_HEAD) is a cumsum of exactly that
# head slice, so the partial path's keep mask is bitwise the full one's.
SAMPLE_HEAD = 64
# The margin of the nucleus-closure test: the partial path is taken only
# when the head's mass clears top_p by this much, so the head and the
# full-vocab cumsums, which may round apart, cannot flip a tail rank.
_CLOSURE_EPS = 1e-5


def _sorted_keep(scaled: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, min_p: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top_k / top_p / min_p keep mask in descending-sorted space (a
    stable sort: ties go to the lower id, as `jnp.argsort(-x)` breaks
    them).  Returns (order (B,V) rank -> id (int64), sorted logits (B,V),
    keep (B,V) over ranks).

    The probabilities are a softmax in TOKEN order gathered into rank
    order (a gather keeps the bits, and the partial path takes the same
    softmax without a sort), and the mass over the head ranks is a cumsum
    of the head slice alone, kept apart from the tail's."""
    b, v = scaled.shape
    sorted_logits, order = torch.sort(scaled, dim=-1, descending=True,
                                      stable=True)
    probs = torch.gather(torch.softmax(scaled, dim=-1), -1, order)
    ranks = torch.arange(v, device=scaled.device)[None, :]
    keep = torch.where(top_k[:, None] > 0, ranks < top_k[:, None], True)
    head = min(SAMPLE_HEAD, v)
    cum = probs[:, :head].contiguous().cumsum(dim=-1)
    if v > head:
        cum = torch.cat([cum, probs.cumsum(dim=-1)[:, head:]], dim=-1)
    cum_before = cum - probs
    keep &= (cum_before < top_p[:, None]) | (ranks == 0)
    keep &= probs >= min_p[:, None] * probs[:, :1]
    return order, sorted_logits, keep


def largest_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of the f32 matrix x, descending,
    ties lowest column first and -0.0 equal to +0.0, as a stable
    descending sort (and `jax.lax.top_k`) orders them.  Returns (values
    (R,k) f32, columns (R,k) int64).  `torch.topk` promises no order
    among equal values, so it runs over unique keys: the float's bits,
    mapped to an int32 that sorts as the float does, times 2^32, plus the
    column's complement."""
    bits = (x.float() + 0.0).contiguous().view(torch.int32)   # -0.0 -> +0.0
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    cols = torch.arange(x.shape[-1], device=x.device)
    keys = order * (1 << 32) + (0xFFFFFFFF - cols)
    top = torch.topk(keys, k, dim=-1, largest=True, sorted=True).values
    idx = 0xFFFFFFFF - torch.remainder(top, 1 << 32)
    return torch.gather(x, -1, idx), idx


def sample_tokens_capped(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor,
                         min_p: torch.Tensor, keys: torch.Tensor,
                         vocab: int = 0, head: int = SAMPLE_HEAD
                         ) -> torch.Tensor:
    """`sample_tokens_reference` through a partial sort of the first
    `head` ranks where every row's filters provably close inside the head
    (greedy, 0 < top_k <= head, or head mass >= top_p + _CLOSURE_EPS),
    else the full reference: bitwise the reference's tokens either way.

    The reference chooses between the two with `lax.cond`; here both are
    computed and the choice is made on the device (`torch.where` on
    `all(closed)`), so nothing is read back to the host and the function
    can run inside a CUDA graph."""
    full = sample_tokens_reference(logits, temperature, top_k, top_p, min_p,
                                   keys, vocab)
    if logits.shape[-1] <= head:
        return full
    fast, closed = sample_tokens_head(logits, temperature, top_k, top_p,
                                      min_p, keys, vocab, head)
    return torch.where(closed.all(), fast, full)


def sample_tokens_head(logits: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       min_p: torch.Tensor, keys: torch.Tensor,
                       vocab: int = 0, head: int = SAMPLE_HEAD
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial-sort path of `sample_tokens_capped` alone: (tokens (B,)
    int32, closed (B,) bool); a row's token is the reference's wherever
    it is closed.  `largest_k` breaks ties as the stable sort does, the
    probabilities are the same token-order softmax gathered, the head
    cumsum is the reference's own, and the Gumbel draw is the row's full
    draw cut to the head (its counters 0 .. head-1)."""
    lf = logits.float()
    greedy = (temperature <= 0.0) | (top_k == 1)
    scaled = _scaled_bounded_logits(lf, temperature, vocab)
    top_vals, top_idx = largest_k(scaled, head)
    probs_h = torch.gather(torch.softmax(scaled, dim=-1), -1, top_idx)
    cum_head = probs_h.cumsum(dim=-1)
    closed = (greedy | ((top_k > 0) & (top_k <= head))
              | (cum_head[:, -1] >= top_p + _CLOSURE_EPS))
    ranks = torch.arange(head, device=logits.device)[None, :]
    keep = torch.where(top_k[:, None] > 0, ranks < top_k[:, None], True)
    keep &= ((cum_head - probs_h) < top_p[:, None]) | (ranks == 0)
    keep &= probs_h >= min_p[:, None] * probs_h[:, :1]
    filtered = torch.where(keep, top_vals, float("-inf"))
    rank = (filtered + prng.gumbel(keys, head)).argmax(dim=-1)
    sampled = torch.gather(top_idx, -1, rank[:, None])[:, 0]
    return (torch.where(greedy, lf.argmax(dim=-1), sampled).to(torch.int32),
            closed)


def filtered_log_probs(logits: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       min_p: torch.Tensor, vocab: int = 0) -> torch.Tensor:
    """(..., V) log-probabilities of the temperature / top_k / top_p /
    min_p filtered distribution, the one a sampled row of
    `sample_tokens_reference` draws from (filtered-out tokens -inf).
    logits: (B, V) or (B, K, V); the (B,) parameters broadcast over K."""
    shape = logits.shape
    v = shape[-1]
    lf = logits.float().reshape(-1, v)
    rep = lf.shape[0] // temperature.shape[0]
    t, tk, tp, mp = (p.repeat_interleave(rep)
                     for p in (temperature, top_k, top_p, min_p))
    scaled = _scaled_bounded_logits(lf, t, vocab)
    order, _, keep = _sorted_keep(scaled, tk, tp, mp)
    keep_tok = torch.empty_like(keep).scatter_(-1, order, keep)
    filtered = torch.where(keep_tok, scaled, float("-inf"))
    return torch.log_softmax(filtered, dim=-1).reshape(shape)


def verify_tokens_reference(target_logits: torch.Tensor,
                            draft_logits: torch.Tensor,
                            draft_tokens: torch.Tensor,
                            temperature: torch.Tensor, top_k: torch.Tensor,
                            top_p: torch.Tensor, min_p: torch.Tensor,
                            keys: torch.Tensor, vocab: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative draft-and-verify acceptance, the single definition of
    its semantics.  target_logits (B, K+1, V): the target's logits at the
    K+1 verified positions; draft_logits (B, K, V): the logits each draft
    token was drawn from; draft_tokens (B, K) int; keys (B, 2) int64, one
    per slot.  Returns (out_tokens (B, K+1) int32, accept_len (B,)
    int32): the round emits out_tokens[:accept_len + 1].

    Greedy rows (temperature <= 0 or top_k == 1) accept while the draft
    equals the target argmax, and out_tokens is the target argmax at all
    K+1 positions (not bounded by `vocab`, as greedy sampling is not).
    Sampled rows run rejection sampling over the filtered distributions
    q (target) and p (draft) of `filtered_log_probs`: draft j is accepted
    when log u_j + log p_j(g_j) <= log q_j(g_j) and q_j(g_j) > 0; the
    first rejected position emits argmax(log r_j + G) from the residual
    r_j = max(q_j - p_j, 0), or from q_j when r_j has no mass; a round
    that accepts all K emits argmax(log q_K + G').  The draws come from
    `prng.split(key, 3)` = (ku, kc, kb): u = uniform(ku, K), G =
    gumbel(kc, K*V) as (K, V), G' = gumbel(kb, V).  Nothing is read back
    to the host."""
    b, kp1, v = target_logits.shape
    k = kp1 - 1
    assert k >= 1, "draft depth must be >= 1"
    draft_tokens = draft_tokens.long()
    greedy = (temperature <= 0.0) | (top_k == 1)

    tgt_argmax = target_logits.float().argmax(dim=-1)            # (B,K+1)
    g_match = (draft_tokens == tgt_argmax[:, :k]).to(torch.int32)
    g_accept = g_match.cumprod(dim=-1).sum(dim=-1)

    lq = filtered_log_probs(target_logits, temperature, top_k, top_p,
                            min_p, vocab)                        # (B,K+1,V)
    lp = filtered_log_probs(draft_logits, temperature, top_k, top_p,
                            min_p, vocab)                        # (B,K,V)
    lq_g = torch.gather(lq[:, :k], -1, draft_tokens[..., None])[..., 0]
    lp_g = torch.gather(lp, -1, draft_tokens[..., None])[..., 0]

    ku, kc, kb = prng.split(keys, 3).unbind(dim=-2)
    u = prng.uniform(ku, k)                                      # (B,K)
    g_res = prng.gumbel(kc, k * v).reshape(b, k, v)
    g_bonus = prng.gumbel(kb, v)                                 # (B,V)
    accept = (torch.log(u) + lp_g <= lq_g) & (lq_g > float("-inf"))
    s_accept = accept.to(torch.int32).cumprod(dim=-1).sum(dim=-1)

    q = torch.exp(lq[:, :k])
    res = torch.clamp(q - torch.exp(lp), min=0.0)                # (B,K,V)
    res_ok = res.sum(dim=-1, keepdim=True) > 0.0
    res_l = torch.where(res_ok, torch.log(res), lq[:, :k])
    corr = (res_l + g_res).argmax(dim=-1)                        # (B,K)
    bonus = (lq[:, k] + g_bonus).argmax(dim=-1)                  # (B,)

    at = torch.clamp(s_accept, max=k).long()
    fix = torch.where(
        s_accept < k,
        torch.gather(corr, 1, torch.clamp(at, max=k - 1)[:, None])[:, 0],
        bonus)
    out_s = torch.cat([draft_tokens, bonus[:, None]], dim=1)
    out_s = out_s.scatter(1, at[:, None], fix[:, None])

    out = torch.where(greedy[:, None], tgt_argmax, out_s)
    accept_len = torch.where(greedy, g_accept, s_accept)
    return out.to(torch.int32), accept_len.to(torch.int32)
