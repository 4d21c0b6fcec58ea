"""Model layers of the ported serve and training paths, from
`repro/models/layers.py`: norm, rotary embedding (and Qwen2-VL's
multimodal M-RoPE), the decode token's own attention partial, the partial
merge, the blocked attention (the enc-dec encoder, prefill
cross-attention and the training forward) and the banded sliding-window
attention, the gated MLP, the top-k Mixture-of-Experts FFN (and its
expert-parallel form on a training mesh, `moe_ffn_dist`) and its
load-balancing loss, the Mamba2 chunked SSD scan and single-token step,
the causal depthwise conv, and the chunked cross-entropy (plain XLA in the
reference, plain torch here; autograd gives the training backward, as
`jax.value_and_grad` does there).

Conventions as in the reference: activations x (B, S, D) in the model
dtype; attention q (B, S, H, hd), k/v (B, S, KH, hd); softmax and norm
statistics in float32.  On a training mesh (`sharding.TrainLayout`) the
MoE FFN, its balance loss and the cross-entropy take the rank's local
rows and span and reduce over the mesh (`core/collectives.py`, imported
where used: it imports `core/backstream.py`, which imports this module).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

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


def merge_attention_partials_raw(accs: torch.Tensor, ms: torch.Tensor,
                                 ls: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Merge N partial-attention results without the normalisation: accs
    (N,B,H,hd), ms/ls (N,B,H) -> (acc (B,H,hd), m (B,H), l (B,H))."""
    m = ms.max(dim=0).values                              # (B,H)
    alpha = torch.exp(ms - m[None])                       # (N,B,H)
    l = (ls * alpha).sum(dim=0)
    acc = (accs * alpha[..., None]).sum(dim=0)
    return acc, m, l


def merge_attention_partials(accs: torch.Tensor, ms: torch.Tensor,
                             ls: torch.Tensor) -> torch.Tensor:
    """Merge N partial-attention results: accs (N,B,H,hd), ms/ls (N,B,H)
    -> normalised (B,H,hd)."""
    acc, _, l = merge_attention_partials_raw(accs, ms, ls)
    return acc / torch.clamp(l, min=1e-20)[..., None]


NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KH, hd) -> (B, S, KH * n_rep, hd), each KV head repeated for
    its n_rep query heads."""
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(
        b, s, kh * n_rep, d)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, q_offset: int = 0,
                      block: int = 1024, q_tile: int = 512,
                      window: int = 0) -> torch.Tensor:
    """Flash-style attention in plain torch, with the reference's
    arithmetic (plain XLA there, no kernel): queries scaled in f32, K / V
    taken to f32, an online softmax over KV blocks (the block the largest
    divisor of Sk not above `block`: 750 of whisper's 1500 encoder
    positions), queries in tiles of `q_tile` rows, and under `causal` only
    the blocks up to a tile's last query.  q: (B, Sq, H, hd); k / v: (B,
    Sk, KH, hd); `q_offset` places the queries in the KV sequence.
    `window` > 0 (with `causal`) also masks the keys window or more
    positions behind a query, and skips the blocks wholly behind a tile's
    first query's window (a training rank's sliding-window span against
    the gathered K/V).  Returns (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    k = repeat_kv(k, h // kh)
    v = repeat_kv(v, h // kh)
    scale = 1.0 / math.sqrt(hd)
    block = min(block, sk)
    while sk % block:
        block -= 1
    n_blocks = sk // block
    qf = (q.float() * scale).transpose(1, 2)              # (B,H,Sq,hd)
    kf = k.float().transpose(1, 2).reshape(b, h, n_blocks, block, hd)
    vf = v.float().transpose(1, 2).reshape(b, h, n_blocks, block, hd)
    outs = []
    with true_f32():
        for t0 in range(0, sq, q_tile):
            t1 = min(t0 + q_tile, sq)
            q_t = qf[:, :, t0:t1]
            tq = t1 - t0
            pos_t = q_offset + torch.arange(t0, t1, device=q.device)
            n_kv = (max(1, -(-min(sk, q_offset + t1) // block)) if causal
                    else n_blocks)
            first = (max(0, q_offset + t0 - window + 1) // block
                     if causal and window else 0)
            m = torch.full((b, h, tq, 1), NEG_INF, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros((b, h, tq, 1), dtype=torch.float32,
                            device=q.device)
            acc = torch.zeros((b, h, tq, hd), dtype=torch.float32,
                              device=q.device)
            for j in range(first, n_kv):
                s = torch.einsum("bhqd,bhkd->bhqk", q_t, kf[:, :, j])
                if causal:
                    kv_pos = j * block + torch.arange(block, device=q.device)
                    mask = pos_t[:, None] >= kv_pos[None, :]
                    if window:
                        mask &= pos_t[:, None] - kv_pos[None, :] < window
                    s = torch.where(mask[None, None], s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                                 vf[:, :, j])
                m = m_new
            outs.append(acc / torch.clamp(l, min=1e-20))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return out.transpose(1, 2).to(q.dtype)                # (B,Sq,H,hd)


def gated_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """silu(x w_gate) * (x w_up) projected by w_down; each weight a tensor
    or a `QTensor` (through the dequant-fused matmul)."""
    h = F.silu(matmul(x, w_gate)) * matmul(x, w_up)
    return matmul(h, w_down)


def silu_per_op(x: torch.Tensor) -> torch.Tensor:
    """silu as the reference's XLA computes it on the CPU: x * 1 / (1 +
    exp(-x)), each op rounded to x's dtype.  In bf16 it is the
    reference's bits (F.silu rounds once, up to 2 bf16 units apart)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def moe_capacity(t: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert for t routed rows: max(8, ceil(t k / E x 1.25))."""
    return max(8, int(math.ceil(t * top_k / n_experts * capacity_factor)))


@contextlib.contextmanager
def true_f32() -> Iterator[None]:
    """f32 products in full f32 (no TF32), whatever the global switch."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def moe_route(x: torch.Tensor, router: torch.Tensor, top_k: int,
              n_real: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router: x (T, D) @ router (D, E) in f32, softmax, the top_k
    experts of each row (ties to the lower expert id, as `lax.top_k`),
    their gates renormalized in f32.  Returns (gates (T, K) f32, expert
    ids (T, K) int64), best first.  The product runs over
    `quantize.invariant_rows` like every other, and only the real T rows
    reach the top-k.  `n_real` < E: the router's columns from n_real on
    are padding (the expert-parallel branch's), their logits -inf."""
    with true_f32():
        logits = matmul(x.float(), router.float())
    if 0 < n_real < logits.shape[-1]:
        real = torch.arange(logits.shape[-1], device=x.device) < n_real
        logits = torch.where(real, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k]
    return gates / gates.sum(dim=-1, keepdim=True), ids[:, :top_k]


class MoEDispatch(NamedTuple):
    """Where each routed (token, k) pair goes, for pairs in the flat
    token-major order i = token * K + k.

      slot_token — (E, cap) int64: the token each expert slot computes, T
                   (the zero sentinel row) for an empty slot;
      slot_gate  — (E, cap) f32: the gate that slot's output is scaled by;
      keep       — (T*K,) bool: the pair's queue position is below cap;
      dest       — (T*K,) int64: the flat slot e * cap + c the pair
                   writes, (E - 1) * cap + cap - 1 for a dropped pair;
      owns       — (T*K,) bool: the pair is kept and is its slot's last
                   writer, so its expert output reaches its token."""
    slot_token: torch.Tensor
    slot_gate: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    owns: torch.Tensor


def moe_dispatch(expert_ids: torch.Tensor, gates: torch.Tensor,
                 n_experts: int, cap: int, *,
                 first: Optional[int] = None) -> MoEDispatch:
    """The reference's capacity-bounded dispatch, computed without a
    scatter whose duplicate indices race.  A pair's queue position is the
    count of earlier pairs (flat order) routed to its expert; a pair at
    position >= cap is dropped, and the reference still writes it, with
    the sentinel token T and gate 0, to slot (E - 1, cap - 1).  Where
    several pairs write one slot the last in flat order wins (the CPU
    scatter's order), so a dropped pair after the kept occupant of
    (E - 1, cap - 1) takes that occupant's output away.  Here each slot's
    last writer is the largest flat index that writes it (an `amax`
    reduction, which no order changes).  No host sync.

    `first` (the expert-parallel branch of `moe_ffn_dist`): this
    dispatch's experts are the n_experts from expert id `first` on, the
    slots local to them; a pair routed to any other expert is never kept
    here, and every pair not kept writes local slot (0, cap - 1), as the
    reference's shard-local dispatch does."""
    t, k = expert_ids.shape
    dev = expert_ids.device
    flat = expert_ids.reshape(-1)
    if first is None:
        onehot = F.one_hot(flat, num_classes=n_experts)    # (T*K, E)
        pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
        keep = pos < cap
        drop = n_experts * cap - 1
    else:
        flat = flat - first
        mine = (flat >= 0) & (flat < n_experts)
        flat = torch.where(mine, flat, 0)
        onehot = F.one_hot(flat, num_classes=n_experts) * mine[:, None]
        pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
        keep = mine & (pos < cap)
        drop = cap - 1
    dest = torch.where(keep, flat * cap + pos, torch.full_like(flat, drop))
    order = torch.arange(t * k, device=dev)
    writer = torch.full((n_experts * cap,), -1, dtype=torch.int64,
                        device=dev).scatter_reduce(0, dest, order, "amax")
    won = writer.clamp(min=0)
    kept = (writer >= 0) & keep[won]
    slot_token = torch.where(kept, won // k, t).reshape(n_experts, cap)
    slot_gate = torch.where(kept, gates.reshape(-1)[won],
                            0.0).reshape(n_experts, cap)
    owns = keep & (writer[dest] == order)
    return MoEDispatch(slot_token, slot_gate, keep, dest, owns)


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-k MoE with capacity-bounded gather / scatter dispatch, the
    reference's `moe_ffn`: x (T, D); router (D, E) f32; w_gate / w_up
    (E, D, F), w_down (E, F, D).  Each expert computes its `cap` slots
    (`moe_capacity` of T: it couples the rows, so drops depend on T and
    on every routed row), gathered from x padded with a zero sentinel row,
    by batched products over the E experts (plain einsums in the
    reference too).  The combine is in f32 and deterministic: each
    token's kept contributions, expert output times slot gate, are added
    to 0.0 one at a time in ascending expert order, the order of the
    reference's CPU scatter-add, so a row's bits depend on nothing but
    its routed slots.  The experts' silu rounds per op, as the
    reference's (`silu_per_op`).  No host sync: it runs inside a captured
    graph."""
    t = x.shape[0]
    e = router.shape[-1]
    gates, ids = moe_route(x, router, top_k)
    _trace(0, x, router, ids)
    dp = moe_dispatch(ids, gates, e, moe_capacity(t, top_k, e,
                                                  capacity_factor))
    return _moe_experts(x, ids, dp, w_gate, w_up, w_down).to(x.dtype)


def _moe_experts(x: torch.Tensor, ids: torch.Tensor, dp: MoEDispatch,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor) -> torch.Tensor:
    """The experts' slots of a dispatch (the expert stacks `dp` is over)
    and the ordered f32 combine into (T, D) f32."""
    t, d = x.shape
    top_k = ids.shape[-1]
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    xe = x_pad[dp.slot_token]                             # (E, cap, D)
    h = silu_per_op(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down).reshape(-1, d)
    # each token's pairs in ascending expert order
    by_expert = ids.argsort(dim=-1)
    dest = dp.dest.reshape(t, top_k).gather(1, by_expert)
    owns = dp.owns.reshape(t, top_k).gather(1, by_expert)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        s = dest[:, j]
        part = ye[s].float() * dp.slot_gate.reshape(-1)[s][:, None]
        y = y + torch.where(owns[:, j, None], part, 0.0)
    return y


def _data_index(rules) -> int:
    """This rank's index over the batch axes (the first major)."""
    idx = 0
    for a in rules.batch_axes:
        idx = idx * rules.size(a) + rules.rank(a)
    return idx


def _local_rows(y: torch.Tensor, act) -> torch.Tensor:
    """This rank's (rows, span) of a (B, S, D) activation under `act`."""
    if act.rows:
        b_l = y.shape[0] // act.rules.data_size()
        y = y.narrow(0, _data_index(act.rules) * b_l, b_l)
    return y.narrow(1, act.start, act.length)


# the fewest tokens a data shard routes on the expert-parallel branch
EP_MIN_TOKENS = 512
# process-wide, not thread-local: on the card a checkpointed block's
# recomputation runs on the autograd engine's own thread
_EP_TWIN: Dict[str, Optional[Tuple[int, int]]] = {"shape": None}
_ROUTES: Dict[str, Optional[list]] = {"log": None}


@contextlib.contextmanager
def trace_routes() -> Iterator[list]:
    """Within the block, every forward routing of the expert-parallel
    branch (its first model shard's) and of `moe_ffn` appends (data
    shard, expert ids (T, K), each row's k-th minus (k+1)-th router
    logit) to the list it yields: where a mesh's routing parts from its
    single-device twin's, how near a tie the parted rows were."""
    prev = _ROUTES["log"]
    _ROUTES["log"] = log = []
    try:
        yield log
    finally:
        _ROUTES["log"] = prev


def _trace(data_shard: int, x: torch.Tensor, router: torch.Tensor,
           ids: torch.Tensor, n_real: int = 0) -> None:
    log = _ROUTES["log"]
    k = ids.shape[-1]
    if log is None or not torch.is_grad_enabled() or k >= router.shape[-1]:
        return
    with torch.no_grad(), true_f32():
        logits = matmul(x.float(), router.float())
        if 0 < n_real < logits.shape[-1]:
            logits = logits[:, :n_real]
        top = torch.sort(logits, dim=-1, descending=True).values
    log.append((data_shard, ids.cpu(), (top[:, k - 1] - top[:, k]).cpu()))


@contextlib.contextmanager
def expert_parallel_twin(n_data: int, n_model: int) -> Iterator[None]:
    """Within the block, `moe_ffn_dist` without a mesh computes what an
    n_data x n_model mesh's expert-parallel branch would (`moe_ffn_ep`)
    wherever that mesh would take the branch: the single-device twin of
    a mesh run, on its numbers rather than `moe_ffn`'s."""
    prev = _EP_TWIN["shape"]
    _EP_TWIN["shape"] = (n_data, n_model)
    try:
        yield
    finally:
        _EP_TWIN["shape"] = prev


def _takes_ep(t: int, n_data: int, top_k: int) -> bool:
    return t % n_data == 0 and t // n_data >= max(EP_MIN_TOKENS, top_k)


def _pad_experts(w: torch.Tensor, e_pad: int, dim: int = 0) -> torch.Tensor:
    """An expert stack (or, dim=1, the router) padded with zero experts
    to e_pad."""
    e = w.shape[dim]
    if e_pad == e:
        return w
    shape = list(w.shape)
    shape[dim] = e_pad - e
    return torch.cat([w, w.new_zeros(shape)], dim=dim)


def _ep_partial(tokens: torch.Tensor, router: torch.Tensor,
                w_local: Tuple[torch.Tensor, ...], top_k: int,
                capacity_factor: float, e: int, shard: int,
                data_shard: int = 0) -> torch.Tensor:
    """One model shard's partial output of the expert-parallel branch:
    the data shard's tokens routed over the padded experts, dispatched to
    this shard's E_pad / n_model experts (`w_local`) at the capacity of
    the shard's token count, in x's dtype."""
    e_local = w_local[0].shape[0]
    gates, ids = moe_route(tokens, router, top_k, n_real=e)
    if shard == 0:
        _trace(data_shard, tokens, router, ids, e)
    dp = moe_dispatch(ids, gates, e_local,
                      moe_capacity(tokens.shape[0], top_k, e,
                                   capacity_factor),
                      first=shard * e_local)
    return _moe_experts(tokens, ids, dp, *w_local).to(tokens.dtype)


def moe_ffn_ep(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
               capacity_factor: float, n_data: int, n_model: int
               ) -> torch.Tensor:
    """The expert-parallel branch of `moe_ffn_dist` on one device: x (T,
    D), the full expert stacks; the T rows cut into n_data contiguous
    data shards, each shard's partials of the n_model model shards (the
    experts padded to a multiple of n_model) summed in rank order."""
    t, _ = x.shape
    e = router.shape[-1]
    e_pad = -(-e // n_model) * n_model
    e_local = e_pad // n_model
    router = _pad_experts(router, e_pad, dim=1)
    ws = [_pad_experts(w, e_pad) for w in (w_gate, w_up, w_down)]
    out = []
    for d, tokens in enumerate(x.split(t // n_data)):
        y = None
        for m in range(n_model):
            part = _ep_partial(tokens, router, tuple(
                w[m * e_local:(m + 1) * e_local] for w in ws), top_k,
                capacity_factor, e, m, d)
            y = part if y is None else y + part
        out.append(y)
    return torch.cat(out)


def moe_ffn_dist(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
                 capacity_factor: float = 1.25, *, act=None,
                 w_specs: Optional[Tuple[Any, Any, Any]] = None
                 ) -> torch.Tensor:
    """The MoE FFN of a training rank, the reference's `moe_ffn_dist`.
    x: the rank's (rows, span) (B_l, S_l, D) of the global (B, S, D)
    activation whose layout `act` (`sharding.Act`) gives; the expert
    stacks as this rank stores them, under `w_specs` (None: whole).
    Without `act` it is `moe_ffn` over the rows flattened.  Returns (B_l,
    S_l, D).

    With fewer than max(EP_MIN_TOKENS, top_k) tokens a data shard (or T
    not dividing over the data axes) it is `moe_ffn` over the GLOBAL B*S
    rows in their flat (b, s) order: the rows gathered over the model
    and data axes, the full expert stacks, the rank's rows taken back.
    From there on it is the expert-parallel branch, whose numbers part
    from `moe_ffn`'s: the experts padded to a multiple of n_model, each
    model rank routing its data shard's tokens (the flat global rows cut
    into n_data contiguous parts: its rows, or with replicated rows its
    part of them) to its own E_pad / n_model experts at a capacity taken
    from the shard's token count; every pair not kept there (dropped or
    routed to another rank's experts) writes local slot (0, cap - 1)
    (`moe_dispatch(first=)`); each rank's partial, cast to x's dtype,
    summed over the model axis."""
    from repro_torch.core import collectives as C
    b_l, s_l, d = x.shape
    if act is None:
        flat = x.reshape(b_l * s_l, d)
        twin = _EP_TWIN["shape"]
        if twin is not None and _takes_ep(b_l * s_l, twin[0], top_k):
            y = moe_ffn_ep(flat, router, w_gate, w_up, w_down, top_k,
                           capacity_factor, *twin)
        else:
            y = moe_ffn(flat, router, w_gate, w_up, w_down, top_k,
                        capacity_factor)
        return y.reshape(b_l, s_l, d)
    rules = act.rules
    specs = w_specs or (None, None, None)
    n_data, n_model = rules.data_size(), rules.model_size()
    b = b_l * n_data if act.rows else b_l
    t, e = b * act.s, router.shape[-1]
    # this data shard's rows, their whole sequence
    xs = C.all_gather(x, 1, act.seq, rules) if act.seq else x
    if not _takes_ep(t, n_data, top_k):
        xg = C.all_gather(xs, 0, act.rows, rules) if act.rows else xs
        ws = [C.gather(w, sp, rules=rules)
              for w, sp in zip((w_gate, w_up, w_down), specs)]
        y = moe_ffn(xg.reshape(t, d), router, *ws, top_k, capacity_factor)
        return _local_rows(y.reshape(b, act.s, d), act)

    tl = t // n_data
    tokens = xs.reshape(-1, d)
    if not act.rows:                        # the shard's part of all rows
        tokens = tokens.narrow(0, _data_index(rules) * tl, tl)
    e_pad = -(-e // n_model) * n_model
    e_local = e_pad // n_model
    shard = rules.rank(rules.model_axis) if rules.model_axis else 0
    local = []
    for w, sp in zip((w_gate, w_up, w_down), specs):
        if sp is not None and sp[0] == rules.model_axis:
            local.append(C.gather(w, sp, (rules.model_axis,), rules))
            continue
        local.append(_pad_experts(C.gather(w, sp, rules=rules),
                                  e_pad).narrow(
            0, shard * e_local, e_local))
    y = _ep_partial(tokens, _pad_experts(router, e_pad, dim=1),
                    tuple(local), top_k, capacity_factor, e, shard,
                    _data_index(rules))
    if rules.model_axis:
        y = C.all_reduce_sum(y, rules.model_axis, rules)
    if not act.rows:                        # every shard's part, in order
        y = C.all_gather(y, 0, rules.batch_axes, rules)
    return y.reshape(b_l, act.s, d).narrow(1, act.start, act.length)


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


# --------------------------------------------------------------------------
# Training: banded attention, the MoE balance loss, the chunked SSD scan,
# the chunked cross-entropy
# --------------------------------------------------------------------------

def sliding_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, window: int) -> torch.Tensor:
    """Banded causal attention, the reference's: block-local with exactly
    one look-back block (block size == window), so O(S * 2W) products
    instead of O(S^2), in full f32.  A query attends itself and the
    window - 1 positions before it.  S <= window is causal
    `blocked_attention`; a longer S must be a multiple of the window.
    q: (B, S, H, hd); k / v: (B, S, KH, hd).  Returns (B, S, H, hd) in
    q's dtype."""
    b, s, h, hd = q.shape
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    if s <= window:
        return blocked_attention(q, k, v, causal=True, block=min(s, 1024))
    if s % window:
        raise ValueError(f"sequence {s} is not a multiple of the window "
                         f"{window}")
    nb, dev = s // window, q.device
    qb = (q.float() * (1.0 / math.sqrt(hd))).reshape(b, nb, window, h, hd)
    kb = k.float().reshape(b, nb, window, h, hd)
    vb = v.float().reshape(b, nb, window, h, hd)
    # each block with the one before it (zeros before block 0)
    kk = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]],
                              dim=1), kb], dim=2)         # (B,nb,2W,H,hd)
    vv = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]],
                              dim=1), vb], dim=2)
    qpos = torch.arange(window, device=dev)[:, None]
    kpos = torch.arange(2 * window, device=dev)[None, :] - window
    band = (kpos <= qpos) & (kpos > qpos - window)       # exact window band
    # block 0 has no look-back block (its "previous" is the zero padding)
    has_prev = (torch.arange(nb, device=dev) > 0)[None, :, None, None, None]
    mask = band & (has_prev | (kpos >= 0))               # (1,nb,1,W,2W)
    with true_f32():
        sco = torch.einsum("bnqhd,bnkhd->bnhqk", qb, kk)  # (B,nb,H,W,2W)
        p = torch.softmax(torch.where(mask, sco, NEG_INF), dim=-1)
        out = torch.einsum("bnhqk,bnkhd->bnqhd", p, vv)
    return out.reshape(b, s, h, hd).to(q.dtype)


def moe_aux_loss(x: torch.Tensor, router: torch.Tensor,
                 top_k: int, rules=None) -> torch.Tensor:
    """The Switch-style load-balancing loss of the reference: E times the
    sum over experts of (the share of rows routing to it in their top-k,
    over k) x (its mean router probability).  x (T, D); router (D, E).
    The top-k ties go to the lower expert id, as `lax.top_k` (and
    `moe_route`).  Differentiable through the probabilities only.  On a
    training mesh (its `rules`) x is the rank's rows, and
    both shares are means over all B*S rows: their sums all-reduced
    (the probabilities' with its gradient) before the product, never a
    sum of per-rank losses."""
    with true_f32():
        logits = matmul(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[-1]
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    counts = F.one_hot(idx, e).float().sum(dim=-2)
    if rules is None:
        frac_tokens = counts.mean(dim=0)
        frac_probs = probs.mean(dim=0)
    else:
        # the means over every rank's rows, replicated rows counted on
        # each replica in both the sums and the count
        from repro_torch.core import collectives as C
        n = x.shape[0] * rules.data_size() * rules.model_size()
        frac_tokens = C.all_reduce_sum(counts.sum(dim=0), None, rules) / n
        frac_probs = C.all_reduce_sum(probs.sum(dim=0), None, rules) / n
    return e * torch.sum(frac_tokens * frac_probs) / top_k


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment sums: out[..., i, j] = sum of x[..., k] for k in (j, i],
    NEG_INF above the diagonal.  Each is summed over its own segment
    (a cumulative sum of x masked to k > j), where the reference takes
    the difference of two running sums, cs_i - cs_j: the same value, but
    the difference cancels, so a unit in the last place of one x (as two
    devices' exp or softplus give) moved mamba's f32 gradients by ~2e-5
    of a leaf's max."""
    q = x.shape[-1]
    ones = torch.ones((q, q), dtype=torch.bool, device=x.device)
    below = torch.tril(ones, diagonal=-1)                 # (k, j): k > j
    xs = torch.where(below, x[..., :, None], 0.0)         # (..., k, j)
    out = torch.cumsum(xs, dim=-2)                        # (..., i, j)
    return torch.where(torch.tril(ones), out, NEG_INF)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 SSD scan in its chunked form (Dao & Gu 2024), the
    reference's, in f32: within a chunk a causal, decayed attention-like
    product; across chunks a recurrence over the chunk states, in order.
    The reference's three- and four-operand einsums run here as explicit
    pairwise products (`torch.einsum` would pick a contraction order by
    what the installation has), so the intermediates are fixed; the
    segment sums within a chunk are summed over each segment
    (`_segsum`) rather than as differences of running sums.

    x: (b, s, h, p); dt: (b, s, h), softplus applied; A: (h,) negative;
    B, C: (b, s, n), one group for every head; s a multiple of `chunk`
    (or at most it); init_state (b, h, p, n) or None (zeros).  Returns
    (y (b, s, h, p) in x's dtype, final state (b, h, p, n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    dA = dtf * A.float()                                  # (b,nc,q,h) <= 0
    dA_cum = torch.cumsum(dA, dim=2)                      # within a chunk
    with true_f32():
        # intra-chunk: y[q] = sum_k L[h,q,k] (C_q . B_k) dt_k x_k
        L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))    # (b,nc,h,q,k)
        scores = Cf @ Bf.transpose(-1, -2)                # (b,nc,q,k)
        xdt = (xf * dtf[..., None]).permute(0, 1, 3, 2, 4)  # (b,nc,h,k,p)
        y_intra = (L * scores[:, :, None]) @ xdt          # (b,nc,h,q,p)
        # each chunk's state: sum_q dt_q decay(q -> end) x_q B_q^T, the
        # decay the segment sum (q, end]: the reference's exp(cs_end -
        # cs_q) without its cancellation
        decay_to_end = L[:, :, :, -1, :].permute(0, 1, 3, 2)  # (b,nc,q,h)
        xw = xf * (dtf * decay_to_end)[..., None]         # (b,nc,q,h,p)
        states = xw.permute(0, 1, 3, 4, 2) @ Bf[:, :, None]  # (b,nc,h,p,n)
        # inter-chunk recurrence, in chunk order
        chunk_decay = torch.exp(dA_cum[:, :, -1, :])      # (b,nc,h)
        state = (init_state.float() if init_state is not None
                 else x.new_zeros((b, h, p, n), dtype=torch.float32))
        prev = []
        for c in range(nc):
            prev.append(state)
            state = state * chunk_decay[:, c, :, None, None] + states[:, c]
        prev_states = torch.stack(prev, dim=1)            # (b,nc,h,p,n)
        # inter-chunk output: decay(start -> q) C_q . state before chunk
        y_inter = (Cf[:, :, None] @ prev_states.transpose(-1, -2)
                   ) * torch.exp(dA_cum).permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y.to(x.dtype), state


def xent_loss_chunked(x: torch.Tensor, emb: torch.Tensor,
                      labels: torch.Tensor, *, chunk: int = 512,
                      vocab: int = 0, rules=None) -> torch.Tensor:
    """Cross-entropy against the tied embedding, the reference's: the
    (B, chunk, V) logits of one sequence chunk at a time, in x's dtype
    then f32, the padded rows past `vocab` masked out, and the mean over
    all B*S positions (the last label of each row, 0 in the data
    pipeline, counts like the others).  x (B, S, D); emb (V, D); labels
    (B, S) int.  Returns the f32 scalar.  On a training mesh (its
    `rules`) x and labels are the rank's rows and span, the chunk
    the largest divisor of the span not above `chunk`, and the total is
    summed over the mesh and divided by the global B*S (each replica of
    replicated rows counted in the sum and the count)."""
    b, s, _ = x.shape
    v = emb.shape[0]
    chunk = min(chunk, s)
    if rules is not None:
        chunk = math.gcd(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    pad = (torch.arange(v, device=x.device) >= vocab
           if vocab and vocab < v else None)
    total = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        with true_f32():
            logits = (x[:, c0:c0 + chunk] @ emb.T).float()   # (B,q,V)
        if pad is not None:
            logits = torch.where(pad, NEG_INF, logits)
        gold = logits.gather(-1, labels[:, c0:c0 + chunk, None].long())
        total = total + torch.sum(torch.logsumexp(logits, dim=-1)
                                  - gold[..., 0])
    if rules is not None:
        from repro_torch.core import collectives as C
        world = rules.data_size() * rules.model_size()
        return C.all_reduce_sum(total, None, rules) / (b * s * world)
    return total / (b * s)
