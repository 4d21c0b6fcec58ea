"""The offload protocols on one device: the port of the main-path part of
`repro/core/backstream.py`.

`stream_offload` is the paper's generic producer -> consumer combinator
(the KNN and SLS offload paths run through it): chunk i's producer is the
memory-side task, the consumer folds its result into a carry, and the
protocol fixes the schedule (BS: produce all, then fold; RP: produce one,
fold it, in turn; AXLE: the producer runs `ring_depth - 1` chunks ahead of
the consumer, on its own CUDA stream when the carry lies on a GPU).

The paper's protocols (RP, BS, AXLE) differ in how the partial-attention
statistics (acc, m, l) of the KV chunks reach the consumer.  On one device:

  BS, AXLE — the fused one-shot decode kernel: produce, merge and
             normalise in one launch, reading paged caches through the
             page table.
  RP       — and `OffloadConfig(fused=False)`: one partial-kernel launch
             per chunk, then a separate merge.

An int8 KV cache (per-page `kv_scales`) is dequantized inside the fused
kernel; the chunked schedule dequantizes the pools up front in plain
torch, as the reference does in plain XLA.

The host tier (`stream_offload_to_host` / `stream_offload_to_device`,
`HostTier`, `PrefixCache`) moves one slot's cache pages between the device
and pinned host memory on the side stream, for the server's eviction and
prefix reuse; under a data split `move_snapshot` carries a snapshot to
another data group and `broadcast_leaves` shares one group's small
tensors (a first token's logits, a restored slot-state row) with all.

Under a mesh (`sharding.use_rules`, one process a shard over
`torch.distributed`) the decode takes the mesh schedules:

  head groups  — serving (`head_shard_attn`): each model rank runs the
                 fused partial (`ops.decode_attention_fused_partial`) over
                 its head group, the (acc, m, l) statistics cross ranks
                 in ONE all-gather, a bit-copy, and every rank normalises
                 them: bitwise the single device's output.
  sequence     — `seq_shard_attn`: each rank holds a span of the cache's
                 sequence; AXLE streams the partials around the ring in
                 n - 1 point-to-point hops, each posted before the merge
                 of the previous one; BS gathers every rank's chunk
                 partials at once; RP brings them over one rank at a
                 time.  `cache_update_sharded` writes a token into the
                 rank that owns its slot.

The transport is gloo's: host tensors.  A CUDA tensor is staged through
pinned host memory on its way out and copied back after (`_wire_*`); the
computation stays on the card, and a failed collective raises.  `WIRE`
counts what this process put on the wire.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import decode_valid_mask as _decode_valid_mask
from repro_torch.models import layers as L
from repro_torch.sharding import ShardingRules, active_rules


class OffloadProtocol(enum.Enum):
    RP = "rp"
    BS = "bs"
    AXLE = "axle"


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    protocol: OffloadProtocol = OffloadProtocol.AXLE
    # chunks per shard of the chunked merge (one shard on one device)
    chunks_per_shard: int = 1
    # ring depth of `stream_offload` (flow-control credits): AXLE issues
    # producer(i + max(1, ring_depth - 1)) before consumer(i)
    ring_depth: int = 2
    # fused one-shot decode kernel; False takes the chunked schedule
    fused: bool = True


_state = threading.local()


def current_offload() -> OffloadConfig:
    return getattr(_state, "cfg", None) or OffloadConfig()


@contextlib.contextmanager
def use_offload(cfg: OffloadConfig) -> Iterator[None]:
    prev = getattr(_state, "cfg", None)
    _state.cfg = cfg
    try:
        yield
    finally:
        _state.cfg = prev


# AXLE's producer stream, one per device for the life of the process: the
# caching allocator keeps freed blocks per stream, so a fresh stream for
# every call would find none and allocate each partial anew
_side_streams: Dict[int, "torch.cuda.Stream"] = {}
_side_lock = threading.Lock()


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _side_lock:
        side = _side_streams.get(index)
        if side is None:
            side = _side_streams[index] = torch.cuda.Stream(index)
        return side


def _cuda_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _cuda_leaves(item)


def stream_offload(producer: Callable[[int], Any],
                   consumer: Callable[[Any, Any], Any], init: Any,
                   num_chunks: int,
                   protocol: OffloadProtocol = OffloadProtocol.AXLE) -> Any:
    """Run `num_chunks` producer tasks and fold their results through
    `consumer` in chunk order, under the protocol's schedule, with the
    reference's semantics:

      producer(i) -> partial_i          the memory-side task
      consumer(carry, partial_i) -> carry

      BS   : produce every chunk, then fold them in order;
      RP   : produce chunk i, then fold it, one chunk at a time;
      AXLE : producer(i + depth) is issued before consumer(i), depth =
             max(1, ring_depth - 1) of the active `OffloadConfig`.

    Every protocol produces each chunk exactly once (the reference's AXLE
    recomputes the last chunk at the tail, an artifact of its traced
    index), and the fold order is the same, so the three give equal
    carries.  When `init` holds a CUDA tensor, AXLE issues the producers
    on a side CUDA stream of its device (else it runs the plain loop):
    each ring slot's partial carries an event, the consumer's stream
    waits on it before the fold, and the partial's tensors are recorded
    on the consumer's stream, so the caching allocator does not hand
    their memory back to the producer until the fold that read them has
    run.  The producer reads nothing the consumer writes (under AXLE it
    runs ahead of it).  Nothing here syncs the host."""
    if protocol == OffloadProtocol.BS:
        partials = [producer(i) for i in range(num_chunks)]
        carry = init
        for partial in partials:
            carry = consumer(carry, partial)
        return carry
    if protocol == OffloadProtocol.RP:
        carry = init
        for i in range(num_chunks):
            carry = consumer(carry, producer(i))
        return carry

    depth = max(1, current_offload().ring_depth - 1)
    side = main = None
    on_card = next(_cuda_leaves(init), None)
    if on_card is not None:
        main = torch.cuda.current_stream(on_card.device)
        side = _side_stream(on_card.device)
        side.wait_stream(main)          # the producer's inputs are ready

    def issue(i: int):
        if side is None:
            return producer(i), None
        with torch.cuda.stream(side):
            partial = producer(i)
            done = torch.cuda.Event()
            done.record(side)
        return partial, done

    ring = collections.deque(issue(i) for i in range(min(depth, num_chunks)))
    carry = init
    for i in range(num_chunks):
        partial, done = ring.popleft()
        if i + depth < num_chunks:
            ring.append(issue(i + depth))
        if done is not None:
            main.wait_event(done)
            for t in _cuda_leaves(partial):
                t.record_stream(main)
        carry = consumer(carry, partial)
    return carry


def seq_shard_start(s_local: int) -> Tuple[int, int]:
    """(first logical slot, whole sequence length) of this rank's span of
    a cache's sequence axis: under `seq_shard_attn` rules on a model axis
    of n > 1 ranks a cache leaf holds S / n slots of S; else (0, its own
    length)."""
    rules = active_rules()
    if rules is not None and rules.seq_shard_attn and rules.model_size() > 1:
        n = rules.model_size()
        return rules.rank(rules.model_axis) * s_local, n * s_local
    return 0, s_local


def cache_update_stacked(cache: torch.Tensor, new: torch.Tensor,
                         slot: torch.Tensor) -> torch.Tensor:
    """Ring-slot write of one token for ALL layers at once, IN PLACE:
    cache (L,B,KH,S,hd), new (L,B,KH,1,hd), slot a scalar or a (B,)
    vector of per-row physical rows.  Under `seq_shard_attn` rules the
    cache is this rank's span of the sequence and `slot` is logical: the
    rank that owns a row's slot writes it there, every other rank
    rewrites the value it holds at the clamped slot (`cache_update_
    sharded`'s rule).  Returns `cache`."""
    nl, b, kh, s, hd = cache.shape
    slot = torch.as_tensor(slot, device=cache.device).long()
    if slot.dim() == 0:
        slot = slot.expand(b)
    val = new.to(cache.dtype)[:, :, :, 0, :].permute(1, 0, 2, 3)  # (B,L,..)
    rows = torch.arange(b, device=cache.device)
    start, whole = seq_shard_start(s)
    if whole != s:
        loc = (slot - start).clamp(0, s - 1)
        mine = (slot >= start) & (slot < start + s)
        val = torch.where(mine[:, None, None, None], val,
                          cache[:, rows, :, loc, :])
        slot = loc
    cache[:, rows, :, slot, :] = val
    return cache


def physical_slots(pages: torch.Tensor, slots: torch.Tensor,
                   page_size: int) -> torch.Tensor:
    """Translate LOGICAL cache slots to PHYSICAL pool rows through the
    page table.  pages: (B, n_pages) int32; slots: (B,) or (B, T)."""
    b = pages.shape[0]
    flat = slots.reshape(b, -1).long()
    phys_page = torch.gather(pages.long(), 1, flat // page_size)
    return (phys_page * page_size + flat % page_size).reshape(
        slots.shape).to(torch.int32)


def cache_update_sharded(cache: torch.Tensor, new: torch.Tensor,
                         slot: torch.Tensor) -> torch.Tensor:
    """Write one token's K or V, IN PLACE, at logical slot `slot` (a scalar
    or (B,) per-row) of a cache (B,KH,S,hd) that under `seq_shard_attn`
    rules is this rank's span of the sequence: the rank that owns a row's
    slot writes it there, every other rank rewrites the value it holds at
    the clamped slot.  new: (B,KH,1,hd).  Returns `cache`."""
    rules = active_rules()
    b, _, s, _ = cache.shape
    start = 0
    if (rules is not None and rules.seq_shard_attn
            and rules.model_size() > 1):
        start = rules.rank(rules.model_axis) * s
    slot_b = torch.as_tensor(slot, device=cache.device).to(
        torch.int32).reshape(-1).expand(b)
    loc = (slot_b - start).clamp(0, s - 1).long()
    mine = (slot_b >= start) & (slot_b < start + s)
    rows = torch.arange(b, device=cache.device)
    val = torch.where(mine[:, None, None],
                      new[:, :, 0, :].to(cache.dtype), cache[rows, :, loc, :])
    cache[rows, :, loc, :] = val
    return cache


def _partials_over_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: torch.Tensor, n_chunks: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Split the KV sequence into n_chunks and compute partial attention
    for each (one partial-kernel launch per chunk on the card): returns
    acc (n,B,H,hd), m (n,B,H), l (n,B,H).  k/v: (B,KH,S,hd)."""
    s = k.shape[2]
    assert s % n_chunks == 0, (s, n_chunks)
    c = s // n_chunks
    accs, ms, ls = [], [], []
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        acc, m, l = ops.decode_attention_partial(
            q, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(),
            kv_valid[:, sl].contiguous())
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def _chunked_partials(q, k_cache, v_cache, pos_b, window, extra, pages,
                      kv_scales, page_size, n_chunks):
    """The chunked schedule's statistics (RP, fused=False): the pools
    dequantized (q in f32 with them: the partial takes q to f32 before
    its dots either way) and gathered to logical order, one partial a
    chunk, the current token's `extra` last.  Returns stacked (accs, ms,
    ls)."""
    q_in = q
    if kv_scales is not None:
        k_cache = _ref.dequantize_kv_pages(k_cache, kv_scales[0])
        v_cache = _ref.dequantize_kv_pages(v_cache, kv_scales[1])
        q_in = q.float()
    if pages is not None:
        k_cache = _ref.gather_kv_pages(k_cache, pages, page_size)
        v_cache = _ref.gather_kv_pages(v_cache, pages, page_size)
    kv_valid = _decode_valid_mask(pos_b, k_cache.shape[2], window)
    accs, ms, ls = _partials_over_chunks(q_in, k_cache, v_cache, kv_valid,
                                         n_chunks)
    if extra is not None:
        acc_e, m_e, l_e = extra
        accs = torch.cat([accs, acc_e[None]], dim=0)
        ms = torch.cat([ms, m_e[None]], dim=0)
        ls = torch.cat([ls, l_e[None]], dim=0)
    return accs, ms, ls


def decode_attention_combined(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, pos: torch.Tensor, *,
                              window: int = 0,
                              n_chunks: Optional[int] = None,
                              extra=None,
                              pages: Optional[torch.Tensor] = None,
                              kv_scales: Optional[Tuple[torch.Tensor,
                                                        torch.Tensor]] = None
                              ) -> torch.Tensor:
    """Single-step attention of q (B,1,H,hd) against the KV cache
    (B,KH,S,hd), combined under the active offload protocol.  `pos` is the
    last valid cache slot, a scalar or (B,) per-row.  `pages`: optional
    (B, n_pages) page table; the cache panels are then page pools.
    `kv_scales`: optional (k_scales, v_scales) (B,KH,n_pages) f32 per
    physical page of int8 pools.  `n_chunks`: the chunks of the chunked
    schedule (RP, fused=False), whose dense fused route takes a chunk of
    S / n_chunks rows, capped at 128; None takes `chunks_per_shard`
    (capped at S).  The enc-dec cross-attention passes 1: one partial over
    the whole encoder output.  Returns (B,1,H,hd).

    Under `head_shard_attn` rules on a model axis of n > 1 ranks whose
    split aligns with the GQA groups (`partition.serve_head_regime`) the
    head-group schedule runs the same route on each rank's heads and
    gathers the statistics (`_headgroup_gather_decode`): bitwise this
    function's single-device output.  Under `seq_shard_attn` rules the
    cache is this rank's span of S = n x its length, and the protocol's
    mesh schedule combines the spans (`_seq_sharded_decode`)."""
    cfg = current_offload()
    rules = active_rules()
    b, kh, s, hd = k_cache.shape
    n_shards = rules.model_size() if rules is not None else 1
    page_size = 0
    if pages is not None:
        assert s % pages.shape[1] == 0, (s, tuple(pages.shape))
        page_size = s // pages.shape[1]
    pos_b = torch.as_tensor(pos, device=q.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()

    if n_shards > 1 and rules.seq_shard_attn:
        if pages is not None:
            raise ValueError(
                "the sequence-sharded schedules take each rank's span of a "
                "dense (logical-order) cache, not page pools; serving "
                "shards by head group (head_shard_attn)")
        local = (max(1, cfg.chunks_per_shard) if n_chunks is None
                 else max(1, n_chunks // n_shards))
        return _seq_sharded_decode(q, k_cache, v_cache, pos_b, window,
                                   extra, kv_scales, min(local, s), rules,
                                   cfg.protocol)

    if n_chunks is None:
        n_chunks = min(max(1, cfg.chunks_per_shard), s)
    fused = cfg.fused and cfg.protocol != OffloadProtocol.RP
    if pages is not None:
        blk_c = page_size        # the kernel chunk IS the page
    else:
        # (over int8 pools the kernel takes the scale page as its chunk)
        blk_c = max(1, min(128, s // n_chunks))

    if n_shards > 1 and rules.head_shard_attn:
        h = q.shape[2]
        shard_kv = kh % n_shards == 0
        if shard_kv or (kh == 1 and h % n_shards == 0):
            return _headgroup_gather_decode(
                q, k_cache, v_cache, pos_b, window, extra, pages, kv_scales,
                page_size, blk_c, None if fused else n_chunks, rules,
                shard_kv)

    if fused:
        return ops.decode_attention_fused(q, k_cache, v_cache, pos_b, extra,
                                          pages, kv_scales, window=window,
                                          blk_c=blk_c)

    # chunked schedule (RP, fused=False): per-chunk partials + one merge
    accs, ms, ls = _chunked_partials(q, k_cache, v_cache, pos_b, window,
                                     extra, pages, kv_scales, page_size,
                                     n_chunks)
    out = L.merge_attention_partials(accs, ms, ls)        # (B,H,hd)
    return out[:, None].to(q.dtype)


# --------------------------------------------------------------------------
# The mesh schedules and their transport
# --------------------------------------------------------------------------

@dataclasses.dataclass
class WireCounters:
    """What this process put on the mesh's wire: the statistics gathers
    (head groups, BS), the AXLE ring's hops and RP's broadcasts, the bytes
    sent to peers (a gather sends its payload to each of n - 1 peers),
    and each hop's host wall ms (post to arrival)."""
    gathers: int = 0
    hops: int = 0
    broadcasts: int = 0
    bytes_sent: int = 0
    hop_ms: List[float] = dataclasses.field(default_factory=list)
    # bytes_sent by collective: "all-gather", "send" (ring hops),
    # "broadcast"
    bytes_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.gathers = self.hops = self.broadcasts = self.bytes_sent = 0
        self.hop_ms.clear()
        self.bytes_by_op.clear()

    def sent(self, op: str, n: int) -> None:
        self.bytes_sent += n
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + n


WIRE = WireCounters()


def _wire_out(t: torch.Tensor) -> torch.Tensor:
    """The host tensor gloo sends: `t` itself on the CPU; a CUDA tensor's
    copy in pinned memory, taken when the stream's work before it is
    done (the copy waits for it); for a meta tensor (the dry-run, over a
    fake group) an uninitialised host tensor of its shape."""
    t = t.contiguous()
    if t.is_meta:
        return torch.empty(t.shape, dtype=t.dtype)
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _wire_buffer(like: torch.Tensor) -> torch.Tensor:
    """A host tensor for gloo to receive a tensor shaped as `like` into."""
    return torch.empty(like.shape, dtype=like.dtype,
                       pin_memory=like.is_cuda)


def _wire_in(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(host.shape, dtype=host.dtype, device=device)
    if device.type != "cuda":
        return host
    return host.to(device, non_blocking=True)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` of the group, in rank order, on t's device."""
    n = dist.get_world_size(group)
    src = _wire_out(t)
    parts = [_wire_buffer(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    WIRE.gathers += 1
    WIRE.sent("all-gather", (n - 1) * _nbytes(src))
    return [_wire_in(p, t.device) for p in parts]


def all_gather_model(t: torch.Tensor) -> List[torch.Tensor]:
    """Every model rank's `t` of this rank's line along the active rules'
    model axis, in rank order (one all-gather; `WIRE` counts it)."""
    rules = active_rules()
    return _all_gather(t, rules.group(rules.model_axis))


def _pack(acc, m, l) -> torch.Tensor:
    """(acc (...,hd), m (...), l (...)) as one f32 (..., hd + 2) tensor."""
    return torch.cat([acc, m[..., None], l[..., None]], dim=-1)


def _unpack(packed: torch.Tensor):
    hd = packed.shape[-1] - 2
    return packed[..., :hd], packed[..., hd], packed[..., hd + 1]


def _headgroup_gather_decode(q, k_cache, v_cache, pos_b, window, extra,
                             pages, kv_scales, page_size, blk_c, n_chunks,
                             rules: ShardingRules, shard_kv: bool):
    """The head-group schedule: this model rank's contiguous group of
    H / n query heads (and, when n | KH, of KH / n KV heads with their
    page scales; with KH == 1 the panel is whole) sliced out of the
    replicated operands, a bit-copy; the single device's route over them
    with its statistics left raw (the fused partial, or with `n_chunks`
    the chunked schedule's merge); the statistics of every group gathered
    in rank order along the head axis in ONE all-gather, a bit-copy; and
    the single device's normalisation.  Every statistic belongs to one
    (row, head), so the result is the single device's bit for bit.  Wire
    bytes a rank a merge: (n - 1) B H/n (hd + 2) 4."""
    axis = rules.model_axis
    n, r = rules.model_size(), rules.rank(axis)
    h, kh = q.shape[2], k_cache.shape[1]
    hl = h // n
    heads = slice(r * hl, (r + 1) * hl)
    q_l = q[:, :, heads].contiguous()
    k_l, v_l, scales_l = k_cache, v_cache, kv_scales
    if shard_kv:
        kv = slice(r * (kh // n), (r + 1) * (kh // n))
        k_l = k_cache[:, kv].contiguous()
        v_l = v_cache[:, kv].contiguous()
        if kv_scales is not None:
            scales_l = tuple(sc[:, kv].contiguous() for sc in kv_scales)
    extra_l = (None if extra is None
               else tuple(t[:, heads].contiguous() for t in extra))
    if n_chunks is None:
        acc, m, l = ops.decode_attention_fused_partial(
            q_l, k_l, v_l, pos_b, extra_l, pages, scales_l, window=window,
            blk_c=blk_c)
    else:
        acc, m, l = L.merge_attention_partials_raw(*_chunked_partials(
            q_l, k_l, v_l, pos_b, window, extra_l, pages, scales_l,
            page_size, n_chunks))
    full = torch.cat(_all_gather(_pack(acc, m, l), rules.group(axis)), dim=1)
    acc, _, l = _unpack(full)
    return _ref.normalize_fused_partial(acc, l, q.dtype)


def _merge_pair(run, other):
    return _ref.merge_fused_partial_pair(*run, *other)


def _seq_sharded_decode(q, k_l, v_l, pos_b, window, extra, kv_scales,
                        n_chunks, rules: ShardingRules,
                        protocol: OffloadProtocol) -> torch.Tensor:
    """Decode over a sequence-sharded cache: k_l/v_l (B,KH,S/n,hd) are this
    model rank's span [r S/n, (r + 1) S/n) of the logical sequence (int8
    pools with their local page scales when `kv_scales` is given).

      AXLE — ONE partial over the span, then n - 1 ring hops by
             point-to-point sends (`batch_isend_irecv`): hop j sends what
             arrived at hop j - 1 (first the rank's own partial) to rank
             r + 1 and receives from r - 1, and is posted BEFORE the
             merge of hop j - 1's arrival, so the transfer overlaps it.
             Each rank merges the partials in ring order (its own, r - 1,
             r - 2, ...), then the current token's `extra`, and
             normalises.
      BS   — `n_chunks` partials a span, ONE all-gather of every rank's,
             then the single device's chunked merge in sequence order
             (`extra` last).
      RP   — the same partials and merge, brought over one rank at a
             time by a broadcast from each rank in turn: n serial round
             trips.

    Each hop's host wall (post to arrival) goes to `WIRE.hop_ms`."""
    axis = rules.model_axis
    group = rules.group(axis)
    n, r = rules.model_size(), rules.rank(axis)
    b, kh, s_l, hd = k_l.shape
    q_in = q
    if kv_scales is not None:
        k_l = _ref.dequantize_kv_pages(k_l, kv_scales[0])
        v_l = _ref.dequantize_kv_pages(v_l, kv_scales[1])
        q_in = q.float()
    valid = _decode_valid_mask(pos_b, s_l, window, start=r * s_l)

    if protocol == OffloadProtocol.AXLE:
        run = ops.decode_attention_partial(q_in, k_l, v_l, valid)
        nxt = dist.get_global_rank(group, (r + 1) % n)
        prv = dist.get_global_rank(group, (r - 1) % n)
        send, arrived = _wire_out(_pack(*run)), None
        for hop in range(n - 1):
            t0 = time.perf_counter()
            recv = _wire_buffer(send)
            works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
            if arrived is not None:         # overlaps the hop in flight
                run = _merge_pair(run, _unpack(_wire_in(arrived,
                                                        q.device)))
            for w in works:
                w.wait()
            WIRE.hops += 1
            WIRE.sent("send", _nbytes(send))
            WIRE.hop_ms.append((time.perf_counter() - t0) * 1e3)
            arrived = send = recv
        if arrived is not None:
            run = _merge_pair(run, _unpack(_wire_in(arrived, q.device)))
        if extra is not None:
            run = _merge_pair(run, extra)
        return _ref.normalize_fused_partial(run[0], run[2], q.dtype)

    packed = _pack(*_partials_over_chunks(q_in, k_l, v_l, valid, n_chunks))
    if protocol == OffloadProtocol.BS:
        parts = _all_gather(packed, group)
    else:
        parts = []
        for j in range(n):
            buf = _wire_out(packed) if j == r else _wire_buffer(packed)
            dist.broadcast(buf, dist.get_global_rank(group, j), group=group)
            WIRE.broadcasts += 1
            if j == r:
                WIRE.sent("broadcast", (n - 1) * _nbytes(buf))
            parts.append(_wire_in(buf, q.device))
    accs, ms, ls = _unpack(torch.cat(parts, dim=0))
    if extra is not None:
        accs = torch.cat([accs, extra[0][None]], dim=0)
        ms = torch.cat([ms, extra[1][None]], dim=0)
        ls = torch.cat([ls, extra[2][None]], dim=0)
    out = L.merge_attention_partials(accs, ms, ls)        # (B,H,hd)
    return out[:, None].to(q.dtype)


# --------------------------------------------------------------------------
# Host tier: chunked device <-> pinned-host page streams, host-side stores
# --------------------------------------------------------------------------
#
# The server's host tier treats host RAM as the expanded-memory tier and
# the device cache as the hot one.  One slot's cache pages (the leaves of
# `transformer.extract_slot_cache`, fresh device tensors gathered on the
# serving stream: the staging copy) move between the two in `chunks`
# pieces a leaf, split along the leading (layer) axis:
#
#   to host   — the side stream waits on an event recorded on the serving
#               stream after the gather, then issues each chunk's
#               `non_blocking` copy into a pinned host tensor; the staging
#               tensors are recorded on the side stream, so the allocator
#               keeps them until the copies have read them.  Nothing
#               blocks until `HostSnapshot.materialize()` waits on the
#               copies' event: the one host sync, as in the reference.
#   to device — each chunk's `non_blocking` copy from pinned memory into a
#               device staging tensor runs on the side stream; the serving
#               stream waits on its event before anything reads the pages
#               (the in-place insert into the live cache).  No host sync.
#
# On the CPU both directions are plain copies.  There is no fallback: a
# CUDA leaf bound for a host tensor that cannot be pinned, or a host leaf
# bound for the card that is not pinned, raises.

# a snapshot's leaves: (key, shape, dtype) each, in order
Layout = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]


def _chunk_starts(n: int, chunks: int) -> List[Tuple[int, int]]:
    """Split [0, n) into <= `chunks` contiguous spans (last one ragged)."""
    chunks = max(1, min(chunks, n))
    step = -(-n // chunks)
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def _copy_chunks(dst: torch.Tensor, src: torch.Tensor, chunks: int) -> None:
    """`non_blocking` copies of src into dst, `chunks` along axis 0; a
    leaf of one layer (or a scalar, a vector) moves whole."""
    if src.dim() < 2 or src.shape[0] == 1:
        dst.copy_(src, non_blocking=True)
        return
    for i0, i1 in _chunk_starts(src.shape[0], chunks):
        dst[i0:i1].copy_(src[i0:i1], non_blocking=True)


class HostSnapshot:
    """One slot's pages in flight to (or resident in) host memory: one
    host tensor a leaf (pinned when the pages come from the card), filled
    chunk by chunk on the side stream.  `nbytes` comes from shapes alone,
    so the byte accounting never waits on a copy; `materialize()` waits
    on the copies' event (the one host sync) and returns the leaves.
    `holder` is the data rank whose group took it (0 off a data split)."""

    def __init__(self, host: Dict[str, torch.Tensor],
                 done: Optional["torch.cuda.Event"] = None, *,
                 holder: int = 0):
        self._host = host
        self._done = done
        self.holder = holder

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._host.values())

    @property
    def layout(self) -> Layout:
        return snapshot_layout(self._host)

    @property
    def event(self) -> Optional["torch.cuda.Event"]:
        """The side stream's (timing) event after the last copy; None on
        the CPU."""
        return self._done

    def materialize(self) -> Dict[str, torch.Tensor]:
        if self._done is not None:
            self._done.synchronize()
        return self._host


class SnapshotStub(HostSnapshot):
    """Another data group's snapshot, as a rank that does not hold its
    bytes keeps it: the leaves' layout and the holder, no tensor.  Its
    `nbytes` is the holder's, so the stores' byte counts and capacity
    evictions run alike on every rank."""

    def __init__(self, layout: Layout, holder: int):
        super().__init__({}, holder=holder)
        self._layout = layout

    @property
    def nbytes(self) -> int:
        return sum(_leaf_bytes(shape, dtype) for _, shape, dtype
                   in self._layout)

    @property
    def layout(self) -> Layout:
        return self._layout

    def materialize(self) -> Dict[str, torch.Tensor]:
        raise RuntimeError(f"this snapshot's bytes are on data rank "
                           f"{self.holder}'s group")


def stream_offload_to_host(leaves: Dict[str, torch.Tensor], *,
                           chunks: int = 2, holder: int = 0) -> HostSnapshot:
    """Evict one slot's pages to the host tier: `chunks` `non_blocking`
    copies a leaf into pinned host tensors on the side stream, behind an
    event of the serving stream, so the copies overlap whatever the
    serving stream runs next.  `leaves` must not be written afterwards
    (the server hands over fresh staging tensors).  Returns a lazy
    `HostSnapshot` (of data rank `holder`): nothing here waits."""
    cuda = [t for t in leaves.values() if t.is_cuda]
    if not cuda:
        return HostSnapshot({k: t.clone() for k, t in leaves.items()},
                            holder=holder)
    dev = cuda[0].device
    main = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    ready = torch.cuda.Event()
    ready.record(main)
    host: Dict[str, torch.Tensor] = {}
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for key, t in leaves.items():
            host[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            _copy_chunks(host[key], t, chunks)
            t.record_stream(side)
        done = torch.cuda.Event(enable_timing=True)
        done.record(side)
    return HostSnapshot(host, done, holder=holder)


def stream_offload_to_device(leaves: Dict[str, torch.Tensor],
                             device: torch.device, *,
                             chunks: int = 2) -> Dict[str, torch.Tensor]:
    """Restore host-resident pages to `device`: per chunk one
    `non_blocking` copy from pinned memory into a device staging tensor,
    on the side stream; the serving stream then waits on the copies'
    event, so what it queues next (the insert into the live cache) reads
    the landed pages.  Dispatches without a host sync."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: t.to(device, copy=True) for k, t in leaves.items()}
    main = torch.cuda.current_stream(device)
    side = _side_stream(device)
    out: Dict[str, torch.Tensor] = {}
    with torch.cuda.stream(side):
        for key, t in leaves.items():
            if not t.is_pinned():
                raise ValueError(
                    f"host-tier leaf {key!r} is not in pinned memory: a "
                    "copy from pageable memory would block the host")
            out[key] = torch.empty(t.shape, dtype=t.dtype, device=device)
            _copy_chunks(out[key], t, chunks)
            out[key].record_stream(main)
        done = torch.cuda.Event(enable_timing=True)
        done.record(side)
    main.wait_event(done)
    return out


# --------------------------------------------------------------------------
# Snapshots across data groups
# --------------------------------------------------------------------------
#
# Under a data split a slot's row, and every snapshot taken of it, lives on
# the data group that owns the slot.  A restore or a prefix hit may land in
# another group's slot: the snapshot then moves there, point to point over
# the data axis (`move_snapshot`).  The first token's logits and a
# restored slot-state row, which one group computes or holds and every
# rank needs, go out in one broadcast (`broadcast_leaves`).  Both carry a
# snapshot as ONE byte buffer: its leaves packed by their layout (key,
# shape, dtype), each at a 16-byte-aligned offset, which the receiving
# ranks know from the cache's shapes alone.  Neither is counted in `WIRE`,
# which holds the attention merges' bytes; the server counts its moves.

_ALIGN = 16


def snapshot_layout(leaves: Dict[str, torch.Tensor]) -> Layout:
    """The (key, shape, dtype) of every leaf, in order."""
    return tuple((k, tuple(t.shape), t.dtype) for k, t in leaves.items())


def _leaf_bytes(shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= d
    return n


def _offsets(layout: Layout) -> Tuple[List[int], int]:
    """Each leaf's byte offset in the packed buffer, and its size."""
    offs, end = [], 0
    for _, shape, dtype in layout:
        offs.append(end)
        end += -(-_leaf_bytes(shape, dtype) // _ALIGN) * _ALIGN
    return offs, end


def pack_leaves(leaves: Dict[str, torch.Tensor], layout: Layout,
                size: Optional[int] = None) -> torch.Tensor:
    """The leaves as one zero-padded uint8 host tensor of `size` bytes
    (default: the layout's); raises if a leaf is not as the layout says."""
    offs, end = _offsets(layout)
    buf = torch.zeros((size or end,), dtype=torch.uint8)
    for (key, shape, dtype), off in zip(layout, offs):
        t = leaves[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"leaf {key!r}: {tuple(t.shape)} {t.dtype}, "
                             f"the layout says {shape} {dtype}")
        n = _leaf_bytes(shape, dtype)
        buf[off:off + n].copy_(t.reshape(-1).view(torch.uint8))
    return buf


def unpack_leaves(buf: torch.Tensor, layout: Layout
                  ) -> Dict[str, torch.Tensor]:
    """`pack_leaves`' inverse: views of `buf`, one a leaf."""
    offs, _ = _offsets(layout)
    return {key: buf[off:off + _leaf_bytes(shape, dtype)].view(dtype)
            .view(shape) for (key, shape, dtype), off in zip(layout, offs)}


def move_snapshot(leaves: Optional[Dict[str, torch.Tensor]],
                  layout: Layout, src: int, dst: int, rules: ShardingRules,
                  *, pin: bool = False) -> Optional[Dict[str, torch.Tensor]]:
    """Carry one host snapshot from data group `src` to data group `dst`.
    Each rank of `src` (holding `leaves`) sends the share of the packed
    bytes its model index names to the rank of `dst` with the same model
    index, over this rank's data line; under a model split each rank so
    moves 1/n of the bytes, and the ranks of `dst` join the shares with
    one all-gather over the model axis.  Called by the ranks of both
    groups: `src`'s return None, `dst`'s the leaves, views of one host
    buffer (pinned with `pin`, for `stream_offload_to_device`).  A failed
    send or receive raises."""
    data = rules.group("data")
    me = rules.rank("data")
    n, m = rules.model_size(), rules.rank(rules.model_axis)
    _, size = _offsets(layout)
    share = -(-size // (n * _ALIGN)) * _ALIGN
    if me == src:
        buf = pack_leaves(leaves, layout, share * n)
        dist.send(buf[m * share:(m + 1) * share],
                  dist.get_global_rank(data, dst), group=data)
        return None
    if me != dst:
        raise ValueError(f"data rank {me} neither sends ({src}) nor "
                         f"receives ({dst}) this snapshot")
    buf = torch.empty((share * n,), dtype=torch.uint8, pin_memory=pin)
    if n == 1:
        dist.recv(buf, dist.get_global_rank(data, src), group=data)
    else:
        mine = torch.empty((share,), dtype=torch.uint8)
        dist.recv(mine, dist.get_global_rank(data, src), group=data)
        dist.all_gather(list(buf.view(n, share)), mine,
                        group=rules.group(rules.model_axis))
    return unpack_leaves(buf, layout)


def broadcast_leaves(leaves: Optional[Dict[str, torch.Tensor]],
                     layout: Layout, src: int, group
                     ) -> Dict[str, torch.Tensor]:
    """Group rank `src`'s leaves on every rank of `group`: one broadcast
    of their packed bytes.  `src` passes its leaves and gets them back as
    they are; the others get views of one host buffer.  A failed
    broadcast raises."""
    root = dist.get_global_rank(group, src)
    if dist.get_rank(group) == src:
        dist.broadcast(pack_leaves(leaves, layout), root, group=group)
        return leaves
    buf = torch.empty((_offsets(layout)[1],), dtype=torch.uint8)
    dist.broadcast(buf, root, group=group)
    return unpack_leaves(buf, layout)


class HostTier:
    """Host-memory store of evicted slot snapshots, keyed by request id:
    the expanded-memory tier the server spills cold slots into.  Tracks
    the bytes moved each way and the peak resident bytes; capacity is the
    host's (the paper's premise is that this tier is the big one).  Under
    a data split each entry's snapshots carry the data rank that holds
    their bytes (`HostSnapshot.holder`); every other rank stores a
    `SnapshotStub` of the same size under the same id, so the counts are
    alike on every rank."""

    def __init__(self) -> None:
        self._store: Dict[int, Tuple[HostSnapshot, HostSnapshot]] = {}
        self.bytes_evicted = 0
        self.bytes_restored = 0
        self.resident_peak = 0

    def __len__(self) -> int:
        return len(self._store)

    def put(self, rid: int, pages: HostSnapshot,
            state: HostSnapshot) -> None:
        assert rid not in self._store, rid
        self._store[rid] = (pages, state)
        self.bytes_evicted += pages.nbytes
        self.resident_peak = max(self.resident_peak, self.resident_bytes)

    def pop(self, rid: int) -> Tuple[HostSnapshot, HostSnapshot]:
        pages, state = self._store.pop(rid)
        self.bytes_restored += pages.nbytes
        return pages, state

    @property
    def resident_bytes(self) -> int:
        return sum(p.nbytes for p, _ in self._store.values())


class _TrieNode:
    __slots__ = ("children", "entry")

    def __init__(self) -> None:
        self.children: Dict[int, "_TrieNode"] = {}
        self.entry: Optional["PrefixEntry"] = None


@dataclasses.dataclass
class PrefixEntry:
    """One cached prompt: `length` tokens whose host-resident pages (K/V
    rows up to the prompt's prefill bucket, the post-prompt recurrent
    state, and the last-token logits under the key "logits") let an
    admission skip that much prefill."""
    tokens: Tuple[int, ...]
    pages: HostSnapshot

    @property
    def length(self) -> int:
        return len(self.tokens)


class PrefixCache:
    """Trie of prompts -> host-resident pages.  `put` stores a prompt's
    pages after its prefill; `lookup` returns the LONGEST stored prompt
    that is a prefix of a new one: a full hit (the whole prompt) skips the
    prefill, a partial hit restores the prefix's pages and resume-prefills
    the suffix.  Entries are dropped least recently used first once
    `capacity_bytes` is passed (None: no cap), and their trie branches
    pruned.  The pages are exact for any continuation: K/V rows [0, L)
    and the recurrent state after token L - 1 depend only on tokens
    [0, L).  Under a data split a rank that does not hold an entry's
    bytes stores a `SnapshotStub` of the holder's size under the same
    key: the trie, the LRU order, `bytes_stored`, the capacity evictions
    and `lookup` are then the same on every rank."""

    def __init__(self, capacity_bytes: Optional[int] = 256 << 20) -> None:
        self._root = _TrieNode()
        self._lru: "collections.OrderedDict[Tuple[int, ...], PrefixEntry]" \
            = collections.OrderedDict()
        self.capacity_bytes = capacity_bytes
        self.bytes_stored = 0
        self.bytes_stored_peak = 0
        self.entries_evicted = 0

    def __len__(self) -> int:
        return len(self._lru)

    def put(self, tokens, pages: HostSnapshot) -> None:
        key = tuple(int(t) for t in tokens)
        if key in self._lru:               # refresh recency, keep pages
            self._lru.move_to_end(key)
            return
        node = self._root
        for t in key:
            node = node.children.setdefault(t, _TrieNode())
        entry = PrefixEntry(tokens=key, pages=pages)
        node.entry = entry
        self._lru[key] = entry
        self.bytes_stored += pages.nbytes
        self.bytes_stored_peak = max(self.bytes_stored_peak,
                                     self.bytes_stored)
        while (self.capacity_bytes is not None
               and self.bytes_stored > self.capacity_bytes and self._lru):
            old_key, old = self._lru.popitem(last=False)
            self._remove(old_key)
            self.bytes_stored -= old.pages.nbytes
            self.entries_evicted += 1

    def lookup(self, tokens) -> Optional[PrefixEntry]:
        node, best = self._root, None
        for t in tokens:
            node = node.children.get(int(t))
            if node is None:
                break
            if node.entry is not None:
                best = node.entry
        if best is not None:
            self._lru.move_to_end(best.tokens)
        return best

    def _remove(self, key: Tuple[int, ...]) -> None:
        path = [self._root]
        for t in key:
            path.append(path[-1].children[t])
        path[-1].entry = None
        for depth in range(len(key), 0, -1):   # prune empty branches
            node = path[depth]
            if node.entry is not None or node.children:
                break
            del path[depth - 1].children[key[depth - 1]]
