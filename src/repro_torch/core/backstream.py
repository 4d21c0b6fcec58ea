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
prefix reuse.

The mesh schedules (the AXLE ring, head-group gathering) are ROADMAP
queue 1 item 17.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import decode_valid_mask as _decode_valid_mask
from repro_torch.models import layers as L


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


def cache_update_stacked(cache: torch.Tensor, new: torch.Tensor,
                         slot: torch.Tensor) -> torch.Tensor:
    """Ring-slot write of one token for ALL layers at once, IN PLACE:
    cache (L,B,KH,S,hd), new (L,B,KH,1,hd), slot a scalar or a (B,)
    vector of per-row physical rows.  Returns `cache`."""
    nl, b, kh, s, hd = cache.shape
    slot = torch.as_tensor(slot, device=cache.device).long()
    if slot.dim() == 0:
        slot = slot.expand(b)
    val = new.to(cache.dtype)[:, :, :, 0, :]              # (L,B,KH,hd)
    rows = torch.arange(b, device=cache.device)
    cache[:, rows, :, slot, :] = val.permute(1, 0, 2, 3)
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
    the whole encoder output.  Returns (B,1,H,hd)."""
    cfg = current_offload()
    b, kh, s, hd = k_cache.shape
    page_size = 0
    if pages is not None:
        assert s % pages.shape[1] == 0, (s, tuple(pages.shape))
        page_size = s // pages.shape[1]
    pos_b = torch.as_tensor(pos, device=q.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()
    if n_chunks is None:
        n_chunks = min(max(1, cfg.chunks_per_shard), s)

    if cfg.fused and cfg.protocol != OffloadProtocol.RP:
        if pages is not None:
            # the kernel chunk IS the page; the table drives its reads
            return ops.decode_attention_fused(q, k_cache, v_cache, pos_b,
                                              extra, pages, kv_scales,
                                              window=window, blk_c=page_size)
        # (over int8 pools the kernel takes the scale page as its chunk)
        blk_c = max(1, min(128, s // n_chunks))
        return ops.decode_attention_fused(q, k_cache, v_cache, pos_b, extra,
                                          kv_scales=kv_scales,
                                          window=window, blk_c=blk_c)

    # chunked schedule (RP, fused=False): per-chunk partials + one merge
    q_in = q
    if kv_scales is not None:
        # f32 pools, and q in f32 with them (exact: the partial takes q
        # to f32 before its dots either way)
        k_cache = _ref.dequantize_kv_pages(k_cache, kv_scales[0])
        v_cache = _ref.dequantize_kv_pages(v_cache, kv_scales[1])
        q_in = q.float()
    if pages is not None:
        k_cache = _ref.gather_kv_pages(k_cache, pages, page_size)
        v_cache = _ref.gather_kv_pages(v_cache, pages, page_size)
    kv_valid = _decode_valid_mask(pos_b, s, window)
    accs, ms, ls = _partials_over_chunks(q_in, k_cache, v_cache, kv_valid,
                                         n_chunks)
    if extra is not None:
        acc_e, m_e, l_e = extra
        accs = torch.cat([accs, acc_e[None]], dim=0)
        ms = torch.cat([ms, m_e[None]], dim=0)
        ls = torch.cat([ls, l_e[None]], dim=0)
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
    on the copies' event (the one host sync) and returns the leaves."""

    def __init__(self, host: Dict[str, torch.Tensor],
                 done: Optional["torch.cuda.Event"] = None):
        self._host = host
        self._done = done

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._host.values())

    @property
    def event(self) -> Optional["torch.cuda.Event"]:
        """The side stream's (timing) event after the last copy; None on
        the CPU."""
        return self._done

    def materialize(self) -> Dict[str, torch.Tensor]:
        if self._done is not None:
            self._done.synchronize()
        return self._host


def stream_offload_to_host(leaves: Dict[str, torch.Tensor], *,
                           chunks: int = 2) -> HostSnapshot:
    """Evict one slot's pages to the host tier: `chunks` `non_blocking`
    copies a leaf into pinned host tensors on the side stream, behind an
    event of the serving stream, so the copies overlap whatever the
    serving stream runs next.  `leaves` must not be written afterwards
    (the server hands over fresh staging tensors).  Returns a lazy
    `HostSnapshot`: nothing here waits."""
    cuda = [t for t in leaves.values() if t.is_cuda]
    if not cuda:
        return HostSnapshot({k: t.clone() for k, t in leaves.items()})
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
    return HostSnapshot(host, done)


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


class HostTier:
    """Host-memory store of evicted slot snapshots, keyed by request id:
    the expanded-memory tier the server spills cold slots into.  Tracks
    the bytes moved each way and the peak resident bytes; capacity is the
    host's (the paper's premise is that this tier is the big one)."""

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
    [0, L)."""

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
