"""Batched serving with per-request sampling, offload-protocol selection
and a streamed hot loop: the main-path slice of `repro/launch/serve.py`.

`--protocol {bs,axle,rp}` selects the partial-attention merge schedule
(`core/backstream.py`): on one device `bs` and `axle` take the fused
one-shot decode kernel, `rp` the per-chunk partial kernel plus a merge.
A model without attention layers (`--arch mamba2_370m`) accepts it and
runs no attention at all: its decode state is the recurrent conv and SSM
state of each layer, written in place.

Requests are continuously batched over `batch_slots` cache rows, each with
its own position clock.  Two host loops over the same decode segments:

  per-token (`step`)       — one dispatch and one host sync per token.
  streamed  (`run_stream`) — `seg_len`-token segments; segment i+1 is
                             dispatched before segment i's tokens are read
                             back (their copy to pinned host memory is
                             queued right behind segment i), so the host
                             syncs once per segment.

`--quant-weights {q8_0,q4_k}` serves block-quantized projection weights
through the dequant-fused matmul kernel, and `--quant-kv int8` an int8 KV
cache with one scale per (layer, row, KV head, page), dequantized inside
the fused decode kernel.

Each request carries `SamplingParams` (temperature / top_k / top_p /
min_p / seed / stop tokens); `--temperature`, `--top-k`, `--top-p`,
`--seed` and `--stop-eos` set them for the CLI's requests.  Token k of a
request is drawn with the k-th split of its seed's key, on the device, so
a fixed seed gives the same tokens at any `seg_len`, in either loop, in
any slot and beside any batch-mates; greedy requests decode by argmax.

`--spec` serves by speculative draft-and-verify: a draft model (`--draft
self:N`, the target's first N blocks, or another ported arch sharing the
vocabulary) proposes `--spec-k` tokens a slot, and one multi-position
forward of the target verifies them; a segment is `seg_len` such rounds.
Greedy requests emit the verify forward's argmax stream, for any draft;
sampled ones keep the target's sampling distribution (rejection
sampling), their keys split once a round.  On the CPU a greedy spec
stream is bitwise the non-speculative one.  On the card the verify's
products run over B (k + 1) rows where a decode step's run over B, and
cuBLAS chooses its kernel by the row count, so at a near tie the two
streams can part.  The draft steps run padded to the verify's row count
(`models/quantize.padded_rows`), so a full-depth self-draft is accepted
whole on the card too.

An encoder-decoder arch (`--arch whisper_large_v3`) serves requests that
bring their audio frames (`Request.embeds`, the stub frontend's output;
the CLI draws random ones): one encoder pass an admission, shared by the
target's prefill and a self-draft's, writes the slot's cross-K/V, and
every decode step attends over it up to the slot's own clip length.

`--offload` (`host_offload=True`) makes the resident set larger than the
slot count: when waiting requests outnumber free slots, the coldest slots
(at least `--evict-after` segments since their admission) are evicted to
pinned host memory, their pages (every leaf kind) and their slot-state row
copied on a side stream (`core/backstream.py`), and restored into a free
slot one fill later; an evicted stream is bitwise the never-evicted one,
and neither direction adds a decode sync.  `--prefix-cache` keeps a trie
of served prompts' pages in host memory: an admission whose prompt
extends a cached one restores those pages and prefills only the suffix
(`transformer.resume_prefill_into_cache`), and a repeated prompt skips
its prefill (its first token from the stored logits).

`--prefill-chunk C` (`prefill_chunk=C`) admits a prompt longer than C
tokens in C-token chunks, at most one between two decode segments
(`steps.make_chunked_prefill`): the slot is reserved meanwhile, and the
streams in flight keep their tokens and their decode syncs, where a
one-shot prefill of a long prompt would stall them all for its whole
forward.  It is refused with `--spec`, `--prefix-cache` and for an
encoder-decoder, as in the reference.

On the card every decode segment runs as one CUDA graph replay
(`launch/graphs.py`), captured at construction; on the CPU the segments
run eagerly.  Both loops emit identical tokens.

`--mesh DATAxMODEL` (`mesh=`, a `launch/mesh.py` DeviceMesh) serves
SPMD over `torch.distributed`, one process a shard, every rank running
the same host loop on the same requests: the slots split over `data`
(each data group holds its rows' cache and slot state, runs its products
padded to the whole batch's rows, and gathers its rows' tokens and
verdicts at every decode sync, so every rank's scheduler decides alike),
the parameters are replicated (every rank draws them from the same
seed), and the decode attention splits by head group over `model`
(`core/backstream.py`), its statistics crossing ranks in one all-gather
a merge.  Tokens, decode syncs and the page ledger are bitwise the
single-device server's for every mesh shape, with the host tier, the
prefix cache and chunked admission too (a snapshot moves between data
groups when a restore or a hit lands in another group's slot:
`tier_moves`, `tier_bytes_moved`); `wire_bytes_per_shard` counts the
attention statistics' bytes (`core/ring.py` `WireLedger`).  Gloo's
collectives cannot be captured in a CUDA graph, so under a mesh the
segments run eagerly on the card too.  Run it with `torchrun
--nproc-per-node N -m repro_torch.launch.serve --mesh DxM`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.backstream import (HostSnapshot, HostTier, Layout,
                                         OffloadConfig, OffloadProtocol,
                                         PrefixCache, SnapshotStub,
                                         broadcast_leaves, move_snapshot,
                                         snapshot_layout,
                                         stream_offload_to_device,
                                         stream_offload_to_host,
                                         use_offload)
from repro_torch.core import prng
from repro_torch.core import ring as ring_lib
from repro_torch.kernels import ops
from repro_torch.kernels.quant import QTensor
from repro_torch.launch import graphs
from repro_torch.launch import partition
from repro_torch.launch import steps as steps_lib
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.quantize import padded_rows, quantize_params
from repro_torch.models.registry import get_model
from repro_torch.sharding import ShardingRules, use_rules

PROTOCOLS = {"bs": OffloadProtocol.BS, "axle": OffloadProtocol.AXLE,
             "rp": OffloadProtocol.RP}


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding control.

    temperature — 0 (default) decodes greedily (argmax, no randomness
                  consumed); > 0 samples from the temperature-scaled
                  distribution.
    top_k       — keep only the k most probable tokens (0 = off; 1 is
                  greedy).
    top_p       — nucleus: keep the smallest most-probable set with mass
                  >= top_p (1.0 = off).
    min_p       — drop tokens below min_p x the best token's probability
                  (0.0 = off).
    seed        — the request's PRNG seed: token k is drawn with the k-th
                  split of its key, whatever the segmentation, slot or
                  batch-mates.
    stop_tokens — ids that end the request (at most
                  steps.MAX_STOP_TOKENS); the stop token itself is the
                  last generated token."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0
    stop_tokens: Tuple[int, ...] = ()

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0 or self.top_k == 1


GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    """One serving request.

    prompt      — (prompt_len,) int32 token ids.
    max_new     — token budget; the first token comes from the prefill.
    sampling    — its SamplingParams; None decodes greedily.
    stop_tokens — ids that end the request, as `sampling.stop_tokens`
                  (a request may set one of the two, not both).
    embeds      — encoder-decoder archs only: (e, d_model) float32 frame
                  embeddings from the (stubbed) audio frontend, e <=
                  enc_len; a clip shorter than enc_len is served at its
                  length.  None: enc_len frames of silence (zeros).
    generated   — filled by the server, in order.
    spec_accepted / spec_proposed — under speculative serving, this
                  request's draft tokens accepted and proposed, stamped
                  at retirement from the device counters; None otherwise
                  (and for a request that ended at its first token).
    suspensions — how often the host tier evicted this request's slot
                  (its stream is the same either way)."""
    rid: int
    prompt: np.ndarray
    max_new: int
    stop_tokens: Tuple[int, ...] = ()
    generated: Optional[List[int]] = None
    sampling: Optional[SamplingParams] = None
    spec_accepted: Optional[int] = None
    spec_proposed: Optional[int] = None
    embeds: Optional[np.ndarray] = None
    suspensions: int = 0

    @property
    def sampling_params(self) -> SamplingParams:
        """The request's SamplingParams, its `stop_tokens` folded in."""
        sp = self.sampling or GREEDY
        if self.stop_tokens:
            sp = dataclasses.replace(sp, stop_tokens=tuple(self.stop_tokens))
        return sp


def _check_prefill_chunk(cfg: ArchConfig, chunk: int, spec: bool,
                         prefix_cache: bool) -> None:
    """The refusals of `prefill_chunk` (ValueError): a chunk of fewer
    than one token; speculation (the draft cache has no chunked prefill);
    the prefix cache (its pages come from one-shot prefills); an
    encoder-decoder (its admission runs the encoder, and it has no resume
    prefill)."""
    if chunk < 1:
        raise ValueError(f"prefill_chunk {chunk}: a chunk needs a token")
    if spec:
        raise ValueError("prefill_chunk with spec: the draft cache has no "
                         "chunked prefill")
    if prefix_cache:
        raise ValueError("prefill_chunk with prefix_cache: the prefix "
                         "cache's pages come from one-shot prefills")
    if cfg.enc_dec:
        raise ValueError(f"prefill_chunk with {cfg.arch_id}: an "
                         "encoder-decoder admits through its encoder, "
                         "not by chunks")


def _prefill_bucket(n: int, cap: int) -> int:
    """Pad prompt lengths to powers of two (>= 8), capped at `cap`."""
    p = 8
    while p < n:
        p *= 2
    return min(p, cap)


class BatchedServer:
    """Slot-based continuous batching over a fixed decode batch.

    Each of `batch_slots` cache rows is a serving slot: a queued Request
    is admitted into a free slot by a real prefill, decodes (greedy or
    sampled with its own PRNG key) until its budget is spent or it emits
    a stop token, then retires and frees the slot.  `positions[s]` is the
    position of the token in `tokens[s]`: it starts at len(prompt) and
    advances per row, so a request's tokens do not depend on its slot or
    its batch-mates.

    A row WITHOUT stop tokens ends only by budget, which the host knows at
    dispatch: it retires then.  A row WITH stop tokens ends when the
    device says so; the host learns it one segment later.  A segment with
    a sampled or stopping row takes the full variant, one with only
    greedy stop-free rows the `plain` one.

    On the card the four segment functions (full and plain, at `seg_len`
    and at 1) are captured as CUDA graphs here, before any admission, and
    every segment is one replay (`graph_replays` counts them); a capture
    or launch failure raises.

    `params` are the weights to serve in the reference's layout; None
    draws the port's own from seed 0 on `device`.  `quant` quantizes
    them once, here (the server then holds no fp projection stack of its
    own), and gives the cache int8 K/V pools.  `cfg` replaces the arch's
    config, for a model that one card cannot hold: its CARD
    (`configs.get_card_config`, the full widths cut in depth).

    `spec=True` makes the four segment functions speculative: a segment
    is `seg_len` rounds of `spec_k` draft proposals and one verify
    forward, a step one round.  The draft is `draft_arch` (default: the
    config's): "self:N" is the target's first N blocks ("self" half the
    depth), views of the (quantized) target weights; another ported arch
    id is a model of its own, with `draft_params` (the reference's
    layout) or the port's own weights from seed 1.  The draft keeps its
    own cache (fp K/V, the default page size, as the reference's), filled
    by its own prefill at admission.  A round's emit count depends on
    the device's verdict, so every row is retired by the device's alive
    bit, and a request needs `len(prompt) + max_new + spec_k <= max_seq`
    (the verify writes up to spec_k rows past the final clock).

    An encoder-decoder config takes its functions from `models/encdec.py`
    (`registry.get_model`) and encodes each request's frames once at
    admission (`encoder_passes` counts the passes): a self-draft shares
    the target's encoder, so its prefill reuses that output
    (`draft_shares_encoder`); another enc-dec draft encodes again.

    `host_offload=True` evicts cold slots to the host tier when waiting
    requests outnumber free slots (`_evict_for_demand`: the oldest rows
    of at least `evict_after` segments since admission) and restores them
    into free slots later (`_restore`), the pages streamed in
    `offload_chunks` chunks a leaf; under speculation the draft cache's
    row travels with the target's as one paired page set.
    `prefix_cache=True` reuses served prompts' pages (`_admit_prefill`);
    it is refused with `spec` (the draft cache has no prefix pages) and
    for an encoder-decoder (its prompts are keyed on audio frames).

    `prefill_chunk=C` admits a prompt longer than C in C-token chunks
    (`_begin_chunked` reserves a slot, `_pump_prefill` dispatches at most
    one chunk a loop tick, behind the decode segment just dispatched, on
    the same stream); while a slot is reserved every segment takes the
    write-masked variant, which leaves the slot's rows alone.  Every chunk
    is padded to C, so a prompt needs ceil(P / C) C <= max_seq (`submit`
    refuses it otherwise).  Refused with `spec`, `prefix_cache` and for
    an encoder-decoder (no resume prefill).

    `mesh` (a ("data", "model") DeviceMesh of the process group this
    rank belongs to) serves SPMD: every rank constructs the server alike
    and runs the same loop on the same requests.  The serving rules are
    `ShardingRules(mesh, head_shard_attn=True)` and `PartitionPlan(fsdp=
    False)`: parameters replicated (checked at construction by one
    gathered checksum), slot rows split over `data` (`batch_slots` must
    divide), the decode attention split by head group over `model`.
    Every rank runs every plain admission's prefill, for its first token;
    only the data group that owns the slot keeps the cache writes (the
    others prefill into a one-row scratch cache).  At each decode sync a
    data group gathers the rows' tokens, emit masks and verdicts.  The
    segments run eagerly (no CUDA graph), under a data split with every
    product padded to the whole batch's rows (`segment_scope`), and a
    speculative draft decodes with its attention whole on every rank.

    Under a data split the host tier, the prefix cache and chunked
    admission keep one host loop on every rank (the same queue, eviction
    choice, prefix keys and LRU, chunk plan, ledger and counters); the
    device work and the bytes belong to the slot's data group alone.  A
    snapshot is held by the group that took it (`HostSnapshot.holder`;
    the other ranks store a `SnapshotStub` of its size under the same
    key), and a restore or a prefix hit into another group's slot moves
    it there first (`_fetch`: `tier_moves`, `tier_bytes_moved`).  What
    one group computes or holds and every rank needs, a hit's or a last
    chunk's logits and a restored slot-state row, it broadcasts over the
    data axis: one small tensor an admission or restore.  Tokens, decode
    syncs, the ledger and the tier's counts stay the single device's."""

    def __init__(self, arch_id: str, *, smoke: bool = True,
                 device: Optional[str] = None, batch_slots: int = 4,
                 max_seq: int = 256, protocol: str = "axle",
                 chunks_per_shard: int = 1, seg_len: int = 8,
                 stream: bool = False, page_size: Optional[int] = None,
                 params: Optional[Dict[str, Any]] = None,
                 quant: Optional[steps_lib.QuantConfig] = None,
                 spec: bool = False, spec_k: int = 3,
                 draft_arch: Optional[str] = None,
                 draft_params: Optional[Dict[str, Any]] = None,
                 cfg: Optional[ArchConfig] = None,
                 host_offload: bool = False, prefix_cache: bool = False,
                 evict_after: int = 1, offload_chunks: int = 2,
                 prefill_chunk: Optional[int] = None, mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg or (get_smoke_config(arch_id) if smoke
                           else get_config(arch_id))
        self._init_mesh(mesh, batch_slots)
        if prefill_chunk is not None:
            _check_prefill_chunk(self.cfg, prefill_chunk, spec, prefix_cache)
        if prefix_cache and spec:
            raise ValueError("prefix_cache with spec: the draft cache has "
                             "no prefix pages to reuse")
        if prefix_cache and self.cfg.enc_dec:
            raise ValueError(f"prefix_cache with {self.cfg.arch_id}: an "
                             "encoder-decoder's prompts are keyed on audio "
                             "frames, not token prefixes")
        self.batch = batch_slots
        self.max_seq = max_seq
        self.seg_len = seg_len
        self.stream = stream
        self.offload = OffloadConfig(protocol=PROTOCOLS[protocol],
                                     chunks_per_shard=chunks_per_shard)
        self.model = get_model(self.cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = self.model.init_params(self.cfg, gen, self.device)
        self.quant = quant or steps_lib.QuantConfig()
        if self.quant.weights is not None:
            params = quantize_params(params, self.quant.weights)
        self.params = params
        if self.rules is not None:
            self._check_replicated(self.params)
        # this rank's rows of the slots (all of them off a mesh)
        self.cache = self.model.init_cache(self.cfg, self.rows_local,
                                           max_seq, device=self.device,
                                           page_size=page_size,
                                           kv_quant=self.quant.kv)
        self._page_size_arg = page_size
        self._scratch = None    # the prefill cache of another group's slot
        # page ledger: one page = `page_size` positions of one slot row,
        # charged as the position clock advances and released at
        # retirement; allocated == freed + resident at every tick.  A
        # cache without attention has no page table: the ledger still
        # tracks the logical span at the default page size, as the
        # reference's does
        self.page_size = (transformer.cache_page_size(self.cache)
                          if "page_table" in self.cache
                          else transformer.default_page_size(max_seq))
        self.pages_allocated = 0
        self.pages_freed = 0
        self.pages_resident_peak = 0
        self.slot_pages = np.zeros((batch_slots,), np.int64)
        # an enc-dec prefill takes the encoder output of the admission's
        # one encoder pass
        self.prefill_fn = steps_lib.make_prefill_into_cache(
            self.cfg, from_enc_out=self.cfg.enc_dec)
        self.encoder_passes = 0
        self.draft_shares_encoder = False
        self.state = steps_lib.init_slot_state(self.rows_local, self.device)
        self.spec = spec
        self.spec_k = spec_k
        self.draft_accepted = 0
        self.draft_proposed = 0
        if spec:
            self._init_draft(draft_arch, draft_params, smoke)
            fns = [steps_lib.make_spec_decode_segment(
                self.cfg, self.draft_cfg, n, spec_k, plain=plain)
                for n in (1, seg_len) for plain in (False, True)]
            statics = ((self.params, self.draft_params),
                       (self.cache, self.draft_cache))
        else:
            fns = [steps_lib.make_decode_segment(self.cfg, n, plain=plain)
                   for n in (1, seg_len) for plain in (False, True)]
            statics = ((self.params,), (self.cache,))
        # the functions the two loops call: one round (or token) a step,
        # `seg_len` a streamed segment
        (self.step_fn, self.step_plain_fn, self.segment_fn,
         self.segment_plain_fn) = self._segment_fns(fns, *statics)
        self._init_host_tier(host_offload, prefix_cache, evict_after,
                             offload_chunks)
        # chunked admission: the reserved slots, each with its request,
        # its chunk plan, the next chunk and the prompt on the device
        self.prefill_chunk = prefill_chunk
        self.prefilling: Dict[int, Dict[str, Any]] = {}
        if prefill_chunk is not None:
            self.chunked = steps_lib.make_chunked_prefill(self.cfg)
        self.prefill_chunks = 0            # chunk forwards dispatched
        self.prefill_chunk_time = 0.0      # host seconds, all chunks
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * batch_slots
        # host mirrors of the device state for dispatch-time accounting
        self.positions = np.zeros((batch_slots,), np.int32)
        self.remaining = np.zeros((batch_slots,), np.int32)
        self.completed: List[Request] = []
        self.steps = 0                 # decode token-steps issued
        self.segments_dispatched = 0
        self.prefill_forwards = 0
        self.host_syncs = 0            # every host<->device sync
        self.decode_syncs = 0          # the decode loop's share
        self.tokens_emitted = 0
        self._init_wire()

    def _init_mesh(self, mesh, batch_slots: int) -> None:
        """The serving rules and plan under a mesh, this rank's data rank
        and slot rows [row0, row0 + rows_local), and the data group whose
        rows a decode sync gathers (None without a data split)."""
        self.mesh = mesh
        self.rules = self.plan = self._data_group = None
        self.row0, self.rows_local, self.data_rank = 0, batch_slots, 0
        if mesh is None:
            return
        self.rules = ShardingRules(mesh, head_shard_attn=True)
        self.plan = partition.PartitionPlan(rules=self.rules, fsdp=False)
        n_data = self.rules.data_size()
        if batch_slots % n_data:
            raise ValueError(f"{batch_slots} slots do not split over "
                             f"{n_data} data ranks")
        if n_data > 1:
            self.rows_local = batch_slots // n_data
            self.data_rank = self.rules.rank("data")
            self.row0 = self.data_rank * self.rows_local
            self._data_group = self.rules.group("data")

    def _init_wire(self) -> None:
        """The wire ledger: every decode step merges once per attention
        sublayer of the target (an enc-dec decoder's cross reads too), a
        verify once per position and sublayer; a speculative draft
        decodes with its attention whole, off the wire.  Zero-wire cases
        (no mesh, the replicated regime, no attention) fall out of the
        formula."""
        cfg = self.cfg
        n_attn = cfg.attn_layers_per_block() * cfg.n_blocks
        if cfg.enc_dec:
            n_attn *= 2
        self.merges_per_round = n_attn * self._tokens_per_step
        n_eff = 1
        if self.plan is not None:
            shard_q, _ = partition.serve_head_regime(cfg, self.plan)
            n_eff = self.rules.model_size() if shard_q else 1
        self.wire = ring_lib.WireLedger(
            n_shards=n_eff, rows_local=self.rows_local,
            heads_local=cfg.n_heads // n_eff, head_dim=cfg.head_dim_)

    @property
    def wire_bytes_per_shard(self) -> int:
        """Bytes ONE shard sent on the wire so far: the head groups'
        statistics; 0 off a mesh and in every replicated regime."""
        return self.wire.wire_bytes_per_shard

    def _check_replicated(self, params: Dict[str, Any]) -> None:
        """Every rank drew the same parameters: one int64 sum of each
        leaf's bytes a rank, gathered over the world and compared
        exactly.  Raises if any two ranks' differ."""
        sums = []

        def walk(tree):
            if isinstance(tree, QTensor):
                walk([tree.scales, tree.quants, tree.mins])
            elif isinstance(tree, dict):
                for key in sorted(tree):
                    walk(tree[key])
            elif isinstance(tree, (list, tuple)):
                for t in tree:
                    walk(t)
            elif isinstance(tree, torch.Tensor):
                sums.append(tree.contiguous().view(torch.uint8).sum(
                    dtype=torch.int64))

        walk(params)
        mine = torch.stack(sums).cpu()
        every = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        if not all(torch.equal(mine, other) for other in every):
            raise RuntimeError("the mesh's ranks drew different parameters")

    def _row(self, slot: int) -> Optional[int]:
        """`slot`'s row in this rank's cache and slot state; None when
        another data group holds it."""
        row = slot - self.row0
        return row if 0 <= row < self.rows_local else None

    def _owner(self, slot: int) -> int:
        """The data rank whose group holds `slot`'s row (0 off a data
        split)."""
        return slot // self.rows_local

    def _layout(self, upto: Optional[int] = None) -> Layout:
        """The leaves of a snapshot of one row, alike on every rank (the
        cache's shapes are): an eviction's (`upto` None: the whole row,
        under speculation with the draft's under "draft/" keys) or a
        prefix entry's (the pages of the first `upto` rows and the
        prompt's last-token logits).  Traced once on meta tensors."""
        if upto not in self._layouts:
            def meta(cache):
                return {k: torch.empty_like(v, device="meta")
                        for k, v in cache.items()}
            leaves = self.extract_fn(meta(self.cache), 0, upto)
            if upto is None and self.spec:
                leaves.update({"draft/" + k: v for k, v in
                               self.draft_extract_fn(meta(self.draft_cache),
                                                     0).items()})
            self._layouts[upto] = snapshot_layout(leaves) + (
                () if upto is None else self._logits_layout)
        return self._layouts[upto]

    @functools.cached_property
    def _logits_layout(self) -> Layout:
        """A prompt's last-token logits: (V,) in the embedding's dtype,
        which the output product keeps."""
        embed = self.params["embed"]
        return (("logits", tuple(embed.shape[:1]), embed.dtype),)

    @functools.cached_property
    def _state_layout(self) -> Layout:
        """A saved slot-state row (`steps.save_slot_state`)."""
        return snapshot_layout(steps_lib.save_slot_state(
            steps_lib.init_slot_state(1, torch.device("meta")), 0))

    def _share(self, leaves: Optional[Dict[str, torch.Tensor]],
               layout: Layout, src: int) -> Dict[str, torch.Tensor]:
        """Data rank `src`'s leaves on every rank of this rank's data line:
        one broadcast over the data axis (host tensors on the receivers);
        the leaves themselves off a data split."""
        if self._data_group is None:
            return leaves
        return broadcast_leaves(leaves if self.data_rank == src else None,
                                layout, src, self._data_group)

    def _share_logits(self, logits: Optional[torch.Tensor],
                      slot: int) -> torch.Tensor:
        """A prompt's last-token logits, computed by `slot`'s data group
        alone, on every rank's device: the owner's bits."""
        leaves = None if logits is None else {"logits": logits}
        return self._share(leaves, self._logits_layout,
                           self._owner(slot))["logits"].to(self.device)

    def _fetch(self, snap: HostSnapshot, slot: int
               ) -> Optional[Dict[str, torch.Tensor]]:
        """`snap`'s leaves streamed to the device of the ranks of `slot`'s
        data group (None on every other rank).  When another group holds
        them they move there first (`move_snapshot`), counted in
        `tier_moves` and `tier_bytes_moved` on every rank."""
        src, dst = snap.holder, self._owner(slot)
        if src != dst:
            self.tier_moves += 1
            self.tier_bytes_moved += snap.nbytes
        if self.data_rank not in (src, dst):
            return None
        if src == dst:
            host = snap.materialize()
        else:
            host = move_snapshot(
                snap.materialize() if self.data_rank == src else None,
                snap.layout, src, dst, self.rules,
                pin=self.device.type == "cuda")
            if host is None:
                return None
        with use_offload(self.offload):
            return stream_offload_to_device(host, self.device,
                                            chunks=self.offload_chunks)

    def _scratch_cache(self) -> Dict[str, Any]:
        """The one-row cache the prefill of another data group's slot
        writes into: only its logits are kept."""
        if self._scratch is None:
            self._scratch = self.model.init_cache(
                self.cfg, 1, self.max_seq, device=self.device,
                page_size=self._page_size_arg, kv_quant=self.quant.kv)
        return self._scratch

    def _init_draft(self, draft_arch: Optional[str],
                    draft_params: Optional[Dict[str, Any]],
                    smoke: bool) -> None:
        """Resolve the speculative draft: its config, weights, cache and
        prefill."""
        da = draft_arch or self.cfg.draft_arch
        assert da, (f"{self.cfg.arch_id}: speculative serving needs a "
                    "draft (ArchConfig.draft_arch or draft_arch=)")
        self_draft = da == "self" or da.startswith("self:")
        if self_draft:
            if draft_params is not None:
                raise ValueError("a self-draft is sliced from the target's "
                                 "weights; draft_params is for another arch")
            n = (int(da.split(":", 1)[1]) if ":" in da
                 else max(1, self.cfg.n_blocks // 2))
            self.draft_cfg = steps_lib.self_draft_config(self.cfg, n)
            self.draft_params = steps_lib.self_draft_params(
                self.cfg, self.params, n)
        else:
            self.draft_cfg = (get_smoke_config(da) if smoke
                              else get_config(da))
            assert self.draft_cfg.vocab == self.cfg.vocab, \
                (self.cfg.vocab, self.draft_cfg.vocab)
            assert self.draft_cfg.enc_dec == self.cfg.enc_dec, \
                (self.cfg.arch_id, self.draft_cfg.arch_id)
            if draft_params is None:
                gen = torch.Generator(device=self.device).manual_seed(1)
                draft_params = get_model(self.draft_cfg).init_params(
                    self.draft_cfg, gen, self.device)
            self.draft_params = draft_params
        self.draft_cache = get_model(self.draft_cfg).init_cache(
            self.draft_cfg, self.rows_local, self.max_seq,
            device=self.device)
        # a self-draft's encoder IS the target's: its prefill takes the
        # target's encoder output
        self.draft_shares_encoder = self.cfg.enc_dec and self_draft
        self.draft_prefill_fn = steps_lib.make_prefill_into_cache(
            self.draft_cfg, from_enc_out=self.draft_shares_encoder)

    def _init_host_tier(self, host_offload: bool, prefix_cache: bool,
                        evict_after: int, offload_chunks: int) -> None:
        """The host tier's stores, page functions and counters."""
        self.evict_after = max(1, evict_after)
        self.offload_chunks = offload_chunks
        self.host_tier = HostTier() if host_offload else None
        self.prefix = PrefixCache() if prefix_cache else None
        self.suspended: List[Request] = []
        self.slot_age = np.zeros((self.batch,), np.int64)
        if host_offload or prefix_cache:
            self.extract_fn, self.insert_fn = steps_lib.make_slot_page_fns(
                self.cfg)
            self.resume_fn = steps_lib.make_resume_prefill(self.cfg)
        if host_offload and self.spec:
            # the draft's row leaves and returns with the target's
            self.draft_extract_fn, self.draft_insert_fn = \
                steps_lib.make_slot_page_fns(self.draft_cfg)
        self.evictions = 0
        self.restores = 0
        self.restored_dead = 0         # evicted rows that died in flight
        self.prefix_hits_full = 0
        self.prefix_hits_partial = 0
        self.prefix_misses = 0
        self.prefill_tokens_skipped = 0
        self.evict_dispatch_time = 0.0     # host seconds, all evictions
        self.restore_dispatch_time = 0.0   # host seconds, all restores
        # under a data split: snapshots carried to another data group (a
        # restore's or a prefix hit's) and their bytes; the restores among
        # them and their host seconds
        self.tier_moves = 0
        self.tier_bytes_moved = 0
        self.restores_moved = 0
        self.restore_moved_time = 0.0
        self._layouts: Dict[Optional[int], Layout] = {}

    def _segment_fns(self, fns: List[Any], params: Tuple[Any, ...],
                     caches: Tuple[Dict[str, Any], ...]) -> List[Any]:
        """The segment functions as the loops call them: on the card, each
        captured as a CUDA graph against the live parameters and caches;
        on the CPU, and under a mesh (gloo's collectives cannot be
        captured), as they are."""
        if self.device.type != "cuda" or self.rules is not None:
            return fns
        with use_offload(self.offload):
            # fns[:2] are the one-step (one-round) functions
            return graphs.capture_segments(fns, params, caches, self.state,
                                           warm_up=fns[:2])

    @property
    def _tokens_per_step(self) -> int:
        """Token positions a step issues: one, or a round's spec_k + 1."""
        return self.spec_k + 1 if self.spec else 1

    @property
    def graph_replays(self) -> int:
        """Decode segments run as CUDA graph replays."""
        return sum(getattr(fn, "replays", 0)
                   for fn in (self.step_fn, self.step_plain_fn,
                              self.segment_fn, self.segment_plain_fn))

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.stop_tokens and req.sampling is not None \
                and req.sampling.stop_tokens:
            raise ValueError(f"request {req.rid} sets stop tokens twice: "
                             "in stop_tokens and in sampling.stop_tokens")
        if len(req.sampling_params.stop_tokens) > steps_lib.MAX_STOP_TOKENS:
            raise ValueError(f"request {req.rid}: more than "
                             f"{steps_lib.MAX_STOP_TOKENS} stop tokens")
        if self.cfg.enc_dec and req.embeds is not None:
            shape = np.shape(req.embeds)
            if len(shape) != 2 or not 0 < shape[0] <= self.cfg.enc_len \
                    or shape[1] != self.cfg.d_model:
                raise ValueError(
                    f"request {req.rid}: embeds of shape {shape}; want "
                    f"(e, {self.cfg.d_model}) with 0 < e <= "
                    f"{self.cfg.enc_len}")
        if self.prefill_chunk is not None \
                and len(req.prompt) > self.prefill_chunk \
                and "page_table" in self.cache:
            c = self.prefill_chunk
            rows = -(-len(req.prompt) // c) * c
            if rows > self.max_seq:
                raise ValueError(
                    f"request {req.rid}: a {len(req.prompt)}-token prompt in "
                    f"chunks of {c} writes {rows} rows (every chunk padded "
                    f"to {c}); max_seq is {self.max_seq}")
        req.generated = []
        self.queue.append(req)

    # -- page ledger -------------------------------------------------------

    def _pages_for(self, footprint: int) -> int:
        """Page span of a `footprint`-position row, clamped to the ring."""
        return -(-min(int(footprint), self.max_seq) // self.page_size)

    def _set_pages(self, slot: int, n: int) -> None:
        """Set slot's resident page count to exactly `n`, charging or
        releasing the difference."""
        cur = int(self.slot_pages[slot])
        assert n >= 0, (slot, n)
        if n > cur:
            self.pages_allocated += n - cur
        else:
            self.pages_freed += cur - n
        self.slot_pages[slot] = n
        self.pages_resident_peak = max(self.pages_resident_peak,
                                       self.pages_resident)

    def _free_pages(self, slot: int) -> None:
        self._set_pages(slot, 0)

    @property
    def pages_resident(self) -> int:
        """Pages charged to occupied slots: active ones and those between
        the chunks of an admission."""
        return int(self.slot_pages.sum())

    def assert_ledger(self) -> None:
        """Every page charged is freed or resident in an occupied slot, and
        no free slot holds pages."""
        assert self.pages_allocated == self.pages_freed \
            + self.pages_resident, (self.pages_allocated, self.pages_freed,
                                    self.pages_resident)
        for s in range(self.batch):
            if self.active[s] is None and s not in self.prefilling:
                assert self.slot_pages[s] == 0, (s, self.slot_pages[s])

    def _frames(self, req: Request) -> torch.Tensor:
        """An enc-dec request's frame embeddings (1, e, D) f32 on the
        device: its own (shape checked by `submit`), or enc_len frames of
        silence."""
        emb = req.embeds
        if emb is None:        # silence: the stub frontend's zero frames
            emb = np.zeros((self.cfg.enc_len, self.cfg.d_model), np.float32)
        return torch.from_numpy(np.asarray(emb, np.float32)).to(
            self.device)[None]

    def _prefill(self, slot: int, req: Request) -> torch.Tensor:
        """The whole prompt through the prefill step, its K/V written into
        this slot's cache rows; an enc-dec request's frames through ONE
        encoder pass first, whose output every prefill of the admission
        takes (a foreign enc-dec draft encodes again).  Returns the last
        prompt position's logits (on the device, no sync)."""
        plen = len(req.prompt)
        assert plen <= self.max_seq, (plen, self.max_seq)
        padded = np.zeros((_prefill_bucket(plen, self.max_seq),), np.int32)
        padded[:plen] = req.prompt
        tokens = torch.from_numpy(padded).to(self.device)
        row = self._row(slot)
        with use_offload(self.offload):
            args = draft_args = ()
            if self.cfg.enc_dec:
                frames = self._frames(req)
                args = (encdec.encode(self.cfg, self.params, frames),)
                self.encoder_passes += 1
                draft_args = args if self.draft_shares_encoder \
                    else (frames,)
            if row is None:
                # another data group's slot: for the first token only
                logits, self._scratch = self.prefill_fn(
                    self.params, self._scratch_cache(), tokens, 0, plen,
                    *args)
            else:
                logits, self.cache = self.prefill_fn(
                    self.params, self.cache, tokens, row, plen, *args)
            if self.spec and row is not None:
                # the draft's own prompt state; its logits are not used
                # (the first token comes from the target)
                if self.cfg.enc_dec and not self.draft_shares_encoder:
                    self.encoder_passes += 1
                _, self.draft_cache = self.draft_prefill_fn(
                    self.draft_params, self.draft_cache, tokens, row, plen,
                    *draft_args)
        self.prefill_forwards += 1
        return logits

    # -- prefix cache ------------------------------------------------------

    def _admit_prefill(self, slot: int, req: Request) -> torch.Tensor:
        """The prompt's admission through the prefix cache, its longest
        cached prefix served from host pages before any prefill compute:

          full hit    — the whole prompt is cached: its pages go into the
                        slot and its STORED last-token logits come back;
                        no forward.  Bitwise the admission that stored
                        them (a fresh prefill's bits when a miss stored
                        them: the same prompt, the same bucket).
          partial hit — the prefix's pages go in, then only the suffix
                        runs (`resume_fn`); token-equal to a full
                        prefill.  A miss instead when the bucketed suffix
                        would pass max_seq.
          miss        — the full prefill.
        A partial hit and a miss then store the prompt's pages
        (`_prefix_put`).  Returns the last prompt position's logits."""
        if self.prefix is None:
            return self._prefill(slot, req)
        plen = len(req.prompt)
        hit = self.prefix.lookup(req.prompt)
        row = self._row(slot)
        if hit is not None and hit.length == plen:
            dev = self._fetch(hit.pages, slot)
            logits = None
            if dev is not None:
                logits = dev.pop("logits")
                with use_offload(self.offload):
                    self.cache = self.insert_fn(self.cache, dev, row)
            logits = self._share_logits(logits, slot)
            self.prefix_hits_full += 1
            self.prefill_tokens_skipped += plen
            return logits
        if hit is not None:
            start = hit.length
            sbucket = _prefill_bucket(plen - start, self.max_seq)
            if start + sbucket <= self.max_seq:
                suffix = np.zeros((sbucket,), np.int32)
                suffix[:plen - start] = req.prompt[start:]
                dev = self._fetch(hit.pages, slot)
                logits = None
                if dev is not None:
                    dev.pop("logits")
                    with use_offload(self.offload):
                        self.cache = self.insert_fn(self.cache, dev, row)
                        logits, self.cache = self.resume_fn(
                            self.params, self.cache,
                            torch.from_numpy(suffix).to(self.device), row,
                            plen, start)
                logits = self._share_logits(logits, slot)
                self.prefix_hits_partial += 1
                self.prefill_tokens_skipped += start
                self.prefill_forwards += 1
                self._prefix_put(slot, req, logits)
                return logits
        self.prefix_misses += 1
        logits = self._prefill(slot, req)
        self._prefix_put(slot, req, logits)
        return logits

    def _prefix_put(self, slot: int, req: Request,
                    logits: torch.Tensor) -> None:
        """Store the prompt's freshly written pages in the trie: K/V rows
        up to its prefill bucket (the junk between the prompt's end and
        the bucket stays invisible behind any later clock), the
        post-prompt recurrent state and the last-token logits, streamed
        to the host as an eviction's are: no sync."""
        bucket = _prefill_bucket(len(req.prompt), self.max_seq)
        row = self._row(slot)
        if row is None:     # another data group holds the pages
            self.prefix.put(req.prompt, SnapshotStub(self._layout(bucket),
                                                     self._owner(slot)))
            return
        with use_offload(self.offload):
            pages = self.extract_fn(self.cache, row, bucket)
        pages["logits"] = logits
        self.prefix.put(req.prompt, stream_offload_to_host(
            pages, chunks=self.offload_chunks, holder=self.data_rank))

    # -- host tier: eviction and restore -------------------------------------

    def suspend_slot(self, slot: int) -> None:
        """Evict an active slot to the host tier: its pages (every leaf
        kind; under speculation the draft cache's row too, under
        "draft/" keys) are gathered into staging tensors on the serving
        stream, so they hold the rows as the segment in flight leaves
        them and before anything queued later (a new admission into the
        slot) writes them; its slot-state row is copied the same way, and
        the row is frozen on the device (`steps.freeze_slot`).  Both go to
        pinned host memory on the side stream: the dispatch never waits.
        The request joins the `suspended` FIFO."""
        req = self.active[slot]
        assert req is not None
        t0 = time.perf_counter()
        row = self._row(slot)
        if row is None:
            # another data group's row: stubs of its snapshots' sizes
            owner = self._owner(slot)
            snap = SnapshotStub(self._layout(), owner)
            saved = SnapshotStub(self._state_layout, owner)
        else:
            with use_offload(self.offload):
                pages = self.extract_fn(self.cache, row)
                if self.spec:
                    dpages = self.draft_extract_fn(self.draft_cache, row)
                    pages.update({"draft/" + k: v
                                  for k, v in dpages.items()})
            snap = stream_offload_to_host(pages, chunks=self.offload_chunks,
                                          holder=self.data_rank)
            saved = stream_offload_to_host(
                steps_lib.save_slot_state(self.state, row),
                holder=self.data_rank)
            # the row stops decoding on the device (its state is saved)
            self.state = steps_lib.freeze_slot(self.state, row)
        self.host_tier.put(req.rid, snap, saved)
        self.active[slot] = None
        self._free_pages(slot)
        self.suspended.append(req)
        req.suspensions += 1
        self.evictions += 1
        self.evict_dispatch_time += time.perf_counter() - t0

    def _restore(self, slot: int, req: Request) -> bool:
        """Re-admit a suspended request from the host tier into `slot`.
        Reading its saved slot-state row is the one host sync (counted as
        an admission's is; its copy was issued at eviction and queued
        before nothing else on the side stream but the pages', so both
        have landed).  The pages go back through the side stream into
        staging tensors and are inserted in place on the serving stream,
        behind the segment in flight: no decode sync.  Returns False (the
        request is complete, the slot stays free) when the row died in
        the segment that was in flight at its eviction; its tokens were
        delivered there."""
        t0 = time.perf_counter()
        snap, saved_snap = self.host_tier.pop(req.rid)
        holder = saved_snap.holder
        saved = self._share(
            saved_snap.materialize() if holder == self.data_rank else None,
            self._state_layout, holder)
        self.host_syncs += 1
        if not bool(saved["alive"]):
            if self.spec:
                req.spec_accepted = int(saved["accepted"])
                req.spec_proposed = int(saved["proposed"])
            self.restored_dead += 1
            self.restore_dispatch_time += time.perf_counter() - t0
            return False
        pages = self._fetch(snap, slot)
        row = self._row(slot)
        if row is not None:
            draft = {k[len("draft/"):]: v for k, v in pages.items()
                     if k.startswith("draft/")}
            pages = {k: v for k, v in pages.items()
                     if not k.startswith("draft/")}
            with use_offload(self.offload):
                self.cache = self.insert_fn(self.cache, pages, row)
                if self.spec:
                    self.draft_cache = self.draft_insert_fn(
                        self.draft_cache, draft, row)
            self.state = steps_lib.restore_slot(self.state, row, saved)
        self.positions[slot] = int(saved["position"])
        self.remaining[slot] = int(saved["remaining"])
        # the restored clock's pages; the eviction freed as many
        self._set_pages(slot, self._pages_for(self.positions[slot]))
        self.slot_age[slot] = 0
        self.restores += 1
        dt = time.perf_counter() - t0
        self.restore_dispatch_time += dt
        if snap.holder != self._owner(slot):
            self.restores_moved += 1
            self.restore_moved_time += dt
        return True

    def _evict_for_demand(self) -> None:
        """When waiting requests (queued and suspended) outnumber free
        slots, evict the oldest active rows (most segments since their
        admission or restore), never one younger than `evict_after`
        segments: the quantum that keeps the loop round-robin.  A slot
        reserved for a chunked admission is neither free nor evictable."""
        free = sum(r is None and s not in self.prefilling
                   for s, r in enumerate(self.active))
        need = len(self.queue) + len(self.suspended) - free
        if need <= 0:
            return
        eligible = sorted(
            (s for s in range(self.batch)
             if self.active[s] is not None
             and self.slot_age[s] >= self.evict_after),
            key=lambda s: -self.slot_age[s])
        for s in eligible[:need]:
            self.suspend_slot(s)

    # -- admission -------------------------------------------------------------

    def _admit(self, slot: int, req: Request) -> bool:
        """Prefill (through the prefix cache when it is on), first token,
        device state seeding.  Returns False if the request finished on
        its first token."""
        if self.spec:
            # a verify writes up to spec_k rows past a row's final
            # position: keep them off the valid prefix
            assert len(req.prompt) + req.max_new + self.spec_k \
                <= self.max_seq, (len(req.prompt), req.max_new,
                                  self.spec_k, self.max_seq)
        logits = self._admit_prefill(slot, req)
        self._set_pages(slot, self._pages_for(len(req.prompt)))
        return self._finish_admit(slot, req, logits)

    def _finish_admit(self, slot: int, req: Request,
                      logits: torch.Tensor) -> bool:
        """The first token from the prompt's last logits (the one
        admission host sync), drawn with split #0 of the request's seed
        key (`key, sub = split(PRNGKey(seed))`; a greedy request takes the
        argmax, which is what sampling gives it), and the slot's device
        state, which keeps `key`."""
        sp = req.sampling_params
        key, sub = prng.split(prng.PRNGKey(sp.seed, self.device))
        if sp.greedy:
            first = int(logits.argmax())
        else:
            f32 = dict(dtype=torch.float32, device=self.device)
            one = ops.BatchedSampling(
                temperature=torch.full((1,), sp.temperature, **f32),
                top_k=torch.full((1,), sp.top_k, dtype=torch.int32,
                                 device=self.device),
                top_p=torch.full((1,), sp.top_p, **f32),
                min_p=torch.full((1,), sp.min_p, **f32))
            first = int(ops.sample_tokens(logits[None], one, sub[None],
                                          vocab=self.cfg.vocab)[0])
        self.host_syncs += 1
        req.generated.append(first)
        self.tokens_emitted += 1
        remaining = req.max_new - 1
        if remaining <= 0 or first in sp.stop_tokens:
            return False
        self.positions[slot] = len(req.prompt)
        self.remaining[slot] = remaining
        row = self._row(slot)
        if row is None:
            return True          # another data group's row
        self.state = steps_lib.admit_slot(
            self.state, row, token=first, position=len(req.prompt),
            key=key, remaining=remaining, temperature=sp.temperature,
            top_k=sp.top_k, top_p=sp.top_p, min_p=sp.min_p,
            stop=sp.stop_tokens)
        return True

    # -- chunked admission -------------------------------------------------

    def _begin_chunked(self, slot: int, req: Request) -> None:
        """Reserve `slot` for a chunked admission: it joins `prefilling`,
        which keeps it out of decode dispatch, slot filling and eviction.
        No forward runs and no page is charged here: each chunk charges
        the pages its rows land in.  The prompt, padded to whole chunks,
        goes to the device now, from pinned memory on the serving stream,
        without a wait: a chunk is then a view of it."""
        plen = len(req.prompt)
        assert plen <= self.max_seq, (plen, self.max_seq)
        plan = self.chunked.plan(plen, self.prefill_chunk)
        padded = np.zeros((len(plan) * self.prefill_chunk,), np.int32)
        padded[:plen] = req.prompt
        tokens = torch.from_numpy(padded)
        if self._row(slot) is None:
            tokens = None       # another data group runs the chunks
        else:
            if self.device.type == "cuda":
                tokens = tokens.pin_memory()
            tokens = tokens.to(self.device, non_blocking=True)
        self.prefilling[slot] = {"req": req, "plan": plan, "next": 0,
                                 "tokens": tokens}

    def _pump_prefill(self) -> None:
        """Dispatch AT MOST ONE prefill chunk, of the lowest reserved slot:
        between two decode segments the device sees at most one bounded
        chunk forward, so the streams in flight keep their tokens and
        their decode syncs while a long prompt admits.  A chunk is pure
        dispatch on the serving stream, behind the segment just
        dispatched; the only host sync is the last chunk's first token
        (`_finish_admit`, counted as an admission's)."""
        if not self.prefilling:
            return
        slot = min(self.prefilling)
        st = self.prefilling[slot]
        req = st["req"]
        start, size = st["plan"][st["next"]]
        c = self.prefill_chunk
        row = self._row(slot)
        logits = None
        t0 = time.perf_counter()
        if row is not None:
            chunk = st["tokens"][start:start + c]
            with use_offload(self.offload):
                if start == 0:
                    logits, self.cache = self.chunked.first(
                        self.params, self.cache, chunk, row, size)
                else:
                    logits, self.cache = self.chunked.resume(
                        self.params, self.cache, chunk, row, start + size,
                        start)
        self.prefill_chunk_time += time.perf_counter() - t0
        self.prefill_chunks += 1
        self._set_pages(slot, self._pages_for(start + size))
        st["next"] += 1
        if st["next"] < len(st["plan"]):
            return
        # the last chunk's logits are the prompt's last-token logits (the
        # owning data group's, on every rank)
        logits = self._share_logits(logits, slot)
        del self.prefilling[slot]
        self.prefill_forwards += 1
        if self._finish_admit(slot, req, logits):
            self.active[slot] = req
            self.slot_age[slot] = 0
        else:
            self.completed.append(req)     # finished on its first token
            self._free_pages(slot)

    def _fill_slots(self) -> None:
        """Fill free slots: suspended requests first (FIFO: they were
        admitted before anything still queued), then queued ones by a
        prefill, or by a chunked admission when longer than
        `prefill_chunk`.  Under host offload the eviction policy runs
        first.  Only requests suspended BEFORE this call are restorable:
        one evicted now may still be in the undelivered segment in
        flight, and restoring it before that segment is consumed would
        count the segment's advance twice in the host mirrors."""
        restorable = len(self.suspended)
        if self.host_tier is not None:
            self._evict_for_demand()
        for s in range(self.batch):
            if self.active[s] is not None or s in self.prefilling:
                continue
            if restorable > 0 and self.suspended:
                restorable -= 1
                req = self.suspended.pop(0)
                if self._restore(s, req):
                    self.active[s] = req
                else:
                    self.completed.append(req)    # died while evicted
                continue
            if not self.queue:
                continue
            req = self.queue.pop(0)
            if self.prefill_chunk is not None \
                    and len(req.prompt) > self.prefill_chunk:
                self._begin_chunked(s, req)
                continue
            self.active[s] = req
            self.slot_age[s] = 0
            if not self._admit(s, req):
                self.completed.append(req)
                self.active[s] = None
                self._free_pages(s)

    def _dispatch_rows(self, seg_len: int
                       ) -> Tuple[Dict[int, Tuple[Request, Optional[int]]],
                                  bool]:
        """Slot accounting at dispatch.  A row without stop tokens takes
        `take = min(seg_len, remaining)` tokens, known now: it retires
        at once if that spends its budget, and its slot refills while the
        segment is in flight.  A row with stop tokens is `(req, None)`:
        the device decides, and `_consume_segment` retires it.

        Returns (rows, plain): `plain` when every dispatched row is greedy
        with no stop set, so the segment can skip the sampling epilogue,
        the write mask and the stop test; never while a slot is reserved
        for a chunked admission: the plain segment writes every row, the
        dead ones too, at their stale clocks, over the rows the slot's
        chunks wrote.

        Under speculation a row's emit count is the device's verdict, so
        every row is `(req, None)`, charged the worst case of `seg_len`
        rounds of spec_k + 1 tokens plus the spec_k rows a verify writes
        past the clock, trimmed back at consume."""
        rows: Dict[int, Tuple[Request, Optional[int]]] = {}
        plain = not self.prefilling
        for s in range(self.batch):
            req = self.active[s]
            if req is None:
                continue
            self.slot_age[s] += 1       # segments since (re-)admission
            sp = req.sampling_params
            if not sp.greedy:
                plain = False
            if self.spec:
                if sp.stop_tokens:
                    plain = False
                self._set_pages(s, max(
                    int(self.slot_pages[s]),
                    self._pages_for(self.positions[s]
                                    + seg_len * (self.spec_k + 1)
                                    + self.spec_k)))
                rows[s] = (req, None)
                continue
            if sp.stop_tokens:
                plain = False
                # charge the full segment span, trimmed back at consume
                self._set_pages(s, max(
                    int(self.slot_pages[s]),
                    self._pages_for(self.positions[s] + seg_len)))
                rows[s] = (req, None)
                continue
            take = int(min(seg_len, self.remaining[s]))
            self.remaining[s] -= take
            self._set_pages(s, max(int(self.slot_pages[s]),
                                   self._pages_for(self.positions[s]
                                                   + take)))
            rows[s] = (req, take)
            if self.remaining[s] <= 0:
                self.completed.append(req)
                self.active[s] = None
                self._free_pages(s)
        return rows, plain

    @contextlib.contextmanager
    def segment_scope(self) -> Iterator[None]:
        """What a decode segment runs under: the offload protocol, the
        mesh's rules and, under a data split, every fp product and norm
        padded to the whole batch's rows (a round's under speculation):
        on the card cuBLAS picks its kernel by the row count, and a data
        group's rows then take the single device's bits."""
        pad = (self.batch * self._tokens_per_step
               if self._data_group is not None else 0)
        with use_offload(self.offload), use_rules(self.rules), \
                padded_rows(pad):
            yield

    def _run_segment(self, fn) -> Tuple[Any, ...]:
        """Dispatch one segment and queue the copy of what the host needs
        from it (tokens, emit masks, alive, remaining, positions; under
        speculation also the accept lengths and the draft counters) to
        host memory.  Returns (host tensors, event to wait on or None)."""
        with self.segment_scope():
            if self.spec:
                seg, emit, alens, self.state, self.cache, \
                    self.draft_cache = fn(self.params, self.draft_params,
                                          self.cache, self.draft_cache,
                                          self.state)
            else:
                seg, emit, self.state, self.cache = fn(
                    self.params, self.cache, self.state)
        st = self.state
        fetch = (seg, emit, st.alive, st.remaining, st.positions)
        if self.spec:
            fetch += (alens, st.accepted, st.proposed)
        if self.device.type != "cuda":
            return fetch, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in fetch)
        done = torch.cuda.Event()
        done.record()
        return host, done

    # -- per-token loop ------------------------------------------------------

    def step(self) -> None:
        """One token for every active slot (under speculation one round,
        up to spec_k + 1 tokens): a one-step segment consumed at once,
        one dispatch and one host sync each."""
        self._fill_slots()
        self._pump_prefill()       # at most one admission chunk a step
        self.assert_ledger()
        if all(r is None for r in self.active):
            return
        rows, plain = self._dispatch_rows(1)
        fetched = self._run_segment(self.step_plain_fn if plain
                                    else self.step_fn)
        self.steps += self._tokens_per_step
        self.wire.charge_merges(self.merges_per_round)
        self._consume_segment(fetched, rows)
        self.assert_ledger()

    # -- streamed loop -------------------------------------------------------

    def run_stream(self, max_steps: int = 10_000) -> None:
        """Decode in `seg_len`-token segments, reading each segment's
        tokens back only after the next segment is dispatched: one host
        sync per segment, overlapped with the device's work.  A chunk of
        a chunked admission goes between the dispatch and the read-back:
        behind the segment on the stream."""
        pending = None
        while True:
            self._fill_slots()
            nxt_pending = None
            if self.steps < max_steps \
                    and any(r is not None for r in self.active):
                rows, plain = self._dispatch_rows(self.seg_len)
                fetched = self._run_segment(self.segment_plain_fn if plain
                                            else self.segment_fn)
                self.steps += self.seg_len * self._tokens_per_step
                self.wire.charge_merges(self.seg_len * self.merges_per_round)
                self.segments_dispatched += 1
                nxt_pending = (fetched, rows)
            self._pump_prefill()
            if pending is not None:
                self._consume_segment(*pending)
            self.assert_ledger()
            pending = nxt_pending
            if pending is not None:
                continue
            if self.steps >= max_steps:
                return          # step cap: remaining requests stay active
            if not self.queue and not self.suspended \
                    and not self.prefilling \
                    and all(r is None for r in self.active):
                return

    def _consume_segment(self, fetched, rows) -> None:
        """Deliver one segment's tokens and apply the device's verdicts
        (the one host sync of the segment).  Under speculation a round in
        which a row emitted m > 0 tokens with accept length a proposed
        spec_k drafts and emitted min(m, a) of them: the server's
        `draft_accepted` / `draft_proposed`; a retiring request gets its
        own totals from the device counters."""
        host, done = fetched
        if done is not None:
            done.synchronize()
        host = [t.numpy() for t in host]
        if self._data_group is not None:
            host = self._gather_rows(host)
        arr, em, alive, rem, pos = host[:5]
        if self.spec:
            al, acc, prop = host[5:]
        self.host_syncs += 1
        self.decode_syncs += 1
        for s, (req, take) in rows.items():
            toks = arr[s][em[s].astype(bool)]
            req.generated.extend(int(t) for t in toks)
            self.tokens_emitted += len(toks)
            if self.spec:
                m_r = em[s].reshape(al.shape[1], -1).sum(axis=1)
                self.draft_proposed += int((m_r > 0).sum()) * self.spec_k
                self.draft_accepted += int(np.minimum(m_r, al[s]).sum())
            if take is not None:
                # the device's budget accounting agrees with the host's
                assert len(toks) == take, (s, len(toks), take)
            if self.active[s] is req:
                assert pos[s] == self.positions[s] + len(toks), \
                    (s, pos[s], self.positions[s], len(toks))
                self.positions[s] = int(pos[s])
                self._set_pages(s, self._pages_for(self.positions[s]))
                if take is None:
                    self.remaining[s] = int(rem[s])
                    if not alive[s]:
                        if self.spec:
                            req.spec_accepted = int(acc[s])
                            req.spec_proposed = int(prop[s])
                        self.completed.append(req)
                        self.active[s] = None
                        self._free_pages(s)

    def _gather_rows(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        """This data group's rows of a segment's host arrays (each (rows,
        ...)) joined with the other groups' into every slot's, in slot
        order: one all-gather of one int64 tensor over the data axis."""
        flat = [a.reshape(self.rows_local, -1) for a in arrays]
        mine = torch.from_numpy(np.concatenate(
            [f.astype(np.int64) for f in flat], axis=1))
        every = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size(self._data_group))]
        dist.all_gather(every, mine, group=self._data_group)
        full = torch.cat(every).numpy()
        out, col = [], 0
        for a, f in zip(arrays, flat):
            w = f.shape[1]
            out.append(full[:, col:col + w].astype(a.dtype).reshape(
                (self.batch,) + a.shape[1:]))
            col += w
        return out

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        if self.stream:
            self.run_stream(max_steps)
            return
        while (self.queue or self.suspended or self.prefilling
               or any(r is not None for r in self.active)) \
                and self.steps < max_steps:
            self.step()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: the smoke one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    ap.add_argument("--protocol", default="axle", choices=list(PROTOCOLS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--stream", action="store_true",
                    help="segment-streaming loop (default: per-token)")
    ap.add_argument("--seg-len", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default); > 0 samples per slot")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed (request i uses seed + i)")
    ap.add_argument("--stop-eos", action="store_true",
                    help="stop each request at the config's eos_token")
    ap.add_argument("--quant-weights", default=None, choices=["q8_0", "q4_k"],
                    help="block-quantize the dense projection stacks")
    ap.add_argument("--quant-kv", default=None, choices=["int8"],
                    help="int8 KV cache with per-page scales")
    ap.add_argument("--spec", action="store_true",
                    help="speculative draft-and-verify segments")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens proposed per verify round")
    ap.add_argument("--draft", default=None,
                    help="draft arch: 'self[:N]' (the target's first N "
                         "blocks) or a ported arch id; defaults to the "
                         "config's draft_arch")
    ap.add_argument("--offload", action="store_true",
                    help="host tier: evict cold slots to pinned host "
                         "memory and restore them on demand")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse served prompts' pages (decoder-only "
                         "archs, not with --spec)")
    ap.add_argument("--evict-after", type=int, default=1,
                    help="segments a slot decodes before it may be "
                         "evicted (the round-robin quantum)")
    ap.add_argument("--offload-chunks", type=int, default=2,
                    help="chunks a leaf of the host<->device page copies")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts longer than this in chunks of this "
                         "many tokens, one between two decode segments")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve SPMD over a DATAxMODEL mesh of ranks, one "
                         "process a shard: run under torchrun "
                         "--nproc-per-node DATA*MODEL (e.g. 1x2)")
    args = ap.parse_args(argv)
    if args.mesh is None:
        return _serve_cli(args, None, args.device)
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.init_from_env(*mesh_lib.parse_mesh(args.mesh))
    try:
        device = args.device
        if device is None or device == "cuda":
            device = str(mesh_lib.rank_device(device))
        return _serve_cli(args, mesh, device)
    finally:
        dist.destroy_process_group()


def _serve_cli(args: argparse.Namespace, mesh, device: Optional[str]) -> int:
    """The CLI's serve, on one device or as one rank of `mesh` (every rank
    serves the same requests; rank 0 prints)."""
    server = BatchedServer(args.arch, smoke=not args.full,
                           device=device, batch_slots=args.slots,
                           max_seq=args.max_seq, protocol=args.protocol,
                           seg_len=args.seg_len, stream=args.stream,
                           quant=steps_lib.QuantConfig(
                               weights=args.quant_weights,
                               kv=args.quant_kv),
                           spec=args.spec, spec_k=args.spec_k,
                           draft_arch=args.draft,
                           host_offload=args.offload,
                           prefix_cache=args.prefix_cache,
                           evict_after=args.evict_after,
                           offload_chunks=args.offload_chunks,
                           prefill_chunk=args.prefill_chunk, mesh=mesh)
    stops = (server.cfg.eos_token,) if args.stop_eos else ()
    sampled = (args.temperature > 0 or args.top_k > 0 or args.top_p < 1.0
               or args.stop_eos)
    if args.temperature <= 0 and (args.top_k > 1 or args.top_p < 1.0):
        # a filter without a temperature would decode greedily
        print("[serve] --top-k/--top-p given without --temperature: "
              "defaulting temperature to 1.0", file=sys.stderr)
        args.temperature = 1.0
    rng = np.random.default_rng(0)
    first_prompt = None
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        embeds = None
        if server.cfg.enc_dec:    # the stub audio frontend: random frames
            embeds = rng.standard_normal(
                (server.cfg.enc_len, server.cfg.d_model)).astype(np.float32)
        prompt = rng.integers(1, server.cfg.vocab, plen).astype(np.int32)
        if args.prefix_cache:
            # shared prefixes: every third request repeats the first
            # prompt (a full hit), every third + 1 extends it (partial)
            if first_prompt is None:
                first_prompt = prompt
            elif i % 3 == 1:
                prompt = first_prompt
            elif i % 3 == 2:
                prompt = np.concatenate([first_prompt, prompt[:4]])
        sampling = SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, seed=args.seed + i,
            stop_tokens=stops) if sampled else None
        server.submit(Request(i, prompt, args.max_new, sampling=sampling,
                              embeds=embeds))
    t0 = time.perf_counter()
    server.run_until_drained()
    if server.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    server.assert_ledger()
    toks = sum(len(r.generated) for r in server.completed)
    mode = "stream" if args.stream else "per-token"
    spec = ""
    if args.spec:
        rate = server.draft_accepted / max(1, server.draft_proposed)
        spec = (f"draft={server.draft_cfg.arch_id} spec_k={args.spec_k} "
                f"accept_rate={rate:.2f} "
                f"tokens/sync={toks / max(1, server.decode_syncs):.2f} ")
    if args.offload:
        tier = server.host_tier
        spec += (f"evictions={server.evictions} "
                 f"restores={server.restores} "
                 f"restored_dead={server.restored_dead} "
                 f"host_mb={tier.bytes_evicted / 2**20:.1f} ")
    if args.prefix_cache:
        hits = server.prefix_hits_full + server.prefix_hits_partial
        spec += (f"prefix_hits={server.prefix_hits_full}full+"
                 f"{server.prefix_hits_partial}partial/"
                 f"{hits + server.prefix_misses} "
                 f"prefill_skipped={server.prefill_tokens_skipped}tok ")
    if args.prefill_chunk is not None:
        spec += (f"prefill_chunks={server.prefill_chunks} "
                 f"pages={server.pages_allocated}alloc/"
                 f"{server.pages_freed}freed ")
    if mesh is not None:
        if dist.get_rank() != 0:
            return 0
        spec += (f"mesh={args.mesh} eager "
                 f"wire_bytes_per_shard={server.wire_bytes_per_shard} ")
        if args.offload or args.prefix_cache:
            spec += (f"tier_moves={server.tier_moves} "
                     f"tier_bytes_moved={server.tier_bytes_moved} ")
    print(f"[serve] arch={server.cfg.arch_id} protocol={args.protocol} "
          f"quant={args.quant_weights or 'fp'}/{args.quant_kv or 'fp'} "
          f"mode={mode} requests={len(server.completed)} tokens={toks} "
          f"steps={server.steps} "
          f"syncs/token={server.decode_syncs / max(1, toks):.4f} {spec}"
          f"graph_replays={server.graph_replays} "
          f"({toks / dt:.1f} tok/s on {server.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
