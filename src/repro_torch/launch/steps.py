"""Training and serving steps, ported from `repro/launch/steps.py`: the
train step (the loss's gradients by autograd, optional int8
error-feedback compression, AdamW); the serving-time quantization
choice, the device-side per-slot decode state (with each slot's PRNG
key, sampling parameters and draft counters), slot admission, the prompt
prefill, the multi-token decode segment, the truncated-layer self-draft,
the speculative draft-and-verify segment, and for the host tier one
slot's state saved and restored, its pages out of and into the cache,
and the resume prefill behind restored prefix pages; and the chunked
admission prefill (its first chunk through the prefill, every later one
through the resume).

The reference's jitted `lax.scan` with a donated cache becomes a Python
loop of `seg_len` decode steps that updates the cache IN PLACE; on the
card the server replays it as one CUDA graph (`launch/graphs.py`).  The
slot state stays functional: a segment and an admission return NEW
tensors rather than writing into the old ones, so a segment's returned
state is a stable snapshot while the next segment is already in flight
(the streamed loop reads it one segment later).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch import tree
from repro_torch.core import collectives as C
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.quant import QTensor
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import true_f32
from repro_torch.models.registry import get_model
from repro_torch.models.quantize import padded_rows
from repro_torch.optim import adamw, compression
from repro_torch.sharding import TrainLayout, use_rules, use_train_layout

# stop-token slots per serving request (padded with -1)
MAX_STOP_TOKENS = 4


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Serving-time quantization.

    weights — "q8_0" (int8, one symmetric scale per 32-row block) or
              "q4_k" (packed int4, a scale and a min per block): every
              dense projection stack is block-quantized once, and the
              dequant-fused matmul kernel reads only the packed blocks.
    kv      — "int8": the KV panels are int8 pools with one f32 scale per
              (layer, row, KV head, physical page); decode and prefill
              write quantized rows and the fused decode kernel applies
              the page scale to each tile.

    Either may be None (fp weights, fp KV); QuantConfig() is all fp."""
    weights: Optional[str] = None   # None | "q8_0" | "q4_k"
    kv: Optional[str] = None        # None | "int8"

    def __post_init__(self):
        if self.weights not in (None, "q8_0", "q4_k"):
            raise ValueError(f"unknown weight format: {self.weights}")
        if self.kv not in (None, "int8"):
            raise ValueError(f"unknown KV format: {self.kv}")


@dataclasses.dataclass(frozen=True)
class SlotState:
    """Device-resident per-slot decode state of the streamed serve loop.

      tokens    — (B, 1) i32: each row's CURRENT token, whose K/V is not
                  in the cache yet; it sits at positions[b].
      positions — (B,) i32 per-row position clocks: the number of prompt +
                  generated tokens before tokens[b].  Advances by one per
                  emitted token and never for a frozen row.
      keys      — (B, 2) int64 per-slot PRNG keys (`core/prng.py`), seeded
                  from the request's seed at admission (its split #0
                  drew the first token).  The sampled segment splits
                  every row's key once per step, so token k of a request
                  is drawn with the k-th split of its seed, whatever the
                  segmentation, slot or batch-mates; greedy rows never
                  read their keys.
      remaining — (B,) i32 token budget left.
      alive     — (B,) bool: the row emits this step.  Cleared on the
                  device when the row emits a stop token or spends its
                  budget; a dead row freezes until the host retires it.
      sampling  — per-slot temperature / top_k / top_p / min_p
                  (`ops.BatchedSampling`), fixed at admission.
      stop      — (B, MAX_STOP_TOKENS) i32 stop ids, -1-padded.
      accepted  — (B,) i32: draft tokens this request emitted by
                  speculative acceptance (corrections and bonus tokens
                  not counted).  Zeroed at admission; stays 0 without
                  speculation.
      proposed  — (B,) i32: draft tokens proposed for this request (k
                  per round in which the row was alive).
    """
    tokens: torch.Tensor
    positions: torch.Tensor
    keys: torch.Tensor
    remaining: torch.Tensor
    alive: torch.Tensor
    sampling: ops.BatchedSampling
    stop: torch.Tensor
    accepted: torch.Tensor
    proposed: torch.Tensor


def state_tensors(state: SlotState) -> List[torch.Tensor]:
    """Every tensor of a SlotState, in a fixed order (the sampling
    parameters in theirs)."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, ops.BatchedSampling):
            out.extend(getattr(v, g.name) for g in dataclasses.fields(v))
        else:
            out.append(v)
    return out


def clone_state(state: SlotState) -> SlotState:
    """A SlotState of new tensors with the same values."""
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone()
                  for f in dataclasses.fields(state)
                  if f.name != "sampling"},
        sampling=ops.BatchedSampling(
            **{g.name: getattr(state.sampling, g.name).clone()
               for g in dataclasses.fields(state.sampling)}))


def init_slot_state(batch: int, device: torch.device) -> SlotState:
    """All slots idle: nothing alive, greedy parameters, no stops."""
    i32 = dict(dtype=torch.int32, device=device)
    return SlotState(
        tokens=torch.zeros((batch, 1), **i32),
        positions=torch.zeros((batch,), **i32),
        keys=torch.zeros((batch, 2), dtype=torch.int64, device=device),
        remaining=torch.zeros((batch,), **i32),
        alive=torch.zeros((batch,), dtype=torch.bool, device=device),
        sampling=ops.greedy_sampling(batch, device),
        stop=torch.full((batch, MAX_STOP_TOKENS), -1, **i32),
        accepted=torch.zeros((batch,), **i32),
        proposed=torch.zeros((batch,), **i32))


def admit_slot(state: SlotState, slot: int, *, token: int, position: int,
               key: torch.Tensor, remaining: int, temperature: float,
               top_k: int, top_p: float, min_p: float,
               stop: Sequence[int]) -> SlotState:
    """Seed one slot's state at admission.  Returns a new SlotState (the
    old tensors are left as they were).  Only fills with host scalars and
    a copy of the (2,) device `key`: no host-to-device copy, which would
    wait for the segment in flight (`t[i] = x` on a CUDA tensor copies x
    from the host when t[i] is a single element)."""
    stops = list(stop) + [-1] * (MAX_STOP_TOKENS - len(stop))
    assert len(stops) == MAX_STOP_TOKENS, stop
    s = clone_state(state)
    s.keys[slot] = key
    _fill_row(s, slot, token=token, position=position, remaining=remaining,
              alive=remaining > 0, temperature=temperature, top_k=top_k,
              top_p=top_p, min_p=min_p, stop=stops, accepted=0, proposed=0)
    return s


def _fill_row(s: SlotState, slot: int, **values: Any) -> None:
    """Row `slot` of the named SlotState fields (`token` and `position`
    name tokens and positions; the sampling parameters by name; `key` and
    `stop` take a sequence),
    IN PLACE, by fills with host scalars: a fill launches with its value,
    where an element assignment would copy it from the host and wait for
    the stream."""
    rows = {"token": s.tokens[slot], "key": s.keys[slot],
            "stop": s.stop[slot],
            "position": s.positions[slot:slot + 1]}
    for name, value in values.items():
        row = rows.get(name)
        if row is None:
            owner = s.sampling if hasattr(s.sampling, name) else s
            row = getattr(owner, name)[slot:slot + 1]
        for i, v in enumerate(value if isinstance(value, (list, tuple))
                              else [value]):
            row[i:i + 1].fill_(v)


def save_slot_state(state: SlotState, slot: int) -> Dict[str, torch.Tensor]:
    """ONE slot's row of every SlotState field, for eviction: NEW tensors
    (a captured segment's output buffers are overwritten by its next
    replay, so the row is copied now, on the serving stream).  `key` is
    the row's CURRENT chain head, so a restored slot continues the exact
    split sequence a never-evicted one would."""
    s = state
    row = {"token": s.tokens[slot, 0], "position": s.positions[slot],
           "key": s.keys[slot], "remaining": s.remaining[slot],
           "alive": s.alive[slot],
           "temperature": s.sampling.temperature[slot],
           "top_k": s.sampling.top_k[slot], "top_p": s.sampling.top_p[slot],
           "min_p": s.sampling.min_p[slot], "stop": s.stop[slot],
           "accepted": s.accepted[slot], "proposed": s.proposed[slot]}
    return {k: v.clone() for k, v in row.items()}


def freeze_slot(state: SlotState, slot: int) -> SlotState:
    """A new SlotState with row `slot` dead, for a slot whose request left
    it for the host tier: without it the row would go on decoding on the
    device, and the write-masked segments would write its stale clock's
    rows (and a mamba layer's state) into the slot, over a chunked
    admission's chunks.  A fill, no host-to-device copy."""
    s = clone_state(state)
    _fill_row(s, slot, alive=False)
    return s


def restore_slot(state: SlotState, slot: int,
                 saved: Dict[str, torch.Tensor]) -> SlotState:
    """Re-seed one slot from a `save_slot_state` row that lies in host
    memory: `admit_slot`'s restore twin.  Every field continues where the
    evicted slot left off (the position clock, the PRNG chain head, the
    budget, alive, the accept counters; nothing is reset or re-derived),
    which makes an evicted-then-restored stream bitwise a never-evicted
    one.  Returns a new SlotState; as `admit_slot`, only fills with the
    host values, no host-to-device copy."""
    s = clone_state(state)
    _fill_row(s, slot, **{k: t.tolist() for k, t in saved.items()})
    return s


def loss_and_grads(cfg: ArchConfig, params: Any,
                   batch: Dict[str, torch.Tensor],
                   layout: Optional[TrainLayout] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """The model's loss and its gradient tree: the counterpart of
    `jax.value_and_grad(loss_fn, has_aux=True)` is `torch.autograd.grad`
    over the parameter tree's leaves (detached views that require grad;
    the caller's tensors are left alone).  The forward and the backward
    run in full f32 wherever a product is f32 (`layers.true_f32`: the
    backward runs after the forward has left its own contexts).  Returns
    (loss, {"ce", "aux"}, grads like params), all detached.

    On a mesh (`layout`): params and batch are the rank's shards, and so
    are the gradients it returns.  The loss and its metrics are the
    global ones on every rank (summed over the mesh inside the loss), so
    each rank's backward starts from loss / n_ranks, and the sums'
    backward adds every rank's share back.  A leaf's gradient reaches
    its shard through its gather's reduce-scatter, then is summed over
    the axes the leaf is replicated over; replicated compute (a sequence
    that does not split, replicated rows) is counted once, since every
    replica's share of the loss is already divided among them."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with true_f32(), use_train_layout(layout):
        loss, metrics = get_model(cfg).loss_fn(
            cfg, tree.unflatten(params, leaves), batch)
        seed = loss if layout is None else loss / layout.world()
        grads = list(torch.autograd.grad(seed, leaves))
        if layout is not None:
            grads = C.sum_over_replicas(grads, tree.leaves(layout.params))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(params, grads))


def apply_update(opt_cfg: adamw.AdamWConfig, params: Any, grads: Any,
                 opt_state: adamw.OptState, comp_state: Any,
                 layout: Optional[TrainLayout] = None) -> Tuple[Any, ...]:
    """A train step's update of its gradients: the int8 error-feedback
    compression when `comp_state` is given, then AdamW (the state
    updated in place).  Returns (params, opt_state, comp_state,
    {"grad_norm", "lr"}); on a mesh (`layout`) of the rank's shards."""
    specs = None if layout is None else layout.params
    with use_train_layout(layout):
        if comp_state is not None:
            grads, comp_state = compression.compress_grads(
                grads, comp_state, specs)
        params, opt_state, opt_metrics = adamw.apply(
            opt_cfg, params, grads, opt_state, specs)
    return params, opt_state, comp_state, opt_metrics


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                    compress_grads: bool = False,
                    layout: Optional[TrainLayout] = None) -> Callable:
    """(params, opt_state, comp_state, batch) -> (params, opt_state,
    comp_state, metrics {"loss", "ce", "aux", "grad_norm", "lr"}), f32
    scalar tensors on the device: the step reads nothing back.  The
    gradients (`loss_and_grads`), then `apply_update` (the optional int8
    error-feedback compression, then AdamW).  On a mesh (`layout`:
    `sharding.TrainLayout`) every tree is the rank's shards under
    `layout.params` (the batch under `layout.batch`), and the metrics
    are the global ones on every rank."""

    def train_step(params, opt_state, comp_state, batch):
        loss, metrics, grads = loss_and_grads(cfg, params, batch, layout)
        params, opt_state, comp, opt_metrics = apply_update(
            opt_cfg, params, grads, opt_state,
            comp_state if compress_grads else None, layout)
        return (params, opt_state, comp if compress_grads else comp_state,
                {**metrics, **opt_metrics, "loss": loss})

    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """(params, batch) -> logits (B, S, V): the full-sequence forward, the
    prefill shape the dry-run counts."""
    model = get_model(cfg)

    def prefill_step(params, batch):
        return model.logits_fn(cfg, params, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """(params, cache, tokens (B, 1)[, positions (B,)]) -> (next tokens
    (B, 1) int32, logits (B, 1, V), cache): one greedy decode step, the
    decode shapes the dry-run counts.  Without `positions` the cache's
    scalar clock places every row; the cache is updated IN PLACE."""
    model = get_model(cfg)

    def serve_step(params, cache, tokens, positions=None):
        logits, cache = model.decode_step(cfg, params, cache, tokens,
                                          positions)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step


def make_slot_page_fns(cfg: ArchConfig) -> Tuple[Callable, Callable]:
    """(extract, insert) of one slot's cache pages, every leaf kind (K/V
    page sets and their scales, conv windows, SSD states, cross-K/V and
    enc_pos): extract(cache, row, upto=None) -> {leaf: pages},
    insert(cache, pages, row) -> cache, written in place."""
    model = get_model(cfg)

    def extract(cache, row, upto=None):
        return model.extract_slot(cfg, cache, row, upto)

    def insert(cache, pages, row):
        return model.insert_slot(cfg, cache, pages, row)

    return extract, insert


def make_resume_prefill(cfg: ArchConfig) -> Optional[Callable]:
    """(params, cache, suffix (Ps,), row, length, start) -> (last logits
    (V,), cache): the suffix prefill behind restored prefix pages (row
    `row` already holds K/V rows [0, start) and the post-prefix recurrent
    state).  None for an encoder-decoder."""
    fn = get_model(cfg).resume_prefill
    if fn is None:
        return None

    def resume(params, cache, suffix, row, length, start):
        return fn(cfg, params, cache, suffix, row, length, start)

    return resume


class ChunkedPrefill(NamedTuple):
    """Chunked admission prefill: its two halves and its chunk planner.
    `first` runs the opening chunk through the one-shot prefill (length =
    the chunk's true length); `resume` continues from the row's own
    freshly written K/V rows and recurrent state, as a prefix-cache
    partial hit does; `plan` splits a prompt into its (start, size)
    chunks."""
    first: Callable      # (params, cache, chunk (C,), row, length)
    resume: Callable     # (params, cache, chunk (C,), row, length, start)
    plan: Callable       # (plen, chunk_size) -> [(start, size), ...]


def chunk_plan(plen: int, chunk_size: int) -> List[Tuple[int, int]]:
    """The (start, size) chunks of a `plen`-token prompt, `chunk_size`
    tokens each but the last."""
    assert chunk_size >= 1, chunk_size
    return [(s, min(chunk_size, plen - s))
            for s in range(0, plen, chunk_size)]


def make_chunked_prefill(cfg: ArchConfig) -> Optional[ChunkedPrefill]:
    """Chunk-resumable prompt prefill for the interleaved admission of
    `BatchedServer(prefill_chunk=...)`: each chunk is one bounded forward,
    so a long prompt admits as a series of small ones between decode
    segments instead of one that stalls every stream in flight.

    Chunk c covers prompt tokens [c C, c C + size): `first` takes c = 0,
    `resume` every later chunk with start = c C, when the row already
    holds K/V rows [0, start) and the recurrent state after them: the
    precondition of `resume_prefill_into_cache`.  The last chunk's
    `length` is the whole prompt's, so its logits are the prompt's
    last-token logits.  Token-equal to the one-shot prefill (the resume
    merges two softmax partials in another order), bitwise for mamba
    layers.  Every chunk is padded to C: a row needs ceil(P / C) C <=
    max_seq rows.  None for an encoder-decoder (no resume prefill)."""
    resume = make_resume_prefill(cfg)
    if resume is None:
        return None
    return ChunkedPrefill(first=make_prefill_into_cache(cfg), resume=resume,
                          plan=chunk_plan)


def run_chunked_prefill(cp: ChunkedPrefill, params: Dict[str, Any],
                        cache: Dict[str, Any], prompt: torch.Tensor,
                        row: int, chunk_size: int
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """A whole prompt through `cp`, chunk by chunk (the server runs the
    same calls one at a time between decode segments).  prompt: (P,) int
    tokens at the TRUE length, on the cache's device.  Returns (last-token
    logits (V,), cache)."""
    plen = int(prompt.shape[0])
    logits = None
    for start, size in cp.plan(plen, chunk_size):
        chunk = prompt.new_zeros((chunk_size,), dtype=torch.int32)
        chunk[:size] = prompt[start:start + size]
        if start == 0:
            logits, cache = cp.first(params, cache, chunk, row, size)
        else:
            logits, cache = cp.resume(params, cache, chunk, row,
                                      start + size, start)
    return logits, cache


def make_prefill_into_cache(cfg: ArchConfig, *,
                            from_enc_out: bool = False) -> Callable:
    """(params, cache, prompt (P,), row, length) -> (last_logits (V,),
    cache): the real prompt prefill into one continuous-batching slot,
    through the registry's model.  An encoder-decoder's takes one more
    argument: the request's frame embeddings (1, e, D), which it encodes,
    or with `from_enc_out=True` their encoder output (1, e, D), so that
    the target's and a self-draft's prefill share one encoder pass."""
    fn = get_model(cfg).prefill_into_cache
    if not cfg.enc_dec:
        def prefill(params, cache, prompt, row, length):
            return fn(cfg, params, cache, prompt, row, length)
    elif from_enc_out:
        def prefill(params, cache, prompt, row, length, enc_out):
            return fn(cfg, params, cache, prompt, row, length,
                      enc_out=enc_out)
    else:
        def prefill(params, cache, prompt, row, length, enc_embeds):
            return fn(cfg, params, cache, prompt, row, length, enc_embeds)
    return prefill


def make_decode_segment(cfg: ArchConfig, seg_len: int, *,
                        plain: bool = False) -> Callable:
    """(params, cache, state) -> (segment (B, seg_len) i32, emitted
    (B, seg_len) bool, state, cache).

    `seg_len` decode + sample steps in a Python loop, with no host sync
    inside: the host dispatches (and later syncs on) one segment per
    `seg_len` tokens.  The cache is updated IN PLACE; the state comes back
    as new tensors.

    Each step splits every row's key into (key, sub) and samples the
    next token with `sub` (`ops.sample_tokens`, greedy rows by argmax).
    In-segment termination: an emitted stop token or a spent budget
    clears the row's alive bit; from the next step the row is FROZEN —
    its token and position stop advancing and `write_mask=alive` keeps
    its cache rows untouched — until the host retires it.
    `emitted[b, t]` is row b's alive bit on entry to step t.

    `plain=True` is the fast variant the server takes when every active
    row is greedy with no stop set: plain argmax, no key splits, no
    sampling epilogue, no write mask (a dead row keeps rewriting its
    slot, which the next prefill overwrites) and no stop test.  Alive
    rows emit the same tokens under both variants, so they interleave
    freely; a row's keys then depend on the mix of variants that ran,
    which is safe because only sampled rows read them and a row's
    parameters are fixed at admission."""

    decode_step = get_model(cfg).decode_step

    def segment(params: Dict[str, Any], cache: Dict[str, Any],
                state: SlotState
                ) -> Tuple[torch.Tensor, torch.Tensor, SlotState,
                           Dict[str, Any]]:
        toks, pos, keys = state.tokens, state.positions, state.keys
        remaining, alive = state.remaining, state.alive
        seq, emit = [], []
        for _ in range(seg_len):
            logits, cache = decode_step(
                cfg, params, cache, toks, positions=pos,
                write_mask=None if plain else alive)
            if plain:
                nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
                hit_stop = torch.zeros_like(alive)
            else:
                both = prng.split(keys)
                keys, sub = both[:, 0], both[:, 1]
                nxt = ops.sample_tokens(logits[:, -1], state.sampling, sub,
                                        vocab=cfg.vocab)
                nxt = torch.where(alive, nxt, toks[:, 0])  # dead rows freeze
                hit_stop = (nxt[:, None] == state.stop).any(dim=-1)
            emitted = alive
            remaining = remaining - emitted.to(torch.int32)
            alive = alive & (remaining > 0) & ~hit_stop
            pos = pos + emitted.to(torch.int32)
            toks = nxt[:, None]
            seq.append(nxt)
            emit.append(emitted)
        state = dataclasses.replace(state, tokens=toks, positions=pos,
                                    keys=keys, remaining=remaining,
                                    alive=alive)
        return torch.stack(seq, 1), torch.stack(emit, 1), state, cache

    return segment


# --------------------------------------------------------------------------
# Speculative draft-and-verify decoding
# --------------------------------------------------------------------------

def self_draft_config(cfg: ArchConfig, n_blocks: int) -> ArchConfig:
    """The truncated-layer self-draft: the target's first `n_blocks`
    pattern blocks as a model of their own, sharing the target's
    embedding and layer geometry."""
    assert 1 <= n_blocks <= cfg.n_blocks, (n_blocks, cfg.n_blocks)
    return dataclasses.replace(
        cfg, arch_id=f"{cfg.arch_id}_draft{n_blocks}",
        n_layers=n_blocks * len(cfg.block_pattern))


def _first_blocks(tree: Any, n: int) -> Any:
    """Every stacked leaf of `tree` cut to its first n blocks, as views (a
    QTensor's scales, quants and mins each)."""
    if isinstance(tree, QTensor):
        return QTensor(tree.scales[:n], tree.quants[:n],
                       None if tree.mins is None else tree.mins[:n],
                       tree.fmt, tree.d_in)
    if isinstance(tree, dict):
        return {k: _first_blocks(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_first_blocks(v, n) for v in tree]
    return tree[:n]


def self_draft_params(cfg: ArchConfig, params: Dict[str, Any],
                      n_blocks: int) -> Dict[str, Any]:
    """The self-draft's parameters: the target's own tree with its block
    stacks (`blocks`; an encoder-decoder's `dec_blocks` and `cross`) cut
    to the first `n_blocks` blocks.  Every leaf is a view of the target's
    (the embedding, the final norms and an encoder are the same tensors),
    so the draft holds no weights of its own, and a full-depth draft
    computes bitwise what the target does."""
    assert 1 <= n_blocks <= cfg.n_blocks, (n_blocks, cfg.n_blocks)
    return dict(params, **{key: _first_blocks(params[key], n_blocks)
                           for key in ("blocks", "dec_blocks", "cross")
                           if key in params})


def make_spec_decode_segment(cfg: ArchConfig, draft_cfg: ArchConfig,
                             rounds: int, k: int, *,
                             plain: bool = False) -> Callable:
    """(params, draft_params, cache, draft_cache, state) -> (segment (B,
    rounds*(k+1)) i32, emitted (B, rounds*(k+1)) bool, accept_lens (B,
    rounds) i32, state, cache, draft_cache).

    `rounds` draft-and-verify rounds in a Python loop, with no host sync;
    both caches are updated IN PLACE, the state comes back as new
    tensors.  Each round:

      1. draft: k draft decode steps propose g_0..g_{k-1}, each drawn by
         `ops.sample_tokens` with the row's own parameters and key
         fold_in(draft_key, j), then one sample-free step absorbs
         g_{k-1} into the draft's state;
      2. verify: one `decode_verify` of the target over
         [current, g_0..g_{k-1}];
      3. accept: `ops.verify_tokens` gives the accepted prefix length a
         and the correction or bonus token; the round emits m = a + 1
         tokens, cut by the row's budget and at its first stop token;
      4. advance: each row's clock moves by its own m; attention rows
         past it stay invisible, and the recurrent (conv, SSM) states of
         target and draft roll back by gathering snapshot m - 1.  A row
         dead on entry emits nothing and keeps its state (write_mask =
         alive in every forward).

    Under a mesh the draft decodes with its attention whole on every rank
    (no sharding rules), so only the verify's merges cross the wire.

    The draft steps run their fp products and norms padded to the
    verify's B*(k+1) rows (`quantize.padded_rows`), so a draft of the
    target's own blocks computes the verify's bits: on the card cuBLAS
    picks its kernel by the row count.  The non-speculative decode runs
    unpadded, at B rows, so at a near tie on the card a greedy spec
    stream can part from the non-speculative one.

    The sampled variant splits each row's key once per round into (key,
    round key) and the round key into (draft key, verify key); greedy
    rows read no key and emit the verify's argmax stream, for any draft.
    `plain=True`, for batches whose rows are all greedy with no stop set:
    argmax proposals, the prefix match against the target argmax as the
    verdict, no key splits, no stop test; it emits the sampled variant's
    tokens, emit masks and accept lengths on such batches."""
    assert k >= 1, k
    t = k + 1
    decode_verify = get_model(cfg).decode_verify
    draft_step = get_model(draft_cfg).decode_step

    def segment(params: Dict[str, Any], draft_params: Dict[str, Any],
                cache: Dict[str, Any], draft_cache: Dict[str, Any],
                state: SlotState
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           SlotState, Dict[str, Any], Dict[str, Any]]:
        toks, pos, keys = state.tokens, state.positions, state.keys
        remaining, alive = state.remaining, state.alive
        accepted, proposed = state.accepted, state.proposed
        b = pos.shape[0]
        rows = torch.arange(b, device=pos.device)
        arange_t = torch.arange(t, device=pos.device)
        draft_rec = [key for key in draft_cache
                     if key.startswith(("conv", "ssm"))]
        outs, emits, alens = [], [], []
        for _ in range(rounds):
            if not plain:
                both = prng.split(keys)
                keys, round_keys = both[:, 0], both[:, 1]
                sub = prng.split(round_keys)
                draft_keys, verify_keys = sub[:, 0], sub[:, 1]

            # 1. draft: k proposals, then the absorb step, their products
            # and norms at the verify's row count (models/quantize.py)
            dtoks, inputs, dlogits, dsnaps = toks, [], [], []
            for j in range(k):
                with padded_rows(b * t), use_rules(None):
                    lg, draft_cache = draft_step(
                        draft_cfg, draft_params, draft_cache, dtoks,
                        positions=pos + j, write_mask=alive)
                if plain:
                    nxt = lg[:, -1].argmax(dim=-1).to(torch.int32)
                else:
                    nxt = ops.sample_tokens(
                        lg[:, -1], state.sampling,
                        prng.fold_in(draft_keys, j), vocab=cfg.vocab)
                    dlogits.append(lg[:, -1])
                nxt = torch.where(alive, nxt, dtoks[:, 0])
                inputs.append(dtoks[:, 0])
                dsnaps.append([draft_cache[key].clone()
                               for key in draft_rec])
                dtoks = nxt[:, None]
            with padded_rows(b * t), use_rules(None):
                _, draft_cache = draft_step(
                    draft_cfg, draft_params, draft_cache, dtoks,
                    positions=pos + k, write_mask=alive)
            dsnaps.append([draft_cache[key] for key in draft_rec])

            # 2. verify: the target over [current, g_0..g_{k-1}]
            ver = torch.cat([torch.stack(inputs, dim=1), dtoks], dim=1)
            tlogits, cache, tsnaps = decode_verify(
                cfg, params, cache, ver, pos, write_mask=alive)
            if plain:
                out = tlogits.float().argmax(dim=-1).to(torch.int32)
                match = (ver[:, 1:] == out[:, :k]).to(torch.int32)
                alen = match.cumprod(dim=-1).sum(dim=-1).to(torch.int32)
            else:
                out, alen = ops.verify_tokens(
                    tlogits, torch.stack(dlogits, dim=1), ver[:, 1:],
                    state.sampling, verify_keys, vocab=cfg.vocab)

            # 3. emit count: the budget cap and the first stop token
            cand = torch.minimum(alen + 1, remaining)
            if plain:
                first_stop = torch.full_like(cand, t)
            else:
                hits = (out[..., None] == state.stop[:, None, :]).any(-1)
                first_stop = torch.where(
                    hits.any(dim=-1),
                    hits.to(torch.int32).argmax(dim=-1).to(torch.int32),
                    t)
            m = torch.where(alive, torch.minimum(cand, first_stop + 1), 0)
            emitted = arange_t[None, :] < m[:, None]

            # 4. per-row advance, then the recurrent rollback
            sel = torch.clamp(m - 1, min=0).long()
            new_tok = torch.gather(out, 1, sel[:, None])
            toks = torch.where(alive[:, None], new_tok, toks)
            pos = pos + m
            remaining = remaining - m
            stop_hit = (first_stop < cand) & alive
            accepted = accepted + torch.minimum(m, alen)
            proposed = proposed + alive.to(torch.int32) * k
            alens.append(torch.where(alive, alen, 0))
            for key, snap in tsnaps.items():                  # (L,B,T,...)
                _roll_back(cache[key], snap[:, rows, sel], alive)
            for i, key in enumerate(draft_rec):
                snap = torch.stack([s[i] for s in dsnaps])    # (T,L,B,...)
                _roll_back(draft_cache[key],
                           snap[sel, :, rows].movedim(0, 1), alive)
            alive = alive & (remaining > 0) & ~stop_hit
            outs.append(out)
            emits.append(emitted)
        state = dataclasses.replace(
            state, tokens=toks, positions=pos, keys=keys,
            remaining=remaining, alive=alive, accepted=accepted,
            proposed=proposed)
        return (torch.stack(outs, dim=1).reshape(b, rounds * t),
                torch.stack(emits, dim=1).reshape(b, rounds * t),
                torch.stack(alens, dim=1), state, cache, draft_cache)

    return segment


def _roll_back(live: torch.Tensor, rolled: torch.Tensor,
               alive: torch.Tensor) -> None:
    """Set each alive row (axis 1) of a stacked recurrent state to its
    gathered snapshot, IN PLACE; dead rows keep theirs."""
    keep = alive.reshape((1, -1) + (1,) * (live.dim() - 2))
    live.copy_(torch.where(keep, rolled.to(live.dtype), live))
