"""Serving steps of the main path, ported from `repro/launch/steps.py`: the
serving-time quantization choice, the device-side per-slot decode state
(with each slot's PRNG key and sampling parameters), slot admission, the
prompt prefill and the multi-token decode segment.

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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig

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

    The speculative counters come with the speculation slice."""
    tokens: torch.Tensor
    positions: torch.Tensor
    keys: torch.Tensor
    remaining: torch.Tensor
    alive: torch.Tensor
    sampling: ops.BatchedSampling
    stop: torch.Tensor


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
        stop=torch.full((batch, MAX_STOP_TOKENS), -1, **i32))


def admit_slot(state: SlotState, slot: int, *, token: int, position: int,
               key: torch.Tensor, remaining: int, temperature: float,
               top_k: int, top_p: float, min_p: float,
               stop: Sequence[int]) -> SlotState:
    """Seed one slot's state at admission.  Returns a new SlotState (the
    old tensors are left as they were).  Only scalar writes and a copy
    of the (2,) device `key`: no host-to-device copy, which would wait
    for the segment in flight."""
    stops = list(stop) + [-1] * (MAX_STOP_TOKENS - len(stop))
    assert len(stops) == MAX_STOP_TOKENS, stop
    s = clone_state(state)
    s.tokens[slot, 0] = token
    s.positions[slot] = position
    s.keys[slot] = key
    s.remaining[slot] = remaining
    s.alive[slot] = remaining > 0
    s.sampling.temperature[slot] = temperature
    s.sampling.top_k[slot] = top_k
    s.sampling.top_p[slot] = top_p
    s.sampling.min_p[slot] = min_p
    for i, tok in enumerate(stops):
        s.stop[slot, i] = tok
    return s


def make_prefill_into_cache(cfg: ArchConfig) -> Callable:
    """(params, cache, prompt (P,), row, length) -> (last_logits (V,),
    cache): the real prompt prefill into one continuous-batching slot."""

    def prefill(params, cache, prompt, row, length):
        return transformer.prefill_into_cache(cfg, params, cache, prompt,
                                              row, length)

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

    def segment(params: Dict[str, Any], cache: Dict[str, Any],
                state: SlotState
                ) -> Tuple[torch.Tensor, torch.Tensor, SlotState,
                           Dict[str, Any]]:
        toks, pos, keys = state.tokens, state.positions, state.keys
        remaining, alive = state.remaining, state.alive
        seq, emit = [], []
        for _ in range(seg_len):
            logits, cache = transformer.decode_step(
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
