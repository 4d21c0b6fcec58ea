"""Serving steps of the main path, ported from `repro/launch/steps.py`: the
serving-time quantization choice, the device-side per-slot decode state,
slot admission, the prompt prefill and the multi-token decode segment.

The reference's jitted `lax.scan` with a donated cache becomes a Python
loop of `seg_len` decode steps that updates the cache IN PLACE.  The slot
state stays functional: a segment and an admission return NEW tensors
rather than writing into the old ones, so a segment's returned state is a
stable snapshot while the next segment is already in flight (the streamed
loop reads it one segment later).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

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
      remaining — (B,) i32 token budget left.
      alive     — (B,) bool: the row emits this step.  Cleared on the
                  device when the row emits a stop token or spends its
                  budget; a dead row freezes until the host retires it.
      stop      — (B, MAX_STOP_TOKENS) i32 stop ids, -1-padded.

    PRNG keys, sampling parameters and the speculative counters come with
    the sampling and speculation slices."""
    tokens: torch.Tensor
    positions: torch.Tensor
    remaining: torch.Tensor
    alive: torch.Tensor
    stop: torch.Tensor


def init_slot_state(batch: int, device: torch.device) -> SlotState:
    """All slots idle: nothing alive, no stops."""
    i32 = dict(dtype=torch.int32, device=device)
    return SlotState(
        tokens=torch.zeros((batch, 1), **i32),
        positions=torch.zeros((batch,), **i32),
        remaining=torch.zeros((batch,), **i32),
        alive=torch.zeros((batch,), dtype=torch.bool, device=device),
        stop=torch.full((batch, MAX_STOP_TOKENS), -1, **i32))


def admit_slot(state: SlotState, slot: int, *, token: int, position: int,
               remaining: int, stop: Sequence[int]) -> SlotState:
    """Seed one slot's state at admission.  Returns a new SlotState (the
    old tensors are left as they were).  Only scalar writes: no host-to-
    device copy, which would wait for the segment in flight."""
    stops = list(stop) + [-1] * (MAX_STOP_TOKENS - len(stop))
    assert len(stops) == MAX_STOP_TOKENS, stop
    s = {f.name: getattr(state, f.name).clone()
         for f in dataclasses.fields(state)}
    s["tokens"][slot, 0] = token
    s["positions"][slot] = position
    s["remaining"][slot] = remaining
    s["alive"][slot] = remaining > 0
    for i, tok in enumerate(stops):
        s["stop"][slot, i] = tok
    return SlotState(**s)


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

    `seg_len` greedy decode steps in a Python loop, with no host sync
    inside: the host dispatches (and later syncs on) one segment per
    `seg_len` tokens.  The cache is updated IN PLACE; the state comes back
    as new tensors.

    In-segment termination: an emitted stop token or a spent budget
    clears the row's alive bit; from the next step the row is FROZEN —
    its token and position stop advancing and `write_mask=alive` keeps
    its cache rows untouched — until the host retires it.
    `emitted[b, t]` is row b's alive bit on entry to step t.

    `plain=True` is the fast variant the server takes when no active row
    has a stop set: no write mask (a dead row keeps rewriting its slot,
    which the next prefill overwrites) and no stop test.  Alive rows emit
    the same tokens under both variants, so they interleave freely."""

    def segment(params: Dict[str, Any], cache: Dict[str, Any],
                state: SlotState
                ) -> Tuple[torch.Tensor, torch.Tensor, SlotState,
                           Dict[str, Any]]:
        toks, pos = state.tokens, state.positions
        remaining, alive = state.remaining, state.alive
        seq, emit = [], []
        for _ in range(seg_len):
            logits, cache = transformer.decode_step(
                cfg, params, cache, toks, positions=pos,
                write_mask=None if plain else alive)
            nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
            if plain:
                hit_stop = torch.zeros_like(alive)
            else:
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
                                    remaining=remaining, alive=alive)
        return torch.stack(seq, 1), torch.stack(emit, 1), state, cache

    return segment
