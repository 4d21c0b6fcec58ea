"""Arch -> model functions, the port of `repro/models/registry.py`:
decoder-only configs take `models/transformer.py`, encoder-decoder ones
`models/encdec.py`.  The fields keep the reference's names.  The resume
prefill is None for an encoder-decoder: its prompts are keyed on audio
frames, not on token prefixes."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ArchConfig


class ModelFns(NamedTuple):
    init_params: Callable         # (cfg, generator, device) -> params
    init_cache: Callable          # (cfg, batch, max_seq, *, device, ...)
    # (cfg, params, batch) -> (loss, {"ce", "aux"}): the training loss
    loss_fn: Callable
    # (cfg, params, batch) -> logits (B, S, V): the full-sequence forward
    logits_fn: Callable
    # (cfg, params, cache, tokens (B,1), positions, write_mask) ->
    # (logits (B,1,V), cache)
    decode_step: Callable
    # (cfg, params, cache, tokens (B,T), positions, write_mask) ->
    # (logits (B,T,V), cache, recurrent rollback snapshots)
    decode_verify: Callable
    # (cfg, params, cache, tokens (P,), row, length[, enc_embeds], *[,
    # enc_out]) -> (last logits (V,), cache)
    prefill_into_cache: Callable
    # one slot's cache pages, the host tier's unit: (cfg, cache, row[,
    # upto]) -> leaves / (cfg, cache, leaves, row) -> cache (in place)
    extract_slot: Callable
    insert_slot: Callable
    # (cfg, params, cache, suffix (Ps,), row, length, start) -> (last
    # logits (V,), cache): the suffix prefill behind restored prefix pages
    resume_prefill: Optional[Callable]
    # (cfg[, device]) -> params / (cfg, batch, max_seq[, page_size,
    # kv_quant, device]) -> cache: shapes and dtypes only, meta tensors
    # by default, for the dry-run
    abstract_params: Callable
    abstract_cache: Callable


def get_model(cfg: ArchConfig) -> ModelFns:
    mod = encdec if cfg.enc_dec else transformer
    return ModelFns(mod.init_params, mod.init_cache, mod.loss_fn,
                    mod.logits_fn, mod.decode_step,
                    mod.decode_verify, mod.prefill_into_cache,
                    mod.extract_slot_cache, mod.insert_slot_cache,
                    None if cfg.enc_dec
                    else transformer.resume_prefill_into_cache,
                    mod.abstract_params, mod.abstract_cache)
