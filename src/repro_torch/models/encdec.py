"""Whisper-style encoder-decoder, the port of `repro/models/encdec.py`:
serving (the encoder, per-slot cross-K/V, decode) and training (the
decoder forward, its loss and logits).  The conv audio frontend is a
stub: a request brings its frames as precomputed embeddings (e,
d_model), e <= the config's enc_len.

The encoder is a bidirectional transformer (plain `layers.blocked_attention`,
as the reference's is plain XLA).  The decoder adds a cross-attention
sublayer after each self-attention one.  Cross-attention is the paper's
offload structure for enc-dec serving: the encoder output lives on the
memory side as per-slot cross-K/V, and every decode step streams one
attention over it (`decode_attention_combined(..., n_chunks=1)`).

Parameters keep the reference's layout, each per-layer leaf stacked over
its stack's blocks:

    {"embed": (V, D), "enc_final_ln": (D,), "final_ln": (D,),
     "enc_blocks": [{"attn": {ln, wq, wk, wv, wo}, "ffn": {...}}],
     "dec_blocks": [{"attn": {...}, "ffn": {...}}],
     "cross": {ln, wq, wk, wv, wo}}

The decoder's self-attention, its K/V cache (paged, fp or int8) and its
writes are `transformer`'s.  Caches are updated IN PLACE, as there: the
server's captured CUDA graphs hold the cache's tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.backstream import decode_attention_combined
from repro_torch.kernels import ops
from repro_torch.kernels.build import launch_site
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.models.quantize import matmul
from repro_torch.core import collectives as C
from repro_torch.sharding import active_rules, train_layout, use_rules

Params = Dict[str, Any]


def _n_enc_blocks(cfg: ArchConfig) -> int:
    return cfg.n_enc_layers // len(cfg.block_pattern)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """The port's own weight draw (`transformer.Draw`), with the
    reference's shapes and scales: the encoder's and the decoder's blocks
    as `transformer.init_block_params`, the cross-attention as a decoder
    attention sublayer.  Not bit-equal to the JAX draw."""
    assert cfg.enc_dec, cfg.arch_id
    draw = T.Draw(cfg, generator, device)
    return {"enc_blocks": T.init_block_params(cfg, draw, _n_enc_blocks(cfg)),
            "dec_blocks": T.init_block_params(cfg, draw, cfg.n_blocks),
            "cross": T._init_attn(cfg, draw, cfg.n_blocks),
            "embed": draw.normal((cfg.padded_vocab, cfg.d_model),
                                 cfg.d_model ** -0.5),
            "enc_final_ln": draw.zeros(cfg.d_model),
            "final_ln": draw.zeros(cfg.d_model)}


def abstract_params(cfg: ArchConfig,
                    device: torch.device = torch.device("meta")) -> Params:
    """`init_params`' tree of shapes and dtypes without a draw
    (`transformer.AbstractDraw`): meta tensors by default."""
    assert cfg.enc_dec, cfg.arch_id
    draw = T.AbstractDraw(cfg, device)
    return {"enc_blocks": T.init_block_params(cfg, draw, _n_enc_blocks(cfg)),
            "dec_blocks": T.init_block_params(cfg, draw, cfg.n_blocks),
            "cross": T._init_attn(cfg, draw, cfg.n_blocks),
            "embed": draw.normal((cfg.padded_vocab, cfg.d_model), 0.0),
            "enc_final_ln": draw.zeros(cfg.d_model),
            "final_ln": draw.zeros(cfg.d_model)}


def _cross_layer(cross: Params, i: int) -> Params:
    """Decoder block i's cross-attention weights, views of the stacks."""
    return T._layer({"cross": cross}, i)["cross"]


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def _enc_attn(cfg: ArchConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, act=None) -> torch.Tensor:
    """The bidirectional encoder attention with its residual; on a mesh
    whose layout `act` splits the frames, the span's queries against the
    K/V gathered over the model axis."""
    b, s, _ = x.shape
    q, k, v = T._qkv(cfg, p, x, positions)
    if act is not None and act.seq:
        k = C.all_gather(k, 1, act.seq, act.rules)
        v = C.all_gather(v, 1, act.seq, act.rules)
    o = L.blocked_attention(q, k, v, causal=False)
    return x + matmul(o.reshape(b, s, -1), p["wo"])


def _enc_block(cfg: ArchConfig, x: torch.Tensor, block: List[Params],
               positions: torch.Tensor, act=None,
               specs: Optional[List[Params]] = None) -> torch.Tensor:
    for pos, p in enumerate(block):
        sp = specs[pos] if specs is not None else {}
        x = _enc_attn(cfg, T.gathered(p["attn"], sp.get("attn"), act), x,
                      positions, act)
        x = T.ffn_layer(cfg, T.gathered(p["ffn"], sp.get("ffn"), act), x,
                        False)
    return x


def encode(cfg: ArchConfig, params: Params, embeds: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """The encoder over frame embeddings (B, e, D), any float dtype:
    RoPE'd bidirectional attention and the dense MLP per layer, then the
    final norm; `remat` recomputes each block in the backward (the
    training loss sets it, as the reference's default does).  Returns (B,
    e, D) in the model dtype.  On a training mesh (`train_layout()`) the
    embeds are the rank's rows, its frame span taken when the frames
    split over the model axis (whisper's 1,500 do not over 16: they stay
    replicated), and the output gathered whole for the cross-attention."""
    layout = train_layout()
    act = specs = None
    if layout is not None:
        act = layout.act(embeds.shape[1])
        embeds = embeds.narrow(1, act.start, act.length)
        specs = T.layer_specs(layout.params["enc_blocks"])
    x = embeds.to(T._dtype(cfg.dtype))
    b, s, _ = x.shape
    start = act.start if act is not None else 0
    positions = torch.arange(start, start + s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    for block in T.unstacked(params["enc_blocks"], _n_enc_blocks(cfg)):
        x = T.run_block(_enc_block, remat, cfg, x, block, positions, act,
                        specs)
    x = L.rms_norm(x, params["enc_final_ln"], cfg.norm_eps)
    if act is not None and act.seq:
        x = C.all_gather(x, 1, act.seq, act.rules)
    return x


# --------------------------------------------------------------------------
# Cross-attention
# --------------------------------------------------------------------------

def _cross_kv(cfg: ArchConfig, cp: Params, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block's cross-attention K/V from the encoder output
    (B, e, D), in the decode cache's layout (B, KH, e, hd)."""
    kh, hd = cfg.n_kv_heads, cfg.head_dim_
    b, e, _ = enc_out.shape
    k = matmul(enc_out, cp["wk"]).reshape(b, e, kh, hd).transpose(1, 2)
    v = matmul(enc_out, cp["wv"]).reshape(b, e, kh, hd).transpose(1, 2)
    return k, v


def _cross_attn(cfg: ArchConfig, cp: Params, x: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The prefill's cross-attention sublayer with its residual: x (B, S,
    D) against the block's cross K/V (B, KH, e, hd) from `_cross_kv`
    (computed once, for the attention and the cache), in KV blocks of
    500 as the reference's."""
    b, s, _ = x.shape
    hx = L.rms_norm(x, cp["ln"], cfg.norm_eps)
    q = matmul(hx, cp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    o = L.blocked_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                            causal=False, block=500)
    return x + matmul(o.reshape(b, s, -1), cp["wo"])


def _cross_decode(cfg: ArchConfig, cp: Params, x: torch.Tensor,
                  cross_k: torch.Tensor, cross_v: torch.Tensor,
                  cross_pos: torch.Tensor) -> torch.Tensor:
    """The decode's cross-attention sublayer with its residual: x (B, T,
    D), each of the T queries one `decode_attention_combined` call over
    the slot's cross K/V (B, KH, E, hd) up to its last valid frame
    `cross_pos` (B,), in one chunk (`n_chunks=1`), no page table; its
    launches counted at the "cross" site."""
    b, t, _ = x.shape
    hx = L.rms_norm(x, cp["ln"], cfg.norm_eps)
    q = matmul(hx, cp["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim_)
    # the cross K/V is never split along its sequence (cache_specs): a
    # sequence-sharded mesh reads it whole, as one device does
    rules = active_rules()
    whole = use_rules(None) if rules is not None and rules.seq_shard_attn \
        else contextlib.nullcontext()
    with launch_site("cross"), whole:
        outs = [decode_attention_combined(q[:, j:j + 1].contiguous(),
                                          cross_k, cross_v, cross_pos,
                                          n_chunks=1)
                for j in range(t)]
    o = outs[0] if t == 1 else torch.cat(outs, dim=1)
    return x + matmul(o.reshape(b, t, -1), cp["wo"])


# --------------------------------------------------------------------------
# Decoder (training / evaluation): the loss and the full-sequence logits
# --------------------------------------------------------------------------

def _dec_block(cfg: ArchConfig, x: torch.Tensor, block: List[Params],
               cp: Params, enc_out: torch.Tensor,
               positions: torch.Tensor, act=None,
               specs: Optional[List[Params]] = None,
               cross_specs: Optional[Params] = None) -> torch.Tensor:
    cp = T.gathered(cp, cross_specs, act)
    for pos, kind in enumerate(cfg.block_pattern):
        p, sp = block[pos], (specs[pos] if specs is not None else {})
        x = T.attn_layer(cfg, T.gathered(p["attn"], sp.get("attn"), act),
                         x, kind, positions, act)
        x = _cross_attn(cfg, cp, x, *_cross_kv(cfg, cp, enc_out))
        x = T.ffn_layer(cfg, T.gathered(p["ffn"], sp.get("ffn"), act), x,
                        False)
    return x


def _decoder_forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                     enc_out: torch.Tensor, remat: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """`decoder_forward`, and the embedding table it used and the text's
    layout on a training mesh (the rank's span of its rows' tokens, its
    `embed` gathered from the vocab shards)."""
    layout = train_layout()
    act = specs = cross_specs = None
    emb = params["embed"]
    if layout is not None:
        act = layout.act(tokens.shape[1])
        tokens = tokens.narrow(1, act.start, act.length)
        emb = C.gather(emb, layout.params["embed"], rules=layout.rules)
        specs = T.layer_specs(layout.params["dec_blocks"])
        cross_specs = T.layer_specs(layout.params["cross"])
    x = emb[tokens]
    b, s, _ = x.shape
    start = act.start if act is not None else 0
    positions = torch.arange(start, start + s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    cross = T.unstacked([{"cross": params["cross"]}], cfg.n_blocks)
    for block, cp in zip(T.unstacked(params["dec_blocks"], cfg.n_blocks),
                         cross):
        x = T.run_block(_dec_block, remat, cfg, x, block, cp[0]["cross"],
                        enc_out, positions, act, specs, cross_specs)
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps), emb, act


def decoder_forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                    enc_out: torch.Tensor, *, remat: bool = True
                    ) -> torch.Tensor:
    """The decoder over the whole text (B, S) against the encoder output
    (B, e, D): causal self-attention (`transformer.attn_layer`), the
    block's cross-attention and the dense MLP per layer, each block
    recomputed in the backward under `remat`.  Returns the final-normed
    hidden states (B, S, D); on a training mesh, its rows' span."""
    return _decoder_forward(cfg, params, tokens, enc_out, remat)[0]


def loss_fn(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The chunked cross-entropy of the decoder on batch["tokens"] /
    ["labels"] over the encoding of batch["embeds"]; no aux loss.
    Returns (loss, {"ce", "aux"}): on a training mesh the global ones."""
    enc_out = encode(cfg, params, batch["embeds"], remat=True)
    x, emb, act = _decoder_forward(cfg, params, batch["tokens"], enc_out,
                                   True)
    labels = batch["labels"]
    if act is not None:
        labels = labels.narrow(1, act.start, act.length)
    ce = L.xent_loss_chunked(x, emb, labels, vocab=cfg.vocab,
                             rules=T._rules(act))
    return ce, {"ce": ce, "aux": ce.new_zeros(())}


def logits_fn(cfg: ArchConfig, params: Params,
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence decoder logits (B, S, V) in the model dtype."""
    enc_out = encode(cfg, params, batch["embeds"])
    x = decoder_forward(cfg, params, batch["tokens"], enc_out, remat=False)
    return matmul(x, params["embed"].T)


def prefill_cross_cache(cfg: ArchConfig, params: Params,
                        enc_out: torch.Tensor,
                        cache: Dict[str, Any]) -> Dict[str, Any]:
    """The whole-batch cross cache, the reference's: every decoder block's
    cross K/V from one encoder output (B, e, D), each row valid up to e.
    Returns a new cache dict sharing the other leaves, with `cross_k` /
    `cross_v` (n_blocks, B, KH, e, hd) and `enc_pos` = e."""
    kvs = [_cross_kv(cfg, cp[0]["cross"], enc_out) for cp in
           T.unstacked([{"cross": params["cross"]}], cfg.n_blocks)]
    out = dict(cache)
    out["cross_k"] = torch.stack([k for k, _ in kvs])
    out["cross_v"] = torch.stack([v for _, v in kvs])
    out["enc_pos"] = torch.full_like(cache["enc_pos"], enc_out.shape[1])
    return out


# --------------------------------------------------------------------------
# Decode with caches
# --------------------------------------------------------------------------

def _decoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The decoder's self-attention stack as the decoder-only config
    whose cache `transformer.init_cache` builds."""
    return dataclasses.replace(cfg, enc_dec=False)


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int, *,
               device: torch.device, dtype: Optional[str] = None,
               page_size: Optional[int] = None,
               kv_quant: Optional[str] = None) -> Dict[str, Any]:
    """The decoder's self-attention cache (`transformer.init_cache`: paged
    K/V, fp or int8 pools with page scales) plus the per-slot cross K/V
    `cross_k` / `cross_v` (n_blocks, B, KH, cfg.enc_len, hd), dense and fp
    (written once an admission, read whole), and `enc_pos` (B,) int32,
    each slot's encoder length: cross-attention reads rows < enc_pos[b]
    only.  It starts at enc_len (every row valid), as the reference's."""
    cache = T.init_cache(_decoder_cfg(cfg), batch_size, max_seq,
                         device=device, dtype=dtype, page_size=page_size,
                         kv_quant=kv_quant)
    dt = T._dtype(dtype or cfg.dtype)
    shape = (cfg.n_blocks, batch_size, cfg.n_kv_heads, cfg.enc_len,
             cfg.head_dim_)
    cache["cross_k"] = torch.zeros(shape, dtype=dt, device=device)
    cache["cross_v"] = torch.zeros(shape, dtype=dt, device=device)
    cache["enc_pos"] = torch.full((batch_size,), cfg.enc_len,
                                  dtype=torch.int32, device=device)
    return cache


def abstract_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
                   page_size: Optional[int] = None,
                   kv_quant: Optional[str] = None,
                   device: torch.device = torch.device("meta")
                   ) -> Dict[str, Any]:
    """`init_cache`'s leaves as meta tensors by default: shapes and
    dtypes, no storage."""
    return init_cache(cfg, batch_size, max_seq, device=device,
                      page_size=page_size, kv_quant=kv_quant)


def prefill_into_cache(cfg: ArchConfig, params: Params,
                       cache: Dict[str, Any], tokens: torch.Tensor,
                       row: int, length: int,
                       enc_embeds: Optional[torch.Tensor] = None, *,
                       enc_out: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill of ONE request into batch row `row`: its encoder pass over
    `enc_embeds` (1, e, D), or a precomputed `enc_out` (1, e, D) (exactly
    one of the two; the server encodes once an admission and hands the
    same output to the target's and a self-draft's prefill), then the
    decoder prompt tokens (P,) (padded; junk past `length` lands at slots
    the row's clock keeps invisible) through the flash_attention kernel,
    each block's cross-attention over the clip, and the FFN.

    Written IN PLACE into the row: each block's cross K/V at rows [0, e)
    of `cross_k` / `cross_v`, zeros past e; `enc_pos[row] = e`; the
    prompt's self-attention K/V through the page table (int8 pools by
    `transformer.quant_kv_write_rows`).  Returns (last-token logits (V,),
    cache)."""
    assert (enc_embeds is None) != (enc_out is None), \
        "pass exactly one of enc_embeds / enc_out"
    if enc_out is None:
        enc_out = encode(cfg, params, enc_embeds)
    e = enc_out.shape[1]
    assert e <= cache["cross_k"].shape[3], (e, cache["cross_k"].shape)
    p_len = tokens.shape[0]
    x = params["embed"][tokens[None]]                     # (1,P,D)
    positions = torch.arange(p_len, dtype=torch.int32,
                             device=x.device)[None]
    states: Dict[str, List[torch.Tensor]] = {}
    for i in range(cfg.n_blocks):
        cp = _cross_layer(params["cross"], i)
        ck, cv = _cross_kv(cfg, cp, enc_out)              # (1,KH,e,hd)
        for pi, (kind, block) in enumerate(zip(cfg.block_pattern,
                                               params["dec_blocks"])):
            p = T._layer(block, i)
            q, k, v = T._qkv(cfg, p["attn"], x, positions)
            o = ops.flash_attention(q, k, v, causal=True,
                                    window=T._window(cfg, kind))
            x = x + matmul(o.reshape(1, p_len, -1), p["attn"]["wo"])
            states.setdefault(f"k{pi}", []).append(k[0].transpose(0, 1))
            states.setdefault(f"v{pi}", []).append(v[0].transpose(0, 1))
            x = _cross_attn(cfg, cp, x, ck, cv)
            x = T.ffn_layer(cfg, p["ffn"], x, False)
        for key, val in (("cross_k", ck), ("cross_v", cv)):
            dst = cache[key][i, row]                      # (KH,E,hd)
            dst[:, :e].copy_(val[0])
            dst[:, e:].zero_()
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x[0, length - 1] @ params["embed"].T         # (V,)
    T.write_prompt_kv(cache, states, row)
    cache["enc_pos"][row] = e
    return logits, cache


# One slot's pages for the host tier: the transformer's functions cover
# every enc-dec leaf by shape (the 5-dim cross_k / cross_v like K/V panels
# but never cut by `upto`, the 1-dim enc_pos clock on axis 0).  There is
# no resume prefill: enc-dec prompts are keyed on audio frames.
extract_slot_cache = T.extract_slot_cache
insert_slot_cache = T.insert_slot_cache


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                write_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoder token per row against its self-attention cache and its
    cross K/V, `transformer.decode_step`'s contract: tokens (B, 1);
    `positions` (B,) per-row clocks (default the cache's scalar counter);
    rows where `write_mask` is False leave their K/V untouched.  Each
    row's cross-attention reads its cross K/V rows < enc_pos[b], so one
    batch mixes clips of different lengths.  Returns (logits (B,1,V),
    cache), the self-attention K/V written IN PLACE after the layer
    loop."""
    x = params["embed"][tokens]                           # (B,1,D)
    pos = cache["pos"] if positions is None else positions.to(torch.int32)
    pages = cache.get("page_table")
    cross_pos = cache["enc_pos"] - 1
    new_kv: Dict[str, List[torch.Tensor]] = {}
    for i in range(cfg.n_blocks):
        cp = _cross_layer(params["cross"], i)
        for pi, (kind, block) in enumerate(zip(cfg.block_pattern,
                                               params["dec_blocks"])):
            p = T._layer(block, i)
            x, knew, vnew = T._decode_attn(
                cfg, p["attn"], x, cache[f"k{pi}"][i], cache[f"v{pi}"][i],
                pos, pages, T.layer_kv_scales(cache, pi, i), kind)
            new_kv.setdefault(f"k{pi}", []).append(knew)
            new_kv.setdefault(f"v{pi}", []).append(vnew)
            x = _cross_decode(cfg, cp, x, cache["cross_k"][i],
                              cache["cross_v"][i], cross_pos)
            x = T.ffn_layer(cfg, p["ffn"], x, False)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = matmul(x, params["embed"].T)
    T.write_decode_kv(cache, new_kv, pos, write_mask)
    cache["pos"] = cache["pos"] + 1
    return logits, cache


def decode_verify(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                  tokens: torch.Tensor, positions: torch.Tensor,
                  write_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """The verify forward of speculative enc-dec decoding,
    `transformer.decode_verify`'s contract: tokens (B, T), row b's current
    token and T - 1 drafts from positions[b].  Self-attention is
    `transformer._verify_attn` (the T rows written IN PLACE under
    `write_mask`, then one decode call per query); cross-attention does
    not depend on the position, so each of the T queries makes the one
    token decode's cross read.  No recurrent state: the snapshots are
    empty.  Returns (logits (B, T, V), cache, {})."""
    x = params["embed"][tokens]                           # (B,T,D)
    pos = positions.to(torch.int32)
    pages = cache.get("page_table")
    cross_pos = cache["enc_pos"] - 1
    for i in range(cfg.n_blocks):
        cp = _cross_layer(params["cross"], i)
        li = slice(i, i + 1)
        for pi, (kind, block) in enumerate(zip(cfg.block_pattern,
                                               params["dec_blocks"])):
            p = T._layer(block, i)
            x = T._verify_attn(cfg, p["attn"], x, cache[f"k{pi}"][li],
                               cache[f"v{pi}"][li], pos, pages,
                               T.layer_kv_scales(cache, pi, li), write_mask,
                               kind)
            x = _cross_decode(cfg, cp, x, cache["cross_k"][i],
                              cache["cross_v"][i], cross_pos)
            x = T.ffn_layer(cfg, p["ffn"], x, False)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = matmul(x, params["embed"].T)
    cache["pos"] = cache["pos"] + tokens.shape[1]
    return logits, cache, {}
