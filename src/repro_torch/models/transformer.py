"""Decoder-only models of the ported paths, from
`repro/models/transformer.py`: init, the training forward with its loss
and the full-sequence logits, the decode cache (a paged KV cache
for attention layers, conv and SSM states for mamba layers), the
single-token decode step, the speculative verify forward over T tokens,
the prompt prefill into one cache row, one slot's pages out of and back
into the cache (the host tier), and the resume prefill of a prompt's
suffix behind restored prefix pages (the prefix cache).

Parameters keep the reference's pytree layout, with the per-layer leaves
stacked over `n_blocks`:

    {"embed": (V, D), "final_ln": (D,),
     "blocks": [{"attn": {ln, wq, wk, wv, wo}       # a "full" or "local"
                 | "mamba": {ln, w_z, w_x, w_B, w_C, w_dt, dt_bias, A_log,
                             D, conv_w, out_proj},  # a "mamba" position
                 "ffn": {ln, w_gate, w_up, w_down}}]}   # when d_ff > 0

with `w_gate`, `w_up` (n_blocks, d, f) and `w_down` (n_blocks, f, d).  At
an MoE position (`_is_moe_pos`) the FFN holds the expert stacks instead:
`{ln, router (n_blocks, d, E) f32, w_gate, w_up (n_blocks, E, d, f),
w_down (n_blocks, E, f, d)}`.

A quantized tree (`models.quantize.quantize_params`) has a block-quantized
`QTensor` in place of each dense projection stack; every product against
such a leaf goes through `quantize.matmul`.  The rank-4 expert stacks and
the f32 router stay fp, as in the reference.  An int8 KV cache
(`init_cache(kv_quant="int8")`) holds int8 K/V pools and one f32 scale per
(layer, row, KV head, physical page).

`jax.lax.scan` over the stacked blocks becomes a Python loop over layers.
Caches are updated IN PLACE (the reference donates them to jit for the
same effect); every function that takes a cache returns it too.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core import collectives as C
from repro_torch.core.backstream import (all_gather_model,
                                         cache_update_stacked,
                                         decode_attention_combined,
                                         physical_slots, seq_shard_start)
from repro_torch.kernels import ops
from repro_torch.kernels.quant import QTensor
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.quantize import matmul
from repro_torch.sharding import Act, Spec, active_rules, train_layout

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _check_supported(cfg: ArchConfig) -> None:
    """The decoder-only layer kinds: full and sliding-window ("local")
    attention, with RoPE or M-RoPE, mamba, dense MLP or MoE FFN.  An
    encoder-decoder config is served by `models/encdec.py`, which
    `registry.get_model` picks for it."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.arch_id}: an encoder-decoder config; its functions are "
            "models/encdec.py's (registry.get_model)")
    if any(k not in ("full", "local", "mamba") for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.arch_id}: only decoders of full, sliding-window and "
            "mamba layers are ported (layer kinds "
            f"{sorted(set(cfg.block_pattern))}; no ROADMAP item ports "
            "another)")


def _is_moe_pos(cfg: ArchConfig, pos: int) -> bool:
    """Position `pos` of the block pattern has an MoE FFN."""
    return cfg.is_moe and pos % cfg.moe_every == 0


def _window(cfg: ArchConfig, kind: str) -> int:
    """The attention window of a layer kind, as the reference passes it:
    `sliding_window` for a "local" layer (a query attends itself and the
    window - 1 slots before it), 0 (no lower bound) for a "full" one."""
    return cfg.sliding_window if kind == "local" else 0


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

class Draw:
    """The port's weight draws on one generator and device, in the model
    dtype: normal draws scaled by fan-in^-0.5 and zero norm scales, as the
    reference's.  Each leaf is drawn in f32 and cast; expert stacks one
    (block, expert) slice at a time, so the draw's f32 temporary is one
    slice, not the stack."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device: torch.device):
        self.generator, self.device = generator, device
        self.dt = _dtype(cfg.dtype)

    def normal(self, shape, scale) -> torch.Tensor:
        out = torch.randn(shape, generator=self.generator,
                          device=self.device, dtype=torch.float32)
        return out.mul_(scale).to(self.dt)

    def experts(self, shape, scale) -> torch.Tensor:
        out = torch.empty(shape, dtype=self.dt, device=self.device)
        for blk in range(shape[0]):
            for ex in range(shape[1]):
                out[blk, ex] = self.normal(shape[2:], scale)
        return out

    def zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dt, device=self.device)

    def f32(self, value, *shape) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)

    def f32_normal(self, shape, scale) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.device).mul_(scale)


class AbstractDraw(Draw):
    """`Draw`'s shapes and dtypes without a draw: uninitialised tensors
    on `device` (on the meta device, no storage at all), for the dry-run.
    No generator is touched."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__(cfg, None, device)

    def normal(self, shape, scale) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dt, device=self.device)

    experts = normal

    def zeros(self, *shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dt, device=self.device)

    def f32(self, value, *shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def f32_normal(self, shape, scale) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=self.device)


def _init_attn(cfg: ArchConfig, draw: Draw, nb: int) -> Params:
    """One attention sublayer's weights, stacked over nb blocks: {ln, wq,
    wk, wv, wo} (the decoder's cross-attention has the same leaves)."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {"ln": draw.zeros(nb, d),
            "wq": draw.normal((nb, d, h * hd), d ** -0.5),
            "wk": draw.normal((nb, d, kh * hd), d ** -0.5),
            "wv": draw.normal((nb, d, kh * hd), d ** -0.5),
            "wo": draw.normal((nb, h * hd, d), (h * hd) ** -0.5)}


def _init_mamba(cfg: ArchConfig, draw: Draw, nb: int) -> Params:
    d, di, n, nh, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.n_ssm_heads, cfg.conv_width)
    return {"ln": draw.zeros(nb, d),
            "w_z": draw.normal((nb, d, di), d ** -0.5),
            "w_x": draw.normal((nb, d, di), d ** -0.5),
            "w_B": draw.normal((nb, d, n), d ** -0.5),
            "w_C": draw.normal((nb, d, n), d ** -0.5),
            "w_dt": draw.normal((nb, d, nh), d ** -0.5),
            "dt_bias": draw.f32(0.0, nb, nh),
            "A_log": draw.f32(0.0, nb, nh),              # A = -exp(0) = -1
            "D": draw.f32(1.0, nb, nh),
            "conv_w": draw.normal((nb, w, di), w ** -0.5),
            "out_proj": draw.normal((nb, di, d), di ** -0.5)}


def _init_ffn(cfg: ArchConfig, draw: Draw, nb: int, moe: bool) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if moe:
        e = cfg.n_experts
        return {"ln": draw.zeros(nb, d),
                "router": draw.f32_normal((nb, d, e), d ** -0.5),
                "w_gate": draw.experts((nb, e, d, f), d ** -0.5),
                "w_up": draw.experts((nb, e, d, f), d ** -0.5),
                "w_down": draw.experts((nb, e, f, d), f ** -0.5)}
    return {"ln": draw.zeros(nb, d),
            "w_gate": draw.normal((nb, d, f), d ** -0.5),
            "w_up": draw.normal((nb, d, f), d ** -0.5),
            "w_down": draw.normal((nb, f, d), f ** -0.5)}


def init_block_params(cfg: ArchConfig, draw: Draw, nb: int
                      ) -> List[Params]:
    """The block pattern's layers, each leaf stacked over nb blocks: per
    pattern position {"attn" | "mamba": ..., "ffn": ...} (no "ffn" when
    d_ff is 0)."""
    blocks = []
    for pos, kind in enumerate(cfg.block_pattern):
        layer: Params = {}
        if kind == "mamba":
            layer["mamba"] = _init_mamba(cfg, draw, nb)
        else:
            layer["attn"] = _init_attn(cfg, draw, nb)
        if cfg.d_ff > 0:
            layer["ffn"] = _init_ffn(cfg, draw, nb, _is_moe_pos(cfg, pos))
        blocks.append(layer)
    return blocks


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """The port's own weight draw, with the reference's shapes, dtypes and
    scales (`Draw`).  Not bit-equal to the JAX draw: parity tests cross
    JAX weights through `repro_torch.interop` instead."""
    _check_supported(cfg)
    draw = Draw(cfg, generator, device)
    blocks = init_block_params(cfg, draw, cfg.n_blocks)
    return {"embed": draw.normal((cfg.padded_vocab, cfg.d_model),
                                 cfg.d_model ** -0.5),
            "blocks": blocks, "final_ln": draw.zeros(cfg.d_model)}


def abstract_params(cfg: ArchConfig,
                    device: torch.device = torch.device("meta")) -> Params:
    """`init_params`' tree of shapes and dtypes without a draw: meta
    tensors (no storage) by default, uninitialised ones on another
    `device`."""
    _check_supported(cfg)
    draw = AbstractDraw(cfg, device)
    return {"embed": draw.normal((cfg.padded_vocab, cfg.d_model), 0.0),
            "blocks": init_block_params(cfg, draw, cfg.n_blocks),
            "final_ln": draw.zeros(cfg.d_model)}


class _QLeaf(nn.Module):
    """A QTensor leaf: its tensors as buffers ("<path>.scales", ...), its
    format and input width as attributes."""

    def __init__(self, qt: QTensor):
        super().__init__()
        self.fmt, self.d_in = qt.fmt, qt.d_in
        self.register_buffer("scales", qt.scales)
        self.register_buffer("quants", qt.quants)
        self.register_buffer("mins", qt.mins)

    def tree(self) -> QTensor:
        return QTensor(self.scales, self.quants, self.mins, self.fmt,
                       self.d_in)


class _Tree(nn.Module):
    """Registers a nested dict of tensors (or QTensors) as buffers, one
    submodule per dict level, so `state_dict()` keys are the JAX pytree
    paths."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_buffer(key, val)
            elif isinstance(val, QTensor):
                self.add_module(key, _QLeaf(val))
            else:
                self.add_module(key, _Tree(val))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.named_buffers(recurse=False))
        for key, mod in self.named_children():
            out[key] = mod.tree()
        return out


class Transformer(nn.Module):
    """A thin module over the stacked parameters: buffers named by their
    JAX pytree paths ("blocks.0.attn.wq", ...), and the main-path
    functions of this module as methods."""

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.register_buffer("embed", params["embed"])
        self.register_buffer("final_ln", params["final_ln"])
        self.blocks = nn.ModuleList(_Tree(b) for b in params["blocks"])

    @property
    def params(self) -> Params:
        return {"embed": self.embed, "final_ln": self.final_ln,
                "blocks": [b.tree() for b in self.blocks]}

    def prefill_into_cache(self, cache, tokens, row, length):
        return prefill_into_cache(self.cfg, self.params, cache, tokens, row,
                                  length)

    def decode_step(self, cache, tokens, positions=None, write_mask=None):
        return decode_step(self.cfg, self.params, cache, tokens, positions,
                           write_mask)


def _layer(block: Dict[str, Dict[str, Any]], i: int
           ) -> Dict[str, Dict[str, Any]]:
    """Layer i's weights: views into the stacked leaves (of each of a
    QTensor's tensors, keeping its format and input width)."""
    return {sub: {k: w.layer(i) if isinstance(w, QTensor) else w[i]
                  for k, w in leaves.items()}
            for sub, leaves in block.items()}


# --------------------------------------------------------------------------
# Layer applications
# --------------------------------------------------------------------------

def _qkv(cfg: ArchConfig, p: Params, x: torch.Tensor,
         positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    hx = L.rms_norm(x, p["ln"], cfg.norm_eps)
    q = matmul(hx, p["wq"]).reshape(b, s, h, hd)
    k = matmul(hx, p["wk"]).reshape(b, s, kh, hd)
    v = matmul(hx, p["wv"]).reshape(b, s, kh, hd)
    if cfg.mrope:
        # text positions on all three streams (the vision frontend, which
        # would give image tokens their own (t, h, w), is not served)
        pos3 = positions[..., None].expand(positions.shape + (3,))
        q = L.apply_mrope(q, pos3, cfg.rope_theta, _mrope_sections(hd))
        k = L.apply_mrope(k, pos3, cfg.rope_theta, _mrope_sections(hd))
    else:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mrope_sections(hd: int) -> Tuple[int, int, int]:
    half = hd // 2
    t = half - 2 * (half // 4)
    return (t, half // 4, half // 4)


def _ffn(cfg: ArchConfig, p: Params, hx: torch.Tensor,
         moe: bool) -> torch.Tensor:
    """The FFN of the normed input: the dense gated MLP, or (`moe`) the MoE
    FFN over the B*S rows flattened row-major, as the reference routes
    them (a verify's rows in (b, t) order)."""
    if moe:
        b, s, d = hx.shape
        y = L.moe_ffn(hx.reshape(b * s, d), p["router"], p["w_gate"],
                      p["w_up"], p["w_down"], cfg.top_k)
        return y.reshape(b, s, d)
    return L.gated_mlp(hx, p["w_gate"], p["w_up"], p["w_down"])


def ffn_layer(cfg: ArchConfig, p: Params, x: torch.Tensor,
              moe: bool) -> torch.Tensor:
    """The FFN sublayer with its residual (`_ffn`)."""
    return x + _ffn(cfg, p, L.rms_norm(x, p["ln"], cfg.norm_eps), moe)


def ffn_layer_aux(cfg: ArchConfig, p: Params, x: torch.Tensor,
                  moe: bool, act: Optional[Act] = None,
                  specs: Optional[Params] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward's FFN sublayer, the reference's `ffn_layer`:
    `ffn_layer`'s output and the MoE load-balancing loss of its B*S routed
    rows (a zero f32 scalar for a dense FFN).  On a mesh (`act`: x's
    layout) an MoE FFN is `layers.moe_ffn_dist` on the expert stacks as
    the rank stores them (under `specs`), and the loss is the global
    one."""
    hx = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if not moe:
        return (x + _ffn(cfg, p, hx, False),
                hx.new_zeros((), dtype=torch.float32))
    aux = L.moe_aux_loss(hx.reshape(-1, hx.shape[-1]), p["router"],
                         cfg.top_k, _rules(act))
    w_specs = None if specs is None else tuple(
        specs[k] for k in ("w_gate", "w_up", "w_down"))
    y = L.moe_ffn_dist(hx, p["router"], p["w_gate"], p["w_up"],
                       p["w_down"], cfg.top_k, act=act, w_specs=w_specs)
    return x + y, aux


def _mamba_proj(cfg: ArchConfig, p: Params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """The mamba sublayer's input projections: (z gate, conv INPUT, B, C,
    dt BEFORE its softplus (f32, biased), A) for the decode, verify and
    prefill variants, which differ only in how they run the conv and the
    SSD recurrence (and the verify in how it runs the softplus)."""
    hx = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z = F.silu(matmul(hx, p["w_z"]))
    xin = matmul(hx, p["w_x"])
    Bm = matmul(hx, p["w_B"])
    Cm = matmul(hx, p["w_C"])
    dt_raw = matmul(hx, p["w_dt"]).float() + p["dt_bias"]
    A = -torch.exp(p["A_log"])
    return z, xin, Bm, Cm, dt_raw, A


def _mamba_out(p: Params, x: torch.Tensor, y: torch.Tensor,
               xc: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y (b,s,nh,hp) plus the D skip of the conv output xc, gated by z,
    projected back and added to the residual x."""
    b, s = x.shape[:2]
    y = y + xc.reshape(y.shape) * p["D"][:, None].to(xc.dtype)
    y = (y.reshape(b, s, -1) * z).to(x.dtype)
    return x + matmul(y, p["out_proj"])


# --------------------------------------------------------------------------
# Forward (training / evaluation): the loss and the full-sequence logits
# --------------------------------------------------------------------------

AUX_LOSS_COEF = 0.01


def attn_layer(cfg: ArchConfig, p: Params, x: torch.Tensor, kind: str,
               positions: torch.Tensor, act: Optional[Act] = None
               ) -> torch.Tensor:
    """The training forward's attention sublayer with its residual: a
    "local" layer longer than its window on the banded
    `sliding_attention`, every other one causal `blocked_attention`, both
    in full f32 as the reference's plain XLA.  On a mesh whose layout
    `act` splits the sequence, x is the rank's span: its queries attend
    the K/V gathered over the model axis, masked by global position
    (causal, and the window of a "local" layer)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    if act is not None and act.seq:
        k = C.all_gather(k, 1, act.seq, act.rules)
        v = C.all_gather(v, 1, act.seq, act.rules)
        window = (cfg.sliding_window
                  if kind == "local" and act.s > cfg.sliding_window else 0)
        o = L.blocked_attention(q, k, v, causal=True, q_offset=act.start,
                                window=window)
    elif kind == "local" and s > cfg.sliding_window:
        o = L.sliding_attention(q, k, v, window=cfg.sliding_window)
    else:
        o = L.blocked_attention(q, k, v, causal=True)
    return x + matmul(o.reshape(b, s, cfg.n_heads * cfg.head_dim_), p["wo"])


def mamba_layer(cfg: ArchConfig, p: Params, x: torch.Tensor,
                act: Optional[Act] = None) -> torch.Tensor:
    """The training forward's mamba sublayer: the conv over the whole
    sequence from a zero state and the chunked SSD scan
    (`layers.ssd_chunked`, plain torch: the reference's training path
    reaches no kernel).  On a mesh whose layout `act` splits the
    sequence, the rank gathers the whole sequence of its rows, runs the
    sublayer over it in order and keeps its span: n_model ranks repeat
    one row's scan (a state pass between spans would not)."""
    if act is not None and act.seq:
        whole = mamba_layer(cfg, p, C.all_gather(x, 1, act.seq, act.rules))
        return whole.narrow(1, act.start, act.length)
    b, s, _ = x.shape
    z, xin, Bm, Cm, dt_raw, A = _mamba_proj(cfg, p, x)
    xc, _ = L.causal_conv1d(xin, p["conv_w"])
    y, _ = L.ssd_chunked(xc.reshape(b, s, cfg.n_ssm_heads, cfg.ssm_head_dim),
                         F.softplus(dt_raw), A, Bm, Cm)
    return _mamba_out(p, x, y, xc, z)


def unstacked(blocks: List[Params], n: int) -> List[List[Params]]:
    """Layer i's weights for i < n, as `_layer` gives them, from ONE
    `unbind` of each stacked leaf: under autograd one `stack` then
    assembles a leaf's gradient, where a view a layer (`w[i]`) would add
    each layer's gradient into a zero tensor of the whole stack."""
    unbound = [{sub: {k: w.unbind(0) for k, w in leaves.items()}
                for sub, leaves in block.items()} for block in blocks]
    return [[{sub: {k: ws[i] for k, ws in leaves.items()}
              for sub, leaves in block.items()} for block in unbound]
            for i in range(n)]


def run_block(fn, remat: bool, *args):
    """fn(*args), under `remat` through `torch.utils.checkpoint` (the
    reference's per-block `jax.checkpoint` with `nothing_saveable`): only
    the block's inputs are kept for the backward, which runs the block's
    forward again."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _embed(cfg: ArchConfig, params: Params,
           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The token embeddings, or a stub frontend's `embeds` (B, S, D) in
    their place (qwen2_vl's patches), in the model dtype."""
    if "embeds" in batch:
        return batch["embeds"].to(_dtype(cfg.dtype))
    return params["embed"][batch["tokens"]]


def layer_specs(stacked: Any) -> Any:
    """The specs of one layer's leaves from a stacked tree's specs (the
    leading n_blocks dim dropped; it is never split)."""
    if isinstance(stacked, dict):
        return {k: layer_specs(v) for k, v in stacked.items()}
    if isinstance(stacked, Spec):
        return Spec(*stacked[1:])
    return type(stacked)(layer_specs(v) for v in stacked)


def gathered(p: Params, specs: Optional[Params], act: Optional[Act],
             keep: Tuple[str, ...] = ()) -> Params:
    """A sublayer's weights gathered from the rank's shards (with their
    gradients: a reduce-scatter in the backward), the leaves named in
    `keep` left as stored (the MoE expert stacks, which `moe_ffn_dist`
    gathers as its branch needs).  `specs` None: the weights as given."""
    if specs is None:
        return p
    return {k: w if k in keep else C.gather(w, specs[k], rules=act.rules)
            for k, w in p.items()}


_EXPERTS = ("w_gate", "w_up", "w_down")


def _block_fn(cfg: ArchConfig, x: torch.Tensor, block: List[Params],
              positions: torch.Tensor, act: Optional[Act] = None,
              specs: Optional[List[Params]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of the pattern: each position's attention or mamba
    sublayer, then its FFN.  Returns (x, the block's MoE aux loss).  On a
    mesh (`act`, the rank's layer `specs`) each sublayer's weights are
    gathered here, inside the recomputed block: its backward gathers
    them again, and nothing gathered outlives the block."""
    aux = x.new_zeros((), dtype=torch.float32)
    for pos, kind in enumerate(cfg.block_pattern):
        p, sp = block[pos], (specs[pos] if specs is not None else {})
        if kind == "mamba":
            x = mamba_layer(cfg, gathered(p["mamba"], sp.get("mamba"), act),
                            x, act)
        else:
            x = attn_layer(cfg, gathered(p["attn"], sp.get("attn"), act),
                           x, kind, positions, act)
        if cfg.d_ff > 0:
            moe = _is_moe_pos(cfg, pos)
            x, a = ffn_layer_aux(
                cfg, gathered(p["ffn"], sp.get("ffn"), act,
                              _EXPERTS if moe else ()),
                x, moe, act, sp.get("ffn"))
            aux = aux + a
    return x, aux


def _span(t: Optional[torch.Tensor], act: Optional[Act]
          ) -> Optional[torch.Tensor]:
    """The rank's span of a (B, S, ...) batch tensor."""
    if t is None or act is None:
        return t
    return t.narrow(1, act.start, act.length)


def _forward(cfg: ArchConfig, params: Params,
             batch: Dict[str, torch.Tensor], remat: bool
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        Optional[Act]]:
    """`forward`, and the embedding table it used and the activations'
    layout: on a training mesh (`sharding.train_layout()`) the rank's
    rows and span, its `embed` gathered from the vocab shards."""
    _check_supported(cfg)
    layout = train_layout()
    specs = act = None
    emb = params["embed"]
    if layout is not None:
        specs = layout.params
        act = layout.act(next(iter(batch.values())).shape[1])
        batch = {k: _span(v, act) for k, v in batch.items()}
        emb = C.gather(emb, specs["embed"], rules=layout.rules)
    x = _embed(cfg, {"embed": emb}, batch)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        start = act.start if act is not None else 0
        positions = torch.arange(start, start + s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    block_specs = None if specs is None else layer_specs(specs["blocks"])
    aux = x.new_zeros((), dtype=torch.float32)
    for block in unstacked(params["blocks"], cfg.n_blocks):
        x, a = run_block(_block_fn, remat, cfg, x, block, positions, act,
                         block_specs)
        aux = aux + a
    return L.rms_norm(x, params["final_ln"], cfg.norm_eps), aux, emb, act


def forward(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward: batch {"tokens" (B, S) | "embeds" (B, S,
    D), optional "positions" (B, S)}.  `remat` recomputes each block in
    the backward.  Returns (final hidden states (B, S, D), the total MoE
    aux loss).  On a training mesh (`sharding.train_layout()`): the
    batch holds the rank's rows (`partition.batch_specs`), the
    parameters its shards, and it returns its rows' span and the global
    aux loss."""
    x, aux, _, _ = _forward(cfg, params, batch, remat)
    return x, aux


def loss_fn(cfg: ArchConfig, params: Params,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss: the chunked cross-entropy against the tied
    embedding on batch["labels"], plus AUX_LOSS_COEF x the MoE aux loss.
    Returns (loss, {"ce", "aux"}), f32 scalars: on a training mesh the
    global ones, the same on every rank."""
    x, aux, emb, act = _forward(cfg, params, batch, True)
    ce = L.xent_loss_chunked(x, emb, _span(batch["labels"], act),
                             vocab=cfg.vocab, rules=_rules(act))
    return ce + AUX_LOSS_COEF * aux, {"ce": ce, "aux": aux}


def _rules(act: Optional[Act]):
    """The rules of a training mesh (None: one device)."""
    return None if act is None else act.rules


def logits_fn(cfg: ArchConfig, params: Params,
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence logits (B, S, V) in the model dtype (no remat)."""
    x, _ = forward(cfg, params, batch, remat=False)
    return matmul(x, params["embed"].T)


# --------------------------------------------------------------------------
# Decode: caches + single-token step
# --------------------------------------------------------------------------

def default_page_size(max_seq: int) -> int:
    """The largest divisor of max_seq not above 128: the dense fused
    decode's chunk rule, so the identity page table reproduces the dense
    kernel's walk (and its bits) exactly."""
    ps = max(1, min(128, max_seq))
    while max_seq % ps:
        ps -= 1
    return ps


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int, *,
               device: torch.device, dtype: Optional[str] = None,
               page_size: Optional[int] = None,
               kv_quant: Optional[str] = None) -> Dict[str, Any]:
    """Decode caches stacked over n_blocks.  An attention position i has
    K/V caches `k{i}`/`v{i}` in the flash-decoding layout (L, B, KH, S,
    hd), and the cache a (B, n_pages) int32 `page_table` (identity at
    init): logical row r of batch row b lives at physical row
    `table[b, r // page] * page + r % page` of the same panel.  A mamba
    position i has `conv{i}` (L, B, W-1, d_inner) in the model dtype and
    `ssm{i}` (L, B, NH, P, N) f32; a cache without attention has no
    page table.

    `kv_quant="int8"`: the K/V panels are int8 pools, each with one f32
    scale per (layer, row, KV head, PHYSICAL page) in `kscale{i}` /
    `vscale{i}` (L, B, KH, n_pages); recurrent states stay fp."""
    _check_supported(cfg)
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unknown KV format: {kv_quant}")
    dt = _dtype(dtype or cfg.dtype)
    nb, kh, hd = cfg.n_blocks, cfg.n_kv_heads, cfg.head_dim_
    ps = 0
    if cfg.has_attention:
        ps = page_size or default_page_size(max_seq)
        assert max_seq % ps == 0, (max_seq, ps)
    kv_dt = torch.int8 if kv_quant else dt
    cache: Dict[str, Any] = {
        "pos": torch.zeros((), dtype=torch.int32, device=device)}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "mamba":
            cache[f"conv{i}"] = torch.zeros(
                (nb, batch_size, cfg.conv_width - 1, cfg.d_inner),
                dtype=dt, device=device)
            cache[f"ssm{i}"] = torch.zeros(
                (nb, batch_size, cfg.n_ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state), dtype=torch.float32, device=device)
            continue
        for name in (f"k{i}", f"v{i}"):
            cache[name] = torch.zeros((nb, batch_size, kh, max_seq, hd),
                                      dtype=kv_dt, device=device)
            if kv_quant:
                cache[scale_key(name)] = torch.zeros(
                    (nb, batch_size, kh, max_seq // ps),
                    dtype=torch.float32, device=device)
    if ps:
        cache["page_table"] = torch.arange(
            max_seq // ps, dtype=torch.int32, device=device).repeat(
                batch_size, 1)
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


def scale_key(kv_key: str) -> str:
    """The scale leaf of an int8 K/V leaf: k{i} -> kscale{i}."""
    return kv_key[0] + "scale" + kv_key[1:]


def layer_kv_scales(cache: Dict[str, Any], pi: int, layer
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Pattern position pi's (k, v) page scales at `layer` (an index or a
    slice of the stack) for an int8 cache, None for an fp one."""
    if scale_key(f"k{pi}") not in cache:
        return None
    return (cache[scale_key(f"k{pi}")][layer],
            cache[scale_key(f"v{pi}")][layer])


def cache_kv_quant(cache: Dict[str, Any]) -> Optional[str]:
    """The cache's KV quantization mode, read from its scale leaves."""
    return "int8" if any(k[:6] in ("kscale", "vscale") for k in cache) \
        else None


def cache_page_size(cache: Dict[str, Any]) -> int:
    """Page size of a cache: the seq axis of a K leaf (the first attention
    position's, which a hybrid pattern need not start with) over the page
    count."""
    k = next(v for key, v in cache.items()
             if key[0] == "k" and key[1:].isdigit())
    return k.shape[3] // cache["page_table"].shape[1]


def _decode_attn(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: torch.Tensor, pages: Optional[torch.Tensor],
                 kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]],
                 kind: str
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against one layer's cache (B,KH,S,hd), int8
    pools when `kv_scales` (B,KH,n_pages) are given.  The cache is
    READ-ONLY here: it holds tokens [0, pos), and the current token's own
    contribution arrives as the merged `extra` partial, always fp (its
    K/V is not written yet); the returned (k_new, v_new) (B,KH,1,hd) are
    written for all layers after the layer loop.  A "local" layer of
    window W reads the W - 1 cached slots before pos (window W - 1 against
    the clock pos - 1, as the reference passes it), which with the
    current token are the W tokens the prefill's window W gives a query."""
    b = x.shape[0]
    positions = pos.reshape(-1, 1).expand(b, 1).to(torch.int32)
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    extra = L.single_kv_partial(q, k_new, v_new)
    o = decode_attention_combined(q, k_cache, v_cache, pos - 1,
                                  window=max(0, _window(cfg, kind) - 1),
                                  extra=extra, pages=pages,
                                  kv_scales=kv_scales)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim_)
    return (x + matmul(o, p["wo"]), k_new.transpose(1, 2),
            v_new.transpose(1, 2))


def _decode_mamba(cfg: ArchConfig, p: Params, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token through a mamba sublayer: x (B,1,D) against one layer's
    conv (B,W-1,d_inner) and SSM (B,NH,P,N) states, which are read only.
    Returns (x, new conv state, new SSM state)."""
    b = x.shape[0]
    nh, hp = cfg.n_ssm_heads, cfg.ssm_head_dim
    z, xin, Bm, Cm, dt_raw, A = _mamba_proj(cfg, p, x)
    nh_l = ssm_state.shape[1]
    if nh_l != nh:
        return _decode_mamba_heads(cfg, p, x, z, xin, Bm, Cm, dt_raw, A,
                                   conv_state, ssm_state)
    xc, conv_state = L.causal_conv1d(xin, p["conv_w"], conv_state)
    y, ssm_state = L.ssd_decode_step(
        ssm_state, xc[:, 0].reshape(b, nh, hp), F.softplus(dt_raw)[:, 0], A,
        Bm[:, 0], Cm[:, 0])
    return (_mamba_out(p, x, y[:, None], xc, z), conv_state, ssm_state)


def _decode_mamba_heads(cfg: ArchConfig, p: Params, x: torch.Tensor,
                        z, xin, Bm, Cm, dt_raw, A, conv_state: torch.Tensor,
                        ssm_state: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_decode_mamba` over a model rank's head group: under
    `partition.cache_specs` on a model axis of n ranks a mamba layer's
    states are the rank's NH / n heads (SSM (B, NH/n, P, N)) and their
    channels (conv (B, W-1, d_inner/n); d_inner = NH P, so the two
    groups line up).  The rank runs the conv and the SSD step on its
    group alone; the groups' outputs and conv outputs cross ranks in ONE
    all-gather along the model axis, and every rank finishes the layer
    on the whole of them."""
    b = x.shape[0]
    nh_l, hp = ssm_state.shape[1], cfg.ssm_head_dim
    c_l = nh_l * hp
    if conv_state.shape[-1] != c_l:
        raise ValueError(
            f"{cfg.arch_id}: the conv state's {conv_state.shape[-1]} "
            f"channels are not the SSM state's {nh_l} heads x {hp}: "
            f"cache_specs split them apart")
    rules = active_rules()
    r = rules.rank(rules.model_axis)
    heads = slice(r * nh_l, (r + 1) * nh_l)
    chans = slice(r * c_l, (r + 1) * c_l)
    xc_l, conv_state = L.causal_conv1d(xin[..., chans].contiguous(),
                                       p["conv_w"][:, chans], conv_state)
    y_l, ssm_state = L.ssd_decode_step(
        ssm_state, xc_l[:, 0].reshape(b, nh_l, hp),
        F.softplus(dt_raw)[:, 0, heads], A[heads], Bm[:, 0], Cm[:, 0])
    parts = all_gather_model(torch.cat([y_l.reshape(b, 1, c_l), xc_l],
                                       dim=-1))
    y = torch.cat([t[..., :c_l] for t in parts], dim=-1)
    xc = torch.cat([t[..., c_l:] for t in parts], dim=-1)
    return (_mamba_out(p, x, y.reshape(b, 1, cfg.n_ssm_heads, hp), xc, z),
            conv_state, ssm_state)


def _write_state(cache: torch.Tensor, new: torch.Tensor,
                 write_mask: Optional[torch.Tensor]) -> None:
    """Write one layer's new recurrent state (B, ...) over its cache slice
    IN PLACE; rows where `write_mask` is False keep their old value."""
    if write_mask is not None:
        keep = write_mask.reshape((-1,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new.to(cache.dtype), cache)
    cache.copy_(new)


def masked_kv_update(cache: torch.Tensor, new: torch.Tensor,
                     slot_b: torch.Tensor,
                     write_mask: torch.Tensor) -> torch.Tensor:
    """Replace masked-out rows of a stacked one-token K/V update with the
    cache's current value at each row's slot, so the write that follows
    is a no-op for them.  cache (L,B,KH,S,hd); new (L,B,KH,1,hd); slot_b,
    write_mask (B,)."""
    b = cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    old = cache[:, rows, :, slot_b.long(), :]            # (B,L,KH,hd)
    old = old.permute(1, 0, 2, 3)[:, :, :, None, :]      # (L,B,KH,1,hd)
    return torch.where(write_mask[None, :, None, None, None], new,
                       old.to(new.dtype))


def decode_step(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                write_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decoding step.  tokens: (B, 1) int.  `positions`: optional (B,)
    per-row token positions; defaults to the cache's scalar step counter.
    `write_mask`: optional (B,) bool; rows where it is False compute
    logits but leave their cached K/V untouched.  Returns (logits (B,1,V),
    cache), the cache updated IN PLACE: all layers' new K/V are written
    at each row's ring slot after the layer loop, through the page table;
    a mamba layer's new conv and SSM states replace its own (which no
    other layer reads) as soon as it has run, under the same mask.
    """
    x = params["embed"][tokens]                           # (B,1,D)
    pos = cache["pos"] if positions is None else positions.to(torch.int32)
    pages = cache.get("page_table")
    new_kv: Dict[str, List[torch.Tensor]] = {}
    for i in range(cfg.n_blocks):
        for pi, (kind, block) in enumerate(zip(cfg.block_pattern,
                                               params["blocks"])):
            p = _layer(block, i)
            if kind == "mamba":
                conv, ssm = cache[f"conv{pi}"][i], cache[f"ssm{pi}"][i]
                x, cnew, snew = _decode_mamba(cfg, p["mamba"], x, conv, ssm)
                _write_state(conv, cnew, write_mask)
                _write_state(ssm, snew, write_mask)
            else:
                x, knew, vnew = _decode_attn(cfg, p["attn"], x,
                                             cache[f"k{pi}"][i],
                                             cache[f"v{pi}"][i], pos, pages,
                                             layer_kv_scales(cache, pi, i),
                                             kind)
                new_kv.setdefault(f"k{pi}", []).append(knew)
                new_kv.setdefault(f"v{pi}", []).append(vnew)
            if cfg.d_ff > 0:
                x = ffn_layer(cfg, p["ffn"], x, _is_moe_pos(cfg, pi))
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = matmul(x, params["embed"].T)
    write_decode_kv(cache, new_kv, pos, write_mask)
    cache["pos"] = cache["pos"] + 1
    return logits, cache


def write_decode_kv(cache: Dict[str, Any],
                    new_kv: Dict[str, List[torch.Tensor]],
                    pos: torch.Tensor,
                    write_mask: Optional[torch.Tensor]) -> None:
    """A decode step's new K/V, IN PLACE: for each K/V leaf of `new_kv`
    its layers' (B,KH,1,hd) rows, written at each row's ring slot pos %
    S through the page table (int8 pools by `quant_kv_update_stacked`);
    rows where `write_mask` is False keep their old values."""
    if not new_kv:
        return
    pages = cache.get("page_table")
    first = cache[next(iter(new_kv))]
    b = first.shape[1]
    _, max_seq = seq_shard_start(first.shape[3])
    slot = (pos % max_seq).to(torch.int32).reshape(-1).expand(b)
    if pages is not None:
        slot = physical_slots(pages, slot, max_seq // pages.shape[1])
    for key, rows in new_kv.items():
        new = torch.stack(rows)                           # (L,B,KH,1,hd)
        if scale_key(key) in cache:
            # int8 pool: page-scale merge and masked rows inside
            quant_kv_update_stacked(cache[key], cache[scale_key(key)], new,
                                    slot, write_mask)
            continue
        if write_mask is not None:
            new = masked_kv_update(cache[key], new, slot, write_mask)
        cache_update_stacked(cache[key], new, slot)


# --------------------------------------------------------------------------
# Speculative verify: T positions in one forward
# --------------------------------------------------------------------------

def _verify_attn(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: torch.Tensor, pages: Optional[torch.Tensor],
                 kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]],
                 write_mask: Optional[torch.Tensor],
                 kind: str) -> torch.Tensor:
    """T-position attention of the verify forward against one layer's
    cache (1, B, KH, S, hd), int8 pools when `kv_scales` (1, B, KH,
    n_pages) are given: x (B, T, D) is row b's current token and T-1
    draft tokens, starting at position pos[b].

    The T new K/V rows are written into the LIVE cache first, IN PLACE,
    under `write_mask` and through the page table (the int8 pools by T
    sequential one-token writes, so each row lands under the page scale
    its sequential decode would give it); the reference writes them into
    a per-layer copy of the cache and the live one after the layer loop,
    which leaves alive rows the same bytes.  Query j then reads under the
    clock pos + j - 1, so of the fresh rows it sees exactly the j before
    it, and its own K/V arrives as the merged extra partial: each of the
    T calls is the one-token `_decode_attn` call of a sequential decode
    at position pos + j, with that call's window.  A masked row's outputs
    read its old rows; the segment discards them."""
    b, t, _ = x.shape
    positions = pos[:, None] + torch.arange(t, dtype=torch.int32,
                                            device=x.device)[None]
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    if kv_scales is not None:
        quant_verify_kv_update(k_cache, kv_scales[0], k_new[None], pos,
                               write_mask, pages)
        quant_verify_kv_update(v_cache, kv_scales[1], v_new[None], pos,
                               write_mask, pages)
        kv_scales = (kv_scales[0][0], kv_scales[1][0])
    else:
        verify_kv_update(k_cache, k_new[None], pos, write_mask, pages)
        verify_kv_update(v_cache, v_new[None], pos, write_mask, pages)
    window = max(0, _window(cfg, kind) - 1)
    outs = []
    for j in range(t):
        qj = q[:, j:j + 1].contiguous()
        extra = L.single_kv_partial(qj, k_new[:, j:j + 1],
                                    v_new[:, j:j + 1])
        outs.append(decode_attention_combined(
            qj, k_cache[0], v_cache[0], pos + (j - 1), window=window,
            extra=extra, pages=pages, kv_scales=kv_scales))
    o = torch.cat(outs, dim=1).reshape(b, t, cfg.n_heads * cfg.head_dim_)
    return x + matmul(o, p["wo"])


def _verify_mamba(cfg: ArchConfig, p: Params, x: torch.Tensor,
                  conv_state: torch.Tensor, ssm_state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T tokens through a mamba sublayer: x (B, T, D) against one layer's
    conv (B, W-1, d_inner) and SSM (B, NH, P, N) states, read only.  The
    projections run once over the T tokens; the conv window and the SSD
    update run as T steps of `_decode_mamba`'s exact one-token math.
    Returns (x, conv_snaps (B, T, W-1, d_inner), ssm_snaps (B, T, NH, P,
    N) f32): snapshot j is the state after tokens 0..j."""
    b, t, _ = x.shape
    nh, hp = cfg.n_ssm_heads, cfg.ssm_head_dim
    z, xin, Bm, Cm, dt_raw, A = _mamba_proj(cfg, p, x)
    xcs, ys, convs, ssms = [], [], [], []
    for j in range(t):
        xc, conv_state = L.causal_conv1d(xin[:, j:j + 1], p["conv_w"],
                                         conv_state)
        # the softplus on this token's (B, 1, NH) alone, as the decode
        # runs it: the CPU's SIMD loop and its scalar tail differ in the
        # last bit, so a value's bits depend on the length of its tensor
        dt = F.softplus(dt_raw[:, j:j + 1].contiguous())
        y, ssm_state = L.ssd_decode_step(
            ssm_state, xc[:, 0].reshape(b, nh, hp), dt[:, 0], A, Bm[:, j],
            Cm[:, j])
        xcs.append(xc)
        ys.append(y)
        convs.append(conv_state)
        ssms.append(ssm_state)
    out = _mamba_out(p, x, torch.stack(ys, dim=1), torch.cat(xcs, dim=1), z)
    return out, torch.stack(convs, dim=1), torch.stack(ssms, dim=1)


def decode_verify(cfg: ArchConfig, params: Params, cache: Dict[str, Any],
                  tokens: torch.Tensor, positions: torch.Tensor,
                  write_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """The verify forward of speculative decoding: tokens (B, T), row b's
    current token and T-1 draft tokens from position positions[b], in ONE
    forward.  Returns (logits (B, T, V), cache, snaps): position j's
    logits are those of a sequential `decode_step` at positions[b] + j.
    Every attention call is bitwise the decode's; the projections and
    norms run over B*T rows where the decode's run over B, which gives
    the same bits on the CPU but not always on the card, where cuBLAS
    and the reduction kernels choose their split by the row count: a
    decode step under `quantize.padded_rows(B*T)` computes these bits.

    Attention K/V: all T rows are written IN PLACE at logical slots
    pos..pos+T-1 for the rows where `write_mask` holds (`_verify_attn`);
    the segment then advances each clock by only the m <= T accepted
    tokens, and the rows past it stay invisible until decoded tokens
    overwrite them.  Recurrent (conv, SSM) state: the cache's is returned
    UNTOUCHED and every intermediate state is in `snaps`, leaves (L, B,
    T, ...), from which the segment gathers snapshot m - 1 per row."""
    x = params["embed"][tokens]                           # (B,T,D)
    pos = positions.to(torch.int32)
    pages = cache.get("page_table")
    b, t, _ = x.shape
    snaps: Dict[str, torch.Tensor] = {}
    for pi, kind in enumerate(cfg.block_pattern):
        if kind == "mamba":
            for key in (f"conv{pi}", f"ssm{pi}"):
                c = cache[key]
                snaps[key] = c.new_empty((c.shape[0], b, t) + c.shape[2:])
    for i in range(cfg.n_blocks):
        for pi, (kind, block) in enumerate(zip(cfg.block_pattern,
                                               params["blocks"])):
            p = _layer(block, i)
            if kind == "mamba":
                x, conv_s, ssm_s = _verify_mamba(
                    cfg, p["mamba"], x, cache[f"conv{pi}"][i],
                    cache[f"ssm{pi}"][i])
                snaps[f"conv{pi}"][i] = conv_s
                snaps[f"ssm{pi}"][i] = ssm_s
            else:
                li = slice(i, i + 1)
                x = _verify_attn(cfg, p["attn"], x, cache[f"k{pi}"][li],
                                 cache[f"v{pi}"][li], pos, pages,
                                 layer_kv_scales(cache, pi, li), write_mask,
                                 kind)
            if cfg.d_ff > 0:
                x = ffn_layer(cfg, p["ffn"], x, _is_moe_pos(cfg, pi))
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = matmul(x, params["embed"].T)
    cache["pos"] = cache["pos"] + t
    return logits, cache, snaps


def _verify_slots(pos: torch.Tensor, t: int, s: int,
                  pages: Optional[torch.Tensor]) -> torch.Tensor:
    """The physical rows (B, T) of logical slots pos..pos+T-1 (mod S)."""
    slots = (pos.to(torch.int32)[:, None]
             + torch.arange(t, dtype=torch.int32, device=pos.device)[None]
             ) % s
    if pages is not None:
        slots = physical_slots(pages, slots, s // pages.shape[1])
    return slots


def verify_kv_update(cache: torch.Tensor, new: torch.Tensor,
                     pos: torch.Tensor, write_mask: Optional[torch.Tensor],
                     pages: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write T consecutive K/V rows per batch row into a stacked cache, IN
    PLACE: the T-token `cache_update_stacked` + `masked_kv_update`.
    cache (L,B,KH,S,hd); new (L,B,T,KH,hd); pos (B,) the logical slot of
    row 0; write_mask (B,) bool or None (masked rows keep their old
    values); `pages` translates the logical slots to physical rows.
    Returns `cache`."""
    l, b, kh, s, hd = cache.shape
    slots = _verify_slots(pos, new.shape[2], s, pages).long()
    bidx = torch.arange(b, device=cache.device)[:, None]
    val = new.to(cache.dtype).permute(1, 2, 0, 3, 4)      # (B,T,L,KH,hd)
    if write_mask is not None:
        old = cache[:, bidx, :, slots, :]                 # (B,T,L,KH,hd)
        val = torch.where(write_mask[:, None, None, None, None], val, old)
    cache[:, bidx, :, slots, :] = val
    return cache


def quant_verify_kv_update(pool: torch.Tensor, scales: torch.Tensor,
                           new: torch.Tensor, pos: torch.Tensor,
                           write_mask: Optional[torch.Tensor],
                           pages: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """T-token write into an int8 pool, IN PLACE: T sequential one-token
    `quant_kv_update_stacked` writes, so each row meets exactly the page
    scale its sequential decode would.  pool (L,B,KH,S,hd) int8; scales
    (L,B,KH,n_pages); new (L,B,T,KH,hd); pos (B,) the logical slot of
    row 0.  Returns (pool, scales)."""
    slots = _verify_slots(pos, new.shape[2], pool.shape[3], pages)
    for j in range(new.shape[2]):
        quant_kv_update_stacked(pool, scales, new[:, :, j, :, None],
                                slots[:, j], write_mask)
    return pool, scales


def _prefill_mamba(cfg: ArchConfig, p: Params, x: torch.Tensor, length: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole prompt through a mamba sublayer, capturing its recurrent
    state: the SSD scan (`ops.ssd_scan`) returns its final (NH, P, N)
    state and the conv its trailing width-1 input window, so that decode
    resumes from token `length` where `ssd_decode_step` would have landed
    stepping the prompt one token at a time.

    x is the PADDED prompt (B, S, D).  dt is zeroed past `length`, which
    makes the SSD update a no-op there (decay exp(0) = 1, update 0), and
    the conv state is the window ending at `length` (zero-padded on the
    left for prompts shorter than the conv width, as the per-token path's
    zero initial state is).  Returns (x (B,S,D), conv_state
    (B,W-1,d_inner), ssm_state (B,NH,P,N) f32)."""
    b, s, _ = x.shape
    nh, hp, width = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    z, xin, Bm, Cm, dt_raw, A = _mamba_proj(cfg, p, x)
    dt = F.softplus(dt_raw)
    pad = torch.cat([xin.new_zeros((b, width - 1, xin.shape[-1])), xin],
                    dim=1)
    conv_state = pad[:, length:length + width - 1]
    xc, _ = L.causal_conv1d(xin, p["conv_w"])
    in_prompt = torch.arange(s, device=x.device) < length
    dt = torch.where(in_prompt[None, :, None], dt, torch.zeros_like(dt))
    y, ssm_state = ops.ssd_scan(xc.reshape(b, s, nh, hp), dt, A, Bm, Cm)
    return _mamba_out(p, x, y, xc, z), conv_state, ssm_state


def prefill_into_cache(cfg: ArchConfig, params: Params,
                       cache: Dict[str, Any], tokens: torch.Tensor,
                       row: int, length: int
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced prefill of ONE request's prompt into batch row `row`
    of the decode cache.  tokens: (P,) padded prompt.  Junk past `length`
    is harmless for both layer kinds: in attention layers it lands at
    slots >= length, which the per-row validity clock keeps invisible
    until decode overwrites them; mamba layers mask it out of the
    recurrence itself (`_prefill_mamba`).  Attention runs through the
    flash_attention kernel, the SSD recurrence through the ssd_scan
    kernel.  Returns (last-token logits (V,), cache), the cache's row
    written IN PLACE (K/V through its page table)."""
    p_len = tokens.shape[0]
    x = params["embed"][tokens[None]]                     # (1,P,D)
    positions = torch.arange(p_len, dtype=torch.int32,
                             device=x.device)[None]
    states: Dict[str, List[torch.Tensor]] = {}
    for i in range(cfg.n_blocks):
        for pi, (kind, block) in enumerate(zip(cfg.block_pattern,
                                               params["blocks"])):
            p = _layer(block, i)
            if kind == "mamba":
                x, conv_s, ssm_s = _prefill_mamba(cfg, p["mamba"], x,
                                                  length)
                cache[f"conv{pi}"][i, row] = conv_s[0]
                cache[f"ssm{pi}"][i, row] = ssm_s[0]
            else:
                q, k, v = _qkv(cfg, p["attn"], x, positions)
                o = ops.flash_attention(q, k, v, causal=True,
                                        window=_window(cfg, kind))
                o = o.reshape(1, p_len, cfg.n_heads * cfg.head_dim_)
                x = x + matmul(o, p["attn"]["wo"])
                states.setdefault(f"k{pi}", []).append(
                    k[0].transpose(0, 1))
                states.setdefault(f"v{pi}", []).append(
                    v[0].transpose(0, 1))
            if cfg.d_ff > 0:
                x = ffn_layer(cfg, p["ffn"], x, _is_moe_pos(cfg, pi))
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x[0, length - 1] @ params["embed"].T         # (V,)
    write_prompt_kv(cache, states, row)
    return logits, cache


def write_prompt_kv(cache: Dict[str, Any],
                    states: Dict[str, List[torch.Tensor]], row: int,
                    start: int = 0) -> None:
    """A prefill's K/V, IN PLACE: for each K/V leaf of `states` its
    layers' (KH,P,hd) rows, written at logical rows [start, start + P) of
    batch row `row` through the page table (int8 pools by a per-page
    quantize-scatter, `quant_kv_write_rows`).  `start` > 0 is a resume
    prefill's suffix, behind restored prefix rows."""
    if not states:
        return
    pt = cache["page_table"]
    max_seq = cache[next(iter(states))].shape[3]
    p_len = next(iter(states.values()))[0].shape[1]
    assert start + p_len <= max_seq, (start, p_len, max_seq)
    ps = max_seq // pt.shape[1]
    lrows = torch.arange(start, start + p_len, device=pt.device)
    phys = pt[row].long()[lrows // ps] * ps + lrows % ps
    for key, per_layer in states.items():
        upd = torch.stack(per_layer)                      # (L,KH,P,hd)
        if scale_key(key) in cache:
            # int8 pool: per-page quantize-scatter of the P rows
            quant_kv_write_rows(cache[key], cache[scale_key(key)],
                                upd.transpose(1, 2), row, pt[row], ps,
                                start)
            continue
        cache[key][:, row].index_copy_(2, phys, upd.to(cache[key].dtype))


# --------------------------------------------------------------------------
# Int8 KV cache writes
# --------------------------------------------------------------------------
#
# As in the reference: the fp value of cached row r is quants[r] *
# scale[page(r)].  A page's scale only grows while the page is live (a
# token with a larger absmax re-quantizes the page's rows to the merged
# scale), and a page whose first row is written gets a fresh scale, which
# clears the previous occupant's rows (rescale ratio 0).  When the token
# fits under the current scale the ratio is exactly 1.0 and the page's
# rows round-trip bit for bit.
#
# The reference runs these writes inside jit, where XLA turns the division
# of the absmax by the constant 127 into a product with the constant's f32
# reciprocal; the port takes the same product, so its pools and scales
# are the reference's bit for bit.

_SCALE_EPS = 1e-30
_INV_127 = 1.0 / 127.0


def quant_kv_update_stacked(pool: torch.Tensor, scales: torch.Tensor,
                            new: torch.Tensor, slot_b: torch.Tensor,
                            write_mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token ring write into an int8 KV pool, IN PLACE, for all layers
    at once.  pool: (L,B,KH,S,hd) int8; scales: (L,B,KH,n_pages) f32 per
    PHYSICAL page; new: (L,B,KH,1,hd) fp; slot_b: scalar or (B,) PHYSICAL
    rows; write_mask: (B,) bool or None — masked rows leave pool and
    scales bitwise untouched.  Rewrites each row's whole page (rescaled
    rows and the token's).  Returns (pool, scales)."""
    l, b, kh, s, hd = pool.shape
    ps = s // scales.shape[3]
    dev = pool.device
    slot_b = torch.as_tensor(slot_b, device=dev).long().reshape(-1)
    slot_b = slot_b.expand(b)
    page, off = slot_b // ps, slot_b % ps
    bidx = torch.arange(b, device=dev)
    newf = new.float()[:, :, :, 0]                        # (L,B,KH,hd)
    cand = newf.abs().amax(dim=-1) * _INV_127            # (L,B,KH)
    # non-adjacent advanced indices (axes 1, 3) put the (B,) dim first
    old_s = scales[:, bidx, :, page].permute(1, 0, 2)     # (L,B,KH)
    new_s = torch.maximum(old_s, cand)
    if write_mask is not None:
        new_s = torch.where(write_mask[None, :, None], new_s, old_s)
    # ratio 1.0 exactly when the scale is unchanged, 0 on a fresh page
    floor = torch.clamp(new_s, min=_SCALE_EPS)
    r = old_s / floor
    rows = page[:, None] * ps + torch.arange(ps, device=dev)[None]
    blk = pool[:, bidx[:, None], :, rows]                 # (B,ps,L,KH,hd)
    blk_r = torch.round(blk.float()
                        * r.permute(1, 0, 2)[:, None, :, :, None])
    q_tok = torch.clamp(torch.round(newf / floor[..., None]), -127, 127)
    tok = q_tok.permute(1, 0, 2, 3)                       # (B,L,KH,hd)
    if write_mask is not None:
        old_tok = blk[bidx, off]                          # (B,L,KH,hd)
        tok = torch.where(write_mask[:, None, None, None], tok,
                          old_tok.float())
    sel = torch.arange(ps, device=dev)[None, :] == off[:, None]   # (B,ps)
    blk_new = torch.where(sel[:, :, None, None, None], tok[:, None], blk_r)
    pool[:, bidx[:, None], :, rows] = torch.clamp(
        blk_new, -127, 127).to(pool.dtype)
    scales[:, bidx, :, page] = new_s.permute(1, 0, 2)
    return pool, scales


def quant_kv_write_rows(pool: torch.Tensor, scales: torch.Tensor,
                        vals: torch.Tensor, row: int, prow: torch.Tensor,
                        ps: int, start: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter the T LOGICAL rows [start, start + T) of batch row `row`
    into an int8 pool and its page scales, IN PLACE: the prefill's write
    (start 0) and a resume prefill's.  pool: (L,B,KH,S,hd) int8; scales:
    (L,B,KH,n_pages); vals: (L,T,KH,hd) fp; prow: (n_pages,) the row's
    logical -> physical page map; ps: the page size; start + T <= S.

    A page whose first row is at or past `start` is wholly (re)written:
    fresh scale, its rows' absmax / 127, the previous occupant's rows
    cleared.  The boundary page (start % ps != 0, a resume only) merges
    with the restored prefix's scale: its scale becomes the larger of
    the two, the rows it keeps (the prefix rows, and any past the
    written span) are re-quantized by old / new (exactly 1.0 when the
    scale is unchanged), and the new rows are quantized under it.  Pages
    past the rows are untouched.  Returns (pool, scales)."""
    l, b, kh, s, hd = pool.shape
    t = vals.shape[1]
    p0, off = divmod(int(start), ps)
    n_live = -(-(off + t) // ps)          # pages touched, boundary first
    tail = n_live * ps - off - t
    vf = vals.float()                                     # (L,T,KH,hd)
    amax = F.pad(vf.abs().amax(dim=-1), (0, 0, off, tail))
    new_s = amax.reshape(l, n_live, ps, kh).amax(dim=2) * _INV_127
    phys_pages = prow[p0:p0 + n_live].long()
    blk_old = None
    if off:
        # (indices stay on the device: no host sync)
        old = scales[:, row].index_select(2, phys_pages[:1])[..., 0]
        new_s[:, 0] = torch.maximum(old, new_s[:, 0])     # (L,KH)
        r = old / torch.clamp(new_s[:, 0], min=_SCALE_EPS)
        first = phys_pages[0] * ps + torch.arange(ps, device=pool.device)
        page = pool[:, row].index_select(2, first)        # (L,KH,ps,hd)
        blk_old = torch.round(page.float() * r[:, :, None, None])
    scale_t = new_s.repeat_interleave(ps, dim=1)[:, off:off + t]
    q_rows = torch.clamp(
        torch.round(vf / torch.clamp(scale_t, min=_SCALE_EPS)[..., None]),
        -127, 127)
    blk = F.pad(q_rows, (0, 0, 0, 0, off, tail))          # (L,n*ps,KH,hd)
    if blk_old is not None:
        kept = torch.arange(ps, device=pool.device)
        kept = (kept < off) | (kept >= off + t)
        blk[:, :ps] = torch.where(kept[None, :, None, None],
                                  torch.clamp(blk_old.transpose(1, 2),
                                              -127, 127), blk[:, :ps])
    rows_ph = (phys_pages[:, None] * ps
               + torch.arange(ps, device=pool.device)[None]).reshape(-1)
    pool[:, row][:, :, rows_ph] = blk.transpose(1, 2).to(pool.dtype)
    scales[:, row][:, :, phys_pages] = new_s.transpose(1, 2)
    return pool, scales


# --------------------------------------------------------------------------
# Per-slot cache pages: extract / insert (the host tier)
# --------------------------------------------------------------------------

def _is_self_kv(key: str) -> bool:
    """Self-attention K/V leaves are k{pos} / v{pos}; conv{pos},
    ssm{pos}, cross_k / cross_v and enc_pos are everything else."""
    return key[0] in ("k", "v") and key[1:].isdigit()


def _is_kv_scale(key: str) -> bool:
    """Per-page scale leaves of an int8 K/V cache: kscale{pos} /
    vscale{pos}."""
    return key[:6] in ("kscale", "vscale") and key[6:].isdigit()


def extract_slot_cache(cfg: ArchConfig, cache: Dict[str, Any], row: int,
                       upto: Optional[int] = None) -> Dict[str, Any]:
    """Batch row `row` of every cache leaf, as NEW tensors (gathered on
    the current stream, so they are a staging copy that later writes to
    the cache do not touch): ONE request's pages, the unit the host tier
    evicts and the prefix cache stores.  5-dim panels (cross_k / cross_v)
    and 4-dim conv windows keep a size-1 batch axis at position 1, the
    1-dim `enc_pos` clock is sliced on axis 0; the scalar `pos` counter
    and the `page_table` (placement belongs to the batch, not the
    request) are left out.

    Paged self-attention K/V leaves come out as 6-dim PAGE SETS (L, 1,
    KH, n_pages, page, hd) in LOGICAL page order, and their int8 scales
    (L, 1, KH, n_pages) in the same order, so a set restores under any
    destination row's table.  `upto` truncates them to the pages that
    hold the first `upto` rows (ceil(upto / page)): the prefix-page cut,
    exact for any continuation by causality; the sub-page tail past
    `upto` stays invisible behind the resume's validity `slot < start`."""
    pt = cache.get("page_table")
    out: Dict[str, Any] = {}
    for key, leaf in cache.items():
        if key in ("pos", "page_table"):
            continue
        if leaf.dim() == 1:                               # enc_pos (B,)
            out[key] = leaf[row:row + 1].clone()
            continue
        if _is_self_kv(key) or _is_kv_scale(key):
            n_p = pt.shape[1]
            n_sel = n_p if upto is None else -(-upto // cache_page_size(cache))
            prow = pt[row, :n_sel].long()
            if _is_kv_scale(key):                         # (L,KH,n_p)
                out[key] = leaf[:, row].index_select(2, prow)[:, None]
                continue
            l, _, kh, s, hd = leaf.shape
            pages = leaf[:, row].view(l, kh, n_p, s // n_p, hd)
            out[key] = pages.index_select(2, prow)[:, None]
            continue
        out[key] = leaf[:, row:row + 1].clone()
    return out


def insert_slot_cache(cfg: ArchConfig, cache: Dict[str, Any],
                      leaves: Dict[str, Any], row: int) -> Dict[str, Any]:
    """Write extracted pages into batch row `row`, IN PLACE (the server's
    captured graphs hold the cache's tensors): the restore half of the
    round trip, its inverse leaf for leaf, bit for bit.  A page set (and
    its scales) is scattered through the DESTINATION row's page table,
    logical page i to physical page table[row, i], so it restores under
    any placement; a prefix-truncated set writes its pages and leaves
    the rest as the previous occupant's, invisible behind the row's
    clock.  Returns `cache`."""
    pt = cache.get("page_table")
    for key, val in leaves.items():
        c = cache[key]
        val = val.to(c.dtype)
        if c.dim() == 1:
            c[row:row + 1].copy_(val)
        elif _is_kv_scale(key):
            prow = pt[row, :val.shape[3]].long()
            c[:, row].index_copy_(2, prow, val[:, 0])
        elif _is_self_kv(key):
            l, _, kh, s, hd = c.shape
            n_p = pt.shape[1]
            prow = pt[row, :val.shape[3]].long()
            c[:, row].view(l, kh, n_p, s // n_p, hd).index_copy_(
                2, prow, val[:, 0])
        else:
            c[:, row:row + 1].copy_(val)
    return cache


# --------------------------------------------------------------------------
# Resume prefill: continue a prompt from restored prefix pages
# --------------------------------------------------------------------------

def _resume_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_row: torch.Tensor, v_row: torch.Tensor,
                      start: int, window: int) -> torch.Tensor:
    """Suffix-query attention as a two-partial softmax merge, in plain f32
    torch as the reference's plain XLA (its products run with TF32 off,
    PyTorch's default): partial A reads the slot's RESTORED prefix rows
    [0, start) (and the window's bound under the global query positions
    start + t), partial B is causal attention within the suffix; merging
    their (acc, m, l) gives full-prompt attention in exact arithmetic, in
    another summation order than the one-pass prefill kernel (so a
    resumed prefill is token-equal, not bitwise).

    q: (1,T,H,hd); k, v: (1,T,KH,hd) the suffix's; k_row, v_row: (1,KH,
    S',hd) the restored rows in logical order (f32 or the model dtype),
    S' >= start.  Returns (1,T,H,hd) in q's dtype."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    s = k_row.shape[2]
    dev = q.device
    qf = (q.float() * hd ** -0.5).reshape(b, t, kh, h // kh, hd)
    gpos = start + torch.arange(t, device=dev)
    slots = torch.arange(s, device=dev)
    valid = (slots[None, :] < start).expand(t, s)
    if window > 0:
        valid = valid & (slots[None, :] > gpos[:, None] - window)
    valid = valid[None, :, None, None, :]
    s1 = torch.einsum("btkgd,bksd->btkgs", qf, k_row.float())
    s1 = torch.where(valid, s1, L.NEG_INF)
    m1 = s1.amax(dim=-1)
    p1 = torch.where(valid, torch.exp(s1 - m1[..., None]), 0.0)
    l1 = p1.sum(dim=-1)
    acc1 = torch.einsum("btkgs,bksd->btkgd", p1, v_row.float())
    tri = torch.arange(t, device=dev)
    cmask = tri[None, :] <= tri[:, None]
    if window > 0:
        cmask = cmask & (tri[None, :] > tri[:, None] - window)
    cmask = cmask[None, :, None, None, :]
    s2 = torch.einsum("btkgd,bukd->btkgu", qf, k.float())
    s2 = torch.where(cmask, s2, L.NEG_INF)
    m2 = s2.amax(dim=-1)
    p2 = torch.where(cmask, torch.exp(s2 - m2[..., None]), 0.0)
    l2 = p2.sum(dim=-1)
    acc2 = torch.einsum("btkgu,bukd->btkgd", p2, v.float())
    m = torch.maximum(m1, m2)
    e1, e2 = torch.exp(m1 - m), torch.exp(m2 - m)
    acc = acc1 * e1[..., None] + acc2 * e2[..., None]
    l_ = l1 * e1 + l2 * e2
    out = acc / torch.clamp(l_, min=1e-20)[..., None]
    return out.reshape(b, t, h, hd).to(q.dtype)


def _resume_mamba(cfg: ArchConfig, p: Params, x: torch.Tensor,
                  conv0: torch.Tensor, ssm0: torch.Tensor,
                  suffix_len: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_prefill_mamba` continued from a restored recurrent state: the
    causal conv starts from the restored width-1 input window and the SSD
    scan (`ops.ssd_scan`, the kernel on the card) from the restored (NH,
    P, N) state as its `init_state`.  dt is zeroed past the true suffix
    length and the new conv window is cut there, as `_prefill_mamba`
    masks its padded tail.  x: (1,S,D); conv0: (1,W-1,d_inner); ssm0:
    (1,NH,P,N).  Returns (x, conv_state, ssm_state)."""
    b, s, _ = x.shape
    nh, hp, width = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    z, xin, Bm, Cm, dt_raw, A = _mamba_proj(cfg, p, x)
    dt = F.softplus(dt_raw)
    conv0 = conv0.to(xin.dtype)
    pad = torch.cat([conv0, xin], dim=1)
    conv_state = pad[:, suffix_len:suffix_len + width - 1]
    xc, _ = L.causal_conv1d(xin, p["conv_w"], conv0)
    in_suffix = torch.arange(s, device=x.device) < suffix_len
    dt = torch.where(in_suffix[None, :, None], dt, torch.zeros_like(dt))
    y, ssm_state = ops.ssd_scan(xc.reshape(b, s, nh, hp), dt, A, Bm, Cm,
                                ssm0.float())
    return _mamba_out(p, x, y, xc, z), conv_state, ssm_state


def _logical_rows(cache: Dict[str, Any], pi: int, layer: int, row: int,
                  n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pattern position pi's K and V rows [0, n_rows) of batch row `row`
    at `layer`, in logical order through the page table, each (1, KH,
    n_rows, hd); dequantized to f32 under their page scales on an int8
    cache (n_rows a multiple of the page size)."""
    pt = cache["page_table"]
    out = []
    for name in (f"k{pi}", f"v{pi}"):
        c = cache[name][layer, row]                       # (KH,S,hd)
        kh, s, hd = c.shape
        n_p = pt.shape[1]
        ps = s // n_p
        prow = pt[row, :n_rows // ps].long()
        rows = c.view(kh, n_p, ps, hd).index_select(1, prow)
        if scale_key(name) in cache:
            sc = cache[scale_key(name)][layer, row].index_select(1, prow)
            rows = rows.float() * sc[..., None, None]
        out.append(rows.reshape(1, kh, n_rows, hd))
    return out[0], out[1]


def resume_prefill_into_cache(cfg: ArchConfig, params: Params,
                              cache: Dict[str, Any], tokens: torch.Tensor,
                              row: int, length: int, start: int
                              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill ONLY the suffix of a prompt whose first `start` tokens'
    pages were just restored into row `row` (a prefix-cache partial
    hit): K/V rows [0, start) and the post-prefix recurrent state.
    tokens: (Ps,) the padded suffix; length: the TRUE prompt length
    (start + the suffix's); start + Ps <= max_seq.

    Attention layers merge a partial over the restored rows with a causal
    one over the suffix (`_resume_attention`, plain f32: token-equal to a
    full prefill, not bitwise); mamba layers continue the recurrence from
    the restored state (`_resume_mamba`, through the ssd_scan kernel with
    `init_state`).  Suffix junk past `length` is harmless as in
    `prefill_into_cache`.  Writes IN PLACE: the suffix's K/V at logical
    rows [start, start + Ps) through the page table (int8 pools by
    `quant_kv_write_rows` with its boundary page), each mamba layer's
    new states.  Returns (last-token logits (V,), cache)."""
    _check_supported(cfg)
    t_len = tokens.shape[0]
    suffix_len = length - start
    assert 0 < start and 0 < suffix_len <= t_len, (start, length, t_len)
    x = params["embed"][tokens[None]]                     # (1,Ps,D)
    positions = start + torch.arange(t_len, dtype=torch.int32,
                                     device=x.device)[None]
    n_rows = 0
    if cfg.has_attention:
        ps = cache_page_size(cache)
        n_rows = -(-start // ps) * ps          # the pages holding [0, start)
    states: Dict[str, List[torch.Tensor]] = {}
    for i in range(cfg.n_blocks):
        for pi, (kind, block) in enumerate(zip(cfg.block_pattern,
                                               params["blocks"])):
            p = _layer(block, i)
            if kind == "mamba":
                conv, ssm = cache[f"conv{pi}"][i], cache[f"ssm{pi}"][i]
                x, conv_s, ssm_s = _resume_mamba(
                    cfg, p["mamba"], x, conv[row][None], ssm[row][None],
                    suffix_len)
                conv[row] = conv_s[0]
                ssm[row] = ssm_s[0]
            else:
                q, k, v = _qkv(cfg, p["attn"], x, positions)
                k_row, v_row = _logical_rows(cache, pi, i, row, n_rows)
                o = _resume_attention(q, k, v, k_row, v_row, start,
                                      _window(cfg, kind))
                x = x + matmul(o.reshape(1, t_len, -1), p["attn"]["wo"])
                states.setdefault(f"k{pi}", []).append(k[0].transpose(0, 1))
                states.setdefault(f"v{pi}", []).append(v[0].transpose(0, 1))
            if cfg.d_ff > 0:
                x = ffn_layer(cfg, p["ffn"], x, _is_moe_pos(cfg, pi))
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x[0, suffix_len - 1] @ params["embed"].T     # (V,)
    write_prompt_kv(cache, states, row, start)
    return logits, cache
