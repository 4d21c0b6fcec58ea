"""Cache and parameter partition specs for serving, the serving part of
`repro/launch/partition.py`.

  TP    ("model")       — attention heads (the decode's head groups), or
                          the KV sequence under sequence-parallel decode.
  batch ("pod","data")  — the serving slots, caches and slot state.

Under the bitwise-token serving contract every parameter is replicated,
and so is every cache axis but the batch: the model axis is engaged only
inside the decode's head-group split (`core/backstream.py`), whose slices
of replicated operands are bit-copies.  `cache_specs` is the
sequence-sharded layout of the AXLE ring, with its guard against a split
that would cut a page.

The training specs map every leaf of the model state onto the mesh:

  TP    ("model")        — attention projections, FFN hidden, vocab,
                           experts (EP) when they divide, SSM heads.
  FSDP  ("pod","data")   — the d_model dim of the big archs' weights
                           (`make_plan(train=True)`: above 5e9 params).
  batch ("pod","data")   — the batch rows.

`param_specs` classifies each leaf by its name and rank, so one rule set
covers the decoder-only, enc-dec, MoE and hybrid trees; `opt_state_specs`
gives AdamW's moments and master the parameters' specs.  A spec maps a
full tensor to a rank's slice with `local_shard`, where the reference
commits a `NamedSharding`: a training rank stores exactly its
`local_shard` of every parameter, moment, master, residual and batch
leaf (`launch/train.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.kernels.quant import QTensor
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw
from repro_torch.sharding import ShardingRules, Spec, axis_sizes


def _axes(axes) -> Tuple[str, ...]:
    if not axes:
        return ()
    return tuple(axes) if isinstance(axes, tuple) else (axes,)


def _divisible(n: int, mesh, axes) -> bool:
    if not axes:
        return True
    sizes = axis_sizes(mesh)
    size = 1
    for a in _axes(axes):
        size *= sizes[a]
    return size > 0 and n % size == 0


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    rules: ShardingRules
    fsdp: bool              # shard weight d_model dim over ("pod","data")

    @property
    def mesh(self):
        return self.rules.mesh

    @property
    def tp(self) -> Optional[str]:
        return self.rules.model_axis

    @property
    def fsdp_axes(self) -> Optional[Tuple[str, ...]]:
        return self.rules.batch_axes if self.fsdp else None


def _leaf_spec(plan: PartitionPlan, cfg: ArchConfig, name: str,
               leaf: Any) -> Spec:
    """The spec of one stacked parameter leaf (a leading n_blocks dim for
    block params; the embedding and the final norms are unstacked)."""
    del cfg
    mesh, tp, fs = plan.mesh, plan.tp, plan.fsdp_axes
    shape = tuple(leaf.shape)
    nd = len(shape)

    def ax(dim_size, axes):
        return axes if (axes and _divisible(dim_size, mesh, axes)) else None

    if name == "embed":                                  # (V, D)
        return Spec(ax(shape[0], tp), None)
    if name in ("ln", "final_ln", "enc_final_ln", "dt_bias", "A_log", "D"):
        return Spec(*([None] * nd))
    if name == "router":                                 # (nb, d, e)
        return Spec(*([None] * nd))
    if name in ("wq", "wk", "wv", "w_z", "w_x"):         # (nb, d, out)
        return Spec(None, ax(shape[1], fs), ax(shape[2], tp))
    if name in ("wo", "out_proj"):                       # (nb, in, d)
        return Spec(None, ax(shape[1], tp), ax(shape[2], fs))
    if name in ("w_gate", "w_up"):
        if nd == 4:                                      # MoE (nb, e, d, f)
            if tp and _divisible(shape[1], mesh, tp):    # EP over experts
                return Spec(None, tp, ax(shape[2], fs), None)
            return Spec(None, None, ax(shape[2], fs), ax(shape[3], tp))
        return Spec(None, ax(shape[1], fs), ax(shape[2], tp))  # (nb, d, f)
    if name == "w_down":
        if nd == 4:                                      # MoE (nb, e, f, d)
            if tp and _divisible(shape[1], mesh, tp):
                return Spec(None, tp, None, ax(shape[3], fs))
            return Spec(None, None, ax(shape[2], tp), ax(shape[3], fs))
        return Spec(None, ax(shape[1], tp), ax(shape[2], fs))  # (nb, f, d)
    if name in ("w_B", "w_C", "w_dt"):                   # (nb, d, n)
        return Spec(None, ax(shape[1], fs), None)
    if name == "conv_w":                                 # (nb, w, di)
        return Spec(None, None, ax(shape[2], tp))
    return Spec(*([None] * nd))


def _quant_leaf_spec(plan: PartitionPlan, name: str, leaf: Any) -> Spec:
    """The spec of one tensor of a block-quantized `QTensor` leaf.  The
    packed input-block axis cannot split without tearing quant blocks, so
    only the out-column axis (the last, of the scales, mins and quants
    alike) is sharded: over tp where the fp rule split the projection's
    output, over the fsdp axes where it put the weight's d_model output
    (wo / out_proj / w_down)."""
    mesh, tp, fs = plan.mesh, plan.tp, plan.fsdp_axes
    last = leaf.shape[-1]
    axes = fs if name in ("wo", "out_proj", "w_down") else tp
    if not (axes and _divisible(last, mesh, axes)):
        axes = None
    return Spec(*([None] * (leaf.dim() - 1) + [axes]))


def param_specs(abstract_params: Any, cfg: ArchConfig,
                plan: PartitionPlan) -> Any:
    """The Spec tree of a parameter tree (real or meta tensors): each
    leaf by the name of its innermost dict key; a `QTensor` leaf becomes
    a QTensor of its tensors' specs."""

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        if isinstance(tree, QTensor):
            return QTensor(
                _quant_leaf_spec(plan, name, tree.scales),
                _quant_leaf_spec(plan, name, tree.quants),
                None if tree.mins is None
                else _quant_leaf_spec(plan, name, tree.mins),
                tree.fmt, tree.d_in)
        return _leaf_spec(plan, cfg, name, tree)

    return walk(abstract_params, "")


def opt_state_specs(abstract_opt: Any, p_specs: Any) -> Any:
    """AdamW's state mirrors the parameters: the step replicated, mu / nu
    / master the parameters' specs."""
    del abstract_opt
    return adamw.OptState(step=Spec(), mu=p_specs, nu=p_specs,
                          master=p_specs)


def batch_specs(abstract_batch: Mapping[str, Any],
                plan: PartitionPlan) -> Dict[str, Spec]:
    """Rows over the batch axes; a batch of one row, or one that does not
    divide, replicated (the batch-1 long-context cells)."""
    b_axes = plan.rules.batch_axes
    out = {}
    for k, v in abstract_batch.items():
        spec = [b_axes] + [None] * (len(v.shape) - 1)
        if v.shape[0] == 1 or not _divisible(v.shape[0], plan.mesh, b_axes):
            spec[0] = None
        out[k] = Spec(*spec)
    return out


def cache_specs(abstract_cache: Mapping[str, Any], cfg: ArchConfig,
                plan: PartitionPlan) -> Dict[str, Spec]:
    """KV caches (layers, B, KH, S, hd) sharded batch over the data axes
    and SEQUENCE over the model axis: the flash-decoding layout whose
    partial-attention merge is the offload protocol's producer task.
    SSM states shard their head dim over the model axis.  A sequence
    split of a paged pool that would cut a page raises ValueError."""
    mesh, tp = plan.mesh, plan.tp
    sizes = axis_sizes(mesh)
    b_axes = plan.rules.batch_axes
    out: Dict[str, Spec] = {}
    for k, v in abstract_cache.items():
        if k == "pos":
            out[k] = Spec()
            continue
        shape = tuple(v.shape)
        if len(shape) == 1:
            out[k] = Spec(b_axes if _divisible(shape[0], mesh, b_axes)
                          else None)
            continue
        if k == "page_table":
            out[k] = Spec(b_axes if _divisible(shape[0], mesh, b_axes)
                          else None, None)
            continue
        batch_ax = b_axes if _divisible(shape[1], mesh, b_axes) else None
        if k.startswith(("kscale", "vscale")):
            # a page's scale lives with its page: the page axis stays whole
            out[k] = Spec(None, batch_ax, None, None)
            continue
        if k.startswith(("k", "v")) and not k.startswith("conv"):
            seq_ax = tp if (tp and _divisible(shape[3], mesh, tp)) else None
            pt = abstract_cache.get("page_table")
            if seq_ax and pt is not None:
                # pages are the paged cache's indivisible unit: a sequence
                # split composes only when every page lies inside a shard
                n_model = sizes[tp]
                page_size = shape[3] // pt.shape[1]
                if page_size == 0 or (shape[3] // n_model) % page_size:
                    raise ValueError(
                        f"cache leaf {k!r}: sequence-axis ({tp}) sharding "
                        f"of the KV panel (S={shape[3]}) over {n_model} "
                        f"shards would split a page (page_size="
                        f"{page_size}) across shards; use a page_size "
                        f"dividing S/{n_model}, fewer model shards, or the "
                        f"head-sharded serving plan (serve_cache_specs)")
            out[k] = Spec(None, batch_ax, None, seq_ax, None)
        elif k.startswith("cross_"):
            out[k] = Spec(None, batch_ax, None, None, None)
        elif k.startswith("conv"):
            di_ax = tp if (tp and _divisible(shape[3], mesh, tp)) else None
            out[k] = Spec(None, batch_ax, None, di_ax)
        elif k.startswith("ssm"):
            nh_ax = tp if (tp and _divisible(shape[2], mesh, tp)) else None
            out[k] = Spec(None, batch_ax, nh_ax, None, None)
        else:
            out[k] = Spec(*([None] * len(shape)))
    return out


def serve_head_regime(cfg: ArchConfig, plan: PartitionPlan
                      ) -> Tuple[bool, bool]:
    """(shard_q, shard_kv) of the serving head split.  A contiguous split
    of the heads aligns with GQA groups only when the KV heads split with
    it (n | KH) or every head shares the one KV head (KH == 1, n | H);
    anything else stays replicated, bitwise the single device's.  A stack
    without attention has nothing to split."""
    tp = plan.tp
    n = axis_sizes(plan.mesh)[tp] if tp else 1
    h, kh = cfg.n_heads, cfg.n_kv_heads
    if n <= 1 or h <= 0 or not cfg.has_attention:
        return False, False
    shard_kv = kh > 0 and kh % n == 0
    shard_q = shard_kv or (kh == 1 and h % n == 0)
    return shard_q, shard_kv


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def serve_param_specs(params: Any, cfg: ArchConfig,
                      plan: PartitionPlan) -> Any:
    """Every parameter replicated (Spec()): a column-split product changes
    the blocking of the product and its low bits, so the model axis is
    engaged only inside the decode's head-group split."""
    del cfg, plan
    return _tree_map(lambda leaf: Spec(), params)


def serve_cache_specs(abstract_cache: Mapping[str, Any], cfg: ArchConfig,
                      plan: PartitionPlan) -> Dict[str, Spec]:
    """The serving cache: the batch axis over the data axes when it
    divides, every other axis (KV heads, the sequence) model-replicated.
    The decode slices its head group out of the replicated panels, a
    bit-copy; a sequence split would re-associate the softmax sum."""
    del cfg
    mesh = plan.mesh
    b_axes = plan.rules.batch_axes
    out: Dict[str, Spec] = {}
    for k, v in abstract_cache.items():
        shape = tuple(v.shape)
        if k == "pos":
            out[k] = Spec()
        elif len(shape) == 1:
            out[k] = Spec(b_axes if _divisible(shape[0], mesh, b_axes)
                          else None)
        elif k == "page_table":
            out[k] = Spec(b_axes if _divisible(shape[0], mesh, b_axes)
                          else None, None)
        else:
            batch_ax = b_axes if _divisible(shape[1], mesh, b_axes) \
                else None
            out[k] = Spec(None, batch_ax, *([None] * (len(shape) - 2)))
    return out


def local_shard(tensor: torch.Tensor, spec: Spec, mesh,
                coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """This rank's slice of a full tensor under `spec` (a view): each dim
    with axes is cut into as many equal parts as the axes' sizes multiply
    to, and the rank takes the part at its coordinate (the first axis
    major).  `coords`: {axis: index} (default: this rank's coordinate in
    `mesh`)."""
    sizes = axis_sizes(mesh)
    if coords is None:
        coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    if len(spec) > tensor.dim():
        raise ValueError(f"spec {spec} has more dims than {tuple(tensor.shape)}")
    out = tensor
    for dim, axes in enumerate(spec):
        axes = _axes(axes)
        if not axes:
            continue
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        n = tensor.shape[dim]
        if n % parts:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split into {parts} parts over {axes}")
        step = n // parts
        out = out.narrow(dim, idx * step, step)
    return out


def shard_tree(full: Any, specs: Any, mesh) -> Any:
    """This rank's shards of a tree of full tensors under a spec tree of
    the same structure, each a copy (so the rank stores only its slice,
    not a view that keeps the full tensor alive)."""
    return tree.map_leaves(
        lambda t, sp: local_shard(t, sp, mesh).clone(), full, specs)


def make_plan(cfg: ArchConfig, rules: ShardingRules, *,
              train: bool) -> PartitionPlan:
    """FSDP policy: shard weights over the data axes when the parameters
    would not fit a chip comfortably under TP alone (the reference's
    byte-headroom heuristic).  Serving never takes it (the server builds
    its plan with fsdp=False)."""
    n = cfg.n_params()
    threshold = 5e9 if train else 60e9
    return PartitionPlan(rules=rules, fsdp=n > threshold)
