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

The training specs (`param_specs`, `opt_state_specs`, `batch_specs`) come
with training (ROADMAP.md queue 1).  A spec maps a full tensor to a
rank's slice with `local_shard`, where the reference commits a
`NamedSharding`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.models.config import ArchConfig
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


def make_plan(cfg: ArchConfig, rules: ShardingRules, *,
              train: bool) -> PartitionPlan:
    """FSDP policy: shard weights over the data axes when the parameters
    would not fit a chip comfortably under TP alone (the reference's
    byte-headroom heuristic).  Serving never takes it (the server builds
    its plan with fsdp=False)."""
    n = cfg.n_params()
    threshold = 5e9 if train else 60e9
    return PartitionPlan(rules=rules, fsdp=n > threshold)
