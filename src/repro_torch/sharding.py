"""Sharding rules: logical axis names -> mesh axes, the port of
`repro/sharding.py`.

Mesh axes (`launch/mesh.py`): ("data", "model").  Logical axes:

  batch -> ("pod", "data") where present (("data",) on one pod)
  seq   -> "model" under sequence-parallel attention
  tp    -> "model" (FFN hidden, attention heads, vocab, experts)

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` (or, for
planning alone, any object with its `mesh_dim_names` and `shape`).  Each
rank holds plain local tensors: a spec says which slice of the global
tensor a rank holds (`launch/partition.local_shard`), and the mesh
schedules of `core/backstream.py` move data between ranks themselves.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import torch


class Spec(tuple):
    """A partition spec: one entry a tensor dim, None (replicated), an
    axis name or a tuple of axis names (the dim split over their
    product, the first axis major).  A leaf of `repro_torch.tree`."""

    tree_leaf = True

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class ShardingRules:
    """Resolves logical axis names against the active mesh's axis names."""

    def __init__(self, mesh, *, seq_shard_attn: bool = False,
                 fsdp: bool = False, seq_shard_acts: bool = False,
                 head_shard_attn: bool = False):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names)
        self.model_axis: Optional[str] = "model" if "model" in names else None
        # sequence-parallel attention: the KV cache shards its sequence
        # axis over the model axis, and the decode's partial statistics
        # cross ranks under the offload protocol (AXLE ring, BS gather,
        # RP round trips)
        self.seq_shard_attn = seq_shard_attn
        self.seq_shard_acts = seq_shard_acts
        # tensor-parallel SERVING: the decode attention splits by head
        # group over the model axis and its statistics are gathered, a
        # bit-copy; everything else stays replicated, so the served
        # tokens are bitwise the single-device server's
        self.head_shard_attn = head_shard_attn
        assert not (head_shard_attn and seq_shard_attn), \
            "head_shard_attn (serving TP) and seq_shard_attn (training " \
            "SP) are mutually exclusive layouts"
        self.fsdp = fsdp

    def size(self, axis: Optional[str]) -> int:
        return axis_sizes(self.mesh)[axis] if axis else 1

    def model_size(self) -> int:
        return self.size(self.model_axis)

    def data_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.size(a)
        return n

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self.mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.mesh.get_local_rank(axis)

    # -- activation specs ------------------------------------------------------
    def act_btd(self) -> Spec:          # (B, S, D)
        return Spec(self.batch_axes, None, None)

    def act_btd_seq(self) -> Spec:      # (B, S, D) with sequence sharding
        return Spec(self.batch_axes, self.model_axis, None)

    def act_bthd_heads(self) -> Spec:   # (B, S, H, hd) head-sharded
        return Spec(self.batch_axes, None, self.model_axis, None)

    def act_bthd_seq(self) -> Spec:     # (B, S, H, hd) sequence-sharded
        return Spec(self.batch_axes, self.model_axis, None, None)

    def kv_cache_seq(self) -> Spec:     # (layers, B, S, KH, hd): shard seq
        return Spec(None, self.batch_axes, self.model_axis, None, None)

    def logits_btv(self) -> Spec:       # (B, S, V) vocab-sharded
        return Spec(self.batch_axes, None, self.model_axis)


_state = threading.local()


def active_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]) -> Iterator[None]:
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def seq_axis(rules: Optional[ShardingRules], s: int) -> Optional[str]:
    """The axis a (B, S, D) training activation splits its sequence over,
    the reference's `seq_shard_acts` rule for "batch": the model axis when
    S % n_model == 0 and S >= n_model, else None (S replicated over
    model)."""
    if rules is None or not rules.seq_shard_acts or not rules.model_axis:
        return None
    n = rules.model_size()
    return rules.model_axis if s % n == 0 and s >= n else None


@dataclasses.dataclass(frozen=True)
class Act:
    """The layout of one global (B, S, D) training activation on a mesh:
    the axes its rows split over (None: replicated, as the batch's
    `partition.batch_specs` say), the axis its sequence splits over
    (`seq_axis`; None: replicated), the global S and this rank's span of
    it."""
    rules: ShardingRules
    rows: Optional[Tuple[str, ...]]
    seq: Optional[str]
    s: int
    start: int
    length: int


@dataclasses.dataclass(frozen=True)
class TrainLayout:
    """What the training step needs on a mesh: the rules, the parameters'
    spec tree (`partition.param_specs`: each rank holds `local_shard` of
    every leaf) and the batch's specs (`partition.batch_specs`).  The
    loss functions read it (`train_layout()`) to take their rank's span,
    to gather each block's weights and to reduce over the mesh."""
    rules: ShardingRules
    params: Any
    batch: Dict[str, Spec]

    def act(self, s: int) -> Act:
        """The layout of a (B, S, D) activation of this batch's rows."""
        spec = next(iter(self.batch.values()))
        rows = spec[0] if spec else None
        seq = seq_axis(self.rules, s)
        length = s // self.rules.model_size() if seq else s
        start = self.rules.rank(seq) * length if seq else 0
        return Act(self.rules, rows, seq, s, start, length)

    def world(self) -> int:
        return self.rules.data_size() * self.rules.model_size()


def train_layout() -> Optional[TrainLayout]:
    return getattr(_state, "layout", None)


@contextlib.contextmanager
def use_train_layout(layout: Optional[TrainLayout]) -> Iterator[None]:
    """The training layout (and its rules) for the block: both restored
    on exit."""
    prev = getattr(_state, "layout", None)
    _state.layout = layout
    try:
        with use_rules(layout.rules if layout is not None
                       else active_rules()):
            yield
    finally:
        _state.layout = prev


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The identity.  In the reference this pins a jit value's layout for
    the compiler; here each rank holds plain local tensors, made where
    the layout decides (`TrainLayout.act`), so there is nothing to pin.
    `kind` is still checked against the reference's kinds."""
    if kind not in ("batch", "batch_seq", "attn_in", "kv", "logits"):
        raise ValueError(kind)
    return x
