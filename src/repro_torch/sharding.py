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
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch


class Spec(tuple):
    """A partition spec: one entry a tensor dim, None (replicated), an
    axis name or a tuple of axis names (the dim split over their
    product, the first axis major)."""

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


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The identity.  In the reference this pins a jit value's layout for
    the compiler; here each rank holds plain local tensors, and what a
    rank holds is decided where the tensor is made, so there is nothing
    to pin.  `kind` is still checked against the reference's kinds."""
    if kind not in ("batch", "batch_seq", "attn_in", "kv", "logits"):
        raise ValueError(kind)
    return x
