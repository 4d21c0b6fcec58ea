"""Autograd-aware collectives over the axes of the active mesh, for the
training step on a mesh (`launch/steps.py`).  The reference has no such
module: GSPMD inserts its collectives; here each rank holds plain local
tensors, and the model code calls these where a value crosses ranks.

  all_gather      - every rank's part along a dim, concatenated in the
                    axis' order; its backward is a reduce-scatter (each
                    rank gets the sum over the axis of the gradients of
                    its own part).
  all_reduce_sum  - the sum over the axes on every rank; its backward is
                    the same sum of the gradients.
  all_reduce_max  - the max over the axes, no gradient.
  gather          - a local shard back to the full tensor by its spec
                    (`launch/partition.local_shard`'s inverse), through
                    `all_gather` dim by dim.

Every byte goes through `core/backstream.py`'s transport (`_wire_out`,
`_wire_in`), so it lands in the wire ledger (`WIRE`, by collective), and
a CUDA tensor stages through pinned host memory for gloo.  The ledger
counts what a rank sends: (n - 1) parts for a gather or a reduce-scatter,
2 (n - 1) / n of the tensor for a ring all-reduce.  A meta tensor (the
dry-run, over a fake group) is counted the same and moves nothing: its
result is a meta tensor of the result's shape (host stand-ins through the
fake group would cost a real copy of every gathered weight, minutes a
train cell).

A tuple of axes acts as one axis of their product, the first major, as a
spec's tuple does: a gather runs over the last (minor) axis first.  Each
function takes the mesh's `rules` (default: the active ones).  Code that
a backward may run, as a checkpointed block's recomputation, passes them:
on the card the autograd engine runs a CUDA backward on a thread of its
own, where the thread-local active rules are unset.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.backstream import (WIRE, _all_gather, _nbytes,
                                         _wire_buffer, _wire_in, _wire_out)
from repro_torch.sharding import ShardingRules, Spec, active_rules

Axes = Union[None, str, Iterable[str]]


def _rules(rules: Optional[ShardingRules]) -> ShardingRules:
    rules = rules if rules is not None else active_rules()
    if rules is None:
        raise RuntimeError("a mesh collective needs sharding rules")
    return rules


def _axes(axes: Axes, rules: ShardingRules) -> Tuple[str, ...]:
    """The named axes of the rules' mesh of size above 1, minor last;
    None: all of the mesh's axes."""
    if axes is None:
        names = tuple(rules.mesh.mesh_dim_names)
    elif isinstance(axes, str):
        names = (axes,)
    else:
        names = tuple(axes)
    return tuple(a for a in names if rules.size(a) > 1)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host tensor gloo may reduce into in place."""
    host = _wire_out(t)
    return host.clone() if host is t else host


def _reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    n = dist.get_world_size(group)
    if t.is_meta:
        WIRE.sent("all-reduce", 2 * (n - 1) * _nbytes(t) // n)
        return torch.empty_like(t)
    host = _host_copy(t)
    dist.all_reduce(host, op=op, group=group)
    WIRE.sent("all-reduce", 2 * (n - 1) * _nbytes(host) // n)
    return _wire_in(host, t.device)


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part (along `dim`, in group-rank order) of the sum over
    the group of every rank's `t`, summed in rank order."""
    n = dist.get_world_size(group)
    if t.is_meta:
        part = t.chunk(n, dim)[0]
        WIRE.sent("reduce-scatter", (n - 1) * _nbytes(part))
        return torch.empty_like(part, memory_format=torch.contiguous_format)
    me = dist.get_rank(group)
    sends = [_wire_out(c) for c in t.chunk(n, dim)]
    recvs = [sends[me] if p == me else _wire_buffer(sends[0])
             for p in range(n)]
    # each peer's part sent to it point to point (gloo has no all-to-all
    # in every torch release)
    ops = []
    for p in range(n):
        if p != me:
            peer = dist.get_global_rank(group, p)
            ops += [dist.P2POp(dist.isend, sends[p], peer, group),
                    dist.P2POp(dist.irecv, recvs[p], peer, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    WIRE.sent("reduce-scatter", (n - 1) * _nbytes(sends[0]))
    parts = [_wire_in(r, t.device) for r in recvs]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        if t.is_meta:
            n = dist.get_world_size(group)
            WIRE.gathers += 1
            WIRE.sent("all-gather", (n - 1) * _nbytes(t))
            return torch.cat([t] * n, dim=dim)
        return torch.cat(_all_gather(t, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad.contiguous(), ctx.dim, ctx.group), \
            None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _reduce(t, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return (_reduce(grad.contiguous(), ctx.group, dist.ReduceOp.SUM),
                None)


def all_gather(t: torch.Tensor, dim: int, axes: Axes,
               rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The parts of every rank along `axes`, concatenated along `dim` in
    the axes' order (the reverse of `local_shard`'s cut)."""
    rules = _rules(rules)
    for axis in reversed(_axes(axes, rules)):
        t = _AllGather.apply(t, dim, rules.group(axis))
    return t


def all_reduce_sum(t: torch.Tensor, axes: Axes = None,
                   rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The sum of `t` over the ranks of `axes` (None: the whole mesh), on
    every one of them, with its gradient."""
    rules = _rules(rules)
    for axis in _axes(axes, rules):
        t = _AllReduceSum.apply(t, rules.group(axis))
    return t


@torch.no_grad()
def all_reduce_max(t: torch.Tensor, axes: Axes = None,
                   rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The max of `t` over the ranks of `axes` (None: the whole mesh),
    without a gradient."""
    rules = _rules(rules)
    t = t.detach()
    for axis in _axes(axes, rules):
        t = _reduce(t, rules.group(axis), dist.ReduceOp.MAX)
    return t


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits some dim over."""
    out = []
    for axes in spec:
        if axes:
            out.extend((axes,) if isinstance(axes, str) else axes)
    return tuple(out)


def gather(t: torch.Tensor, spec: Optional[Spec],
           skip: Tuple[str, ...] = (),
           rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The full tensor of a local shard under `spec`, every split dim
    gathered (with its gradient), except over the axes in `skip`."""
    if spec is None:
        return t
    for dim, axes in enumerate(spec):
        if not axes:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a in skip for a in axes):
            if not all(a in skip for a in axes):
                raise ValueError(f"spec {spec}: cannot skip part of {axes}")
            continue
        t = all_gather(t, dim, axes, rules)
    return t


def unsplit_axes(spec: Spec, rules: Optional[ShardingRules] = None
                 ) -> Tuple[str, ...]:
    """The mesh axes a leaf under `spec` is replicated over."""
    split = set(spec_axes(spec))
    return tuple(a for a in _rules(rules).mesh.mesh_dim_names
                 if a not in split)


def replicas(spec: Spec, rules: Optional[ShardingRules] = None) -> int:
    """How many ranks of the mesh hold the same shard under `spec`: the
    product of the sizes of the axes it does not split."""
    rules = _rules(rules)
    n = 1
    for a in unsplit_axes(spec, rules):
        n *= rules.size(a)
    return n


def shards(spec: Spec, rules: Optional[ShardingRules] = None) -> int:
    """How many distinct shards a tensor has under `spec`: the product of
    the sizes of the axes it splits."""
    rules = _rules(rules)
    n = 1
    for a in spec_axes(spec):
        n *= rules.size(a)
    return n


@torch.no_grad()
def sum_over_replicas(leaves: List[torch.Tensor], specs: List[Spec],
                      rules: Optional[ShardingRules] = None
                      ) -> List[torch.Tensor]:
    """Each leaf summed over the mesh axes its spec leaves whole (the
    ranks that hold the same shard): one all-reduce for all the leaves of
    one dtype replicated over the same axes, flattened into one buffer."""
    rules = _rules(rules)
    out = list(leaves)
    groups: Dict[Tuple[Tuple[str, ...], torch.dtype], List[int]] = {}
    for i, (t, sp) in enumerate(zip(leaves, specs)):
        axes = unsplit_axes(sp, rules)
        if _axes(axes, rules):
            groups.setdefault((axes, t.dtype), []).append(i)
    for (axes, _), idx in groups.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = all_reduce_sum(flat, axes, rules)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return out
