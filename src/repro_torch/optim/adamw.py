"""AdamW with global-norm clipping and an f32 master copy of the
parameters, the port of `repro/optim/adamw.py`.

The state is a tree mirroring the parameters (`repro_torch.tree`): the
step, the f32 moments and the f32 master, from which each update casts
the parameters back to their dtype (bf16 params, f32 master).  The
schedule and the bias corrections are f32 tensors on the parameters'
device, as the reference computes them under jit, so a step reads
nothing back to the host.  `apply` updates the moments and the master
IN PLACE (the port's idiom for state it owns, as the decode caches) and
returns new parameter tensors.  On a training mesh every leaf is the
rank's shard (`launch/partition.opt_state_specs`): the update is
elementwise, and only the clipping norm crosses ranks
(`global_norm(specs=)`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar: the updates applied so far
    mu: Any              # f32 tree like params
    nu: Any              # f32 tree like params
    master: Any          # f32 master copy of the params


def init(params: Any) -> OptState:
    """Zero moments and an f32 master that is a COPY of every leaf: an
    f32 leaf's `.float()` would be the leaf itself, and the in-place
    master update would then write the parameter."""
    first = tree.leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree.map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
        nu=tree.map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
        master=tree.map_leaves(
            lambda p: p.detach().to(torch.float32, copy=True), params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_ratio: an f32 scalar
    tensor for the int step tensor."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads: Any, specs: Any = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.
    With `specs` (the gradients' spec tree, under the active mesh's
    rules) each leaf is the rank's shard: its sum of squares is divided
    by the number of ranks holding the same shard and summed over the
    mesh, so each element of the global tree counts once."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    if specs is None:
        return torch.sqrt(torch.sum(torch.stack(sums)))
    from repro_torch.core import collectives as C
    sums = [s / C.replicas(sp) for s, sp in zip(sums, tree.leaves(specs))]
    return torch.sqrt(C.all_reduce_sum(torch.sum(torch.stack(sums))))


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
          specs: Any = None
          ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW update: the gradients clipped to `clip_norm` by their
    global norm, the bias-corrected step and the decoupled weight decay
    applied to the f32 master.  Returns (new params in each leaf's dtype,
    the state, {"grad_norm", "lr"}); `state`'s moments and master are
    updated in place.  `specs`: the leaves are a mesh rank's shards
    under this spec tree (`global_norm`)."""
    gnorm = global_norm(grads, specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    new_params = []
    for p, g, mu, nu, master in zip(
            tree.leaves(params), tree.leaves(grads), tree.leaves(state.mu),
            tree.leaves(state.nu), tree.leaves(state.master)):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = ((mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
               + cfg.weight_decay * master)
        master.sub_(lr * upd)
        new_params.append(master.to(p.dtype, copy=True))
    return (tree.unflatten(params, new_params),
            OptState(step, state.mu, state.nu, state.master),
            {"grad_norm": gnorm, "lr": lr})
