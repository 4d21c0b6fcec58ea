"""Fault-tolerant checkpointing, the port of `repro/checkpoint/ckpt.py`:
atomic, retried, restorable onto any device.

Layout: one file a step, `torch.save` of {"step", "leaves"} with the
tree's leaves in `repro_torch.tree` order (bf16 kept bf16), read back
with `torch.load(weights_only=True)`:
    <dir>/step_<n>.ckpt        (a temporary file, then an atomic rename)
    <dir>/latest               (a text pointer, atomically replaced)

Fault tolerance as the reference's: `save` retries transient I/O
failures with backoff and keeps the newest `keep` files; a crash
mid-write never corrupts `latest` (the rename is atomic); `restore`
falls back to the newest parseable file when a newer one is truncated.
Leaves are stored on the host and whole, so a checkpoint is
mesh-agnostic: it restores onto any device (`restore(..., device=)`) and
under any mesh (`restore(..., shardings=, mesh=)`, a tree of specs: each
rank takes its `local_shard` of every leaf).  A mesh's ranks save
together (`save(..., shardings=, mesh=)`): every leaf is gathered whole
from its shards, rank 0 writes, and the others wait for the file.
"""
from __future__ import annotations

import os
import pickle
import re
import time
from typing import Any, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core import collectives as C
from repro_torch.launch.partition import local_shard
from repro_torch.sharding import ShardingRules, use_rules

_NAME = re.compile(r"step_(\d+)\.ckpt")
# what torch.load raises on a truncated or foreign file
_UNREADABLE = (OSError, RuntimeError, EOFError, ValueError, KeyError,
               pickle.UnpicklingError)


def save(ckpt_dir: str, step: int, state: Any, *, retries: int = 3,
         keep: int = 3, shardings: Any = None, mesh: Any = None) -> str:
    """Atomically persist the tree `state` for `step`.  Returns the file
    path.  `shardings` (a spec tree like `state`) and `mesh`: `state`
    holds this rank's shards; every rank calls this, the leaves are
    gathered whole, and rank 0 writes while the others wait."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
    if shardings is not None:
        with use_rules(ShardingRules(mesh)), torch.no_grad():
            full = [C.gather(x, sp) for x, sp in
                    zip(tree.leaves(state), tree.leaves(shardings))]
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, full, path, retries, keep)
        dist.barrier()
        return path
    return _write(ckpt_dir, step, tree.leaves(state), path, retries, keep)


def _write(ckpt_dir: str, step: int, leaves: List[torch.Tensor], path: str,
           retries: int, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"step": step,
               "leaves": [x.detach().to("cpu", copy=True) for x in leaves]}
    tmp = f"{path}.tmp.{os.getpid()}"
    last_err: Optional[OSError] = None
    for attempt in range(retries):
        try:
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)                          # atomic
            ltmp = os.path.join(ckpt_dir, f".latest.tmp.{os.getpid()}")
            with open(ltmp, "w") as f:
                f.write(os.path.basename(path))
            os.replace(ltmp, os.path.join(ckpt_dir, "latest"))
            _gc(ckpt_dir, keep)
            return path
        except OSError as e:                               # transient I/O
            last_err = e
            time.sleep(0.05 * 2 ** attempt)
    raise RuntimeError(f"checkpoint save failed after {retries} retries"
                       ) from last_err


def _gc(ckpt_dir: str, keep: int) -> None:
    """Remove all but the newest `keep` step files."""
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if _NAME.fullmatch(f))
    for f in ckpts[:-keep] if keep > 0 else []:
        try:
            os.remove(os.path.join(ckpt_dir, f))
        except OSError:
            pass


def available_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := _NAME.fullmatch(f)))


def _load_file(path: str) -> Tuple[int, List[torch.Tensor]]:
    rec = torch.load(path, map_location="cpu", weights_only=True)
    return int(rec["step"]), list(rec["leaves"])


def restore(ckpt_dir: str, like: Any, *,
            device: Optional[Union[str, torch.device]] = None,
            step: Optional[int] = None, shardings: Any = None,
            mesh: Any = None) -> Optional[Tuple[int, Any]]:
    """Restore the newest (or the requested) parseable checkpoint into
    the structure of `like`, each leaf on `device` (None: the device of
    `like`'s leaf).  Returns (step, tree), or None when there is no
    checkpoint.  Raises ValueError when the file's leaf count is not
    `like`'s (an incompatible tree).  `shardings` (a spec tree like
    `like`) and `mesh`: each leaf is this rank's `local_shard` of the
    saved one, a copy, whatever mesh (or device) wrote it."""
    steps = available_steps(ckpt_dir)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in reversed(steps):
        try:
            got_step, leaves = _load_file(
                os.path.join(ckpt_dir, f"step_{s:08d}.ckpt"))
        except _UNREADABLE:
            continue                      # truncated / corrupt: fall back
        flat_like = tree.leaves(like)
        if len(leaves) != len(flat_like):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                             f"expected {len(flat_like)}: incompatible tree")
        if shardings is not None:
            leaves = [local_shard(x, sp, mesh).clone() for x, sp in
                      zip(leaves, tree.leaves(shardings))]
        placed = [x.to(device if device is not None else ref.device)
                  for x, ref in zip(leaves, flat_like)]
        return got_step, tree.unflatten(like, placed)
    return None
