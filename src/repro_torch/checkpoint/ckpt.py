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
Leaves are stored on the host, so a checkpoint restores onto any device
(`restore(..., device=)`, where the reference takes shardings).
"""
from __future__ import annotations

import os
import pickle
import re
import time
from typing import Any, List, Optional, Tuple, Union

import torch

from repro_torch import tree

_NAME = re.compile(r"step_(\d+)\.ckpt")
# what torch.load raises on a truncated or foreign file
_UNREADABLE = (OSError, RuntimeError, EOFError, ValueError, KeyError,
               pickle.UnpicklingError)


def save(ckpt_dir: str, step: int, state: Any, *, retries: int = 3,
         keep: int = 3) -> str:
    """Atomically persist the tree `state` for `step`.  Returns the file
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"step": step,
               "leaves": [x.detach().to("cpu", copy=True)
                          for x in tree.leaves(state)]}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
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
            step: Optional[int] = None) -> Optional[Tuple[int, Any]]:
    """Restore the newest (or the requested) parseable checkpoint into
    the structure of `like`, each leaf on `device` (None: the device of
    `like`'s leaf).  Returns (step, tree), or None when there is no
    checkpoint.  Raises ValueError when the file's leaf count is not
    `like`'s (an incompatible tree)."""
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
        placed = [x.to(device if device is not None else ref.device)
                  for x, ref in zip(leaves, flat_like)]
        return got_step, tree.unflatten(like, placed)
    return None
