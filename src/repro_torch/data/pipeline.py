"""Deterministic synthetic data pipeline with prefetch, the port of
`repro/data/pipeline.py`.

The input side of the training loop applies the paper's back-streaming
idea: the producer pushes the next batches toward the consumer (the
train step) before it asks for them, so the host-to-device copy overlaps
the previous step's compute.  `depth` is the credit count: the iterator
never runs more than `depth` batches ahead of consumption.

`synth_batch` is a pure function of (seed, step), numpy's Philox stream
at counter [0, 0, 0, step], the reference's code: the port's batches are
the reference's bit for bit, so a restart resumes exactly from a step
index.  On a training mesh each data rank takes its rows of the global
batch (`specs=`, `launch/partition.batch_specs`), so a mesh run sees the
single device's data bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.partition import local_shard


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int                   # global batch
    seq_len: int
    seed: int = 0
    frontend: str = "none"       # none | patch | audio_conv (stub embeds)
    d_model: int = 0             # required for stub-embedding frontends
    enc_dec: bool = False
    enc_len: int = 0


def synth_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch of `step`, a pure function of (seed, step)."""
    rng = np.random.Generator(np.random.Philox(key=cfg.seed,
                                               counter=[0, 0, 0, step]))
    # Markov-ish token stream: correlated tokens so the loss actually falls
    base = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq_len),
                        dtype=np.int32)
    drift = rng.integers(0, 17, (cfg.batch, 1), dtype=np.int32)
    tokens = (base // 3 * 3 + drift % 3) % cfg.vocab
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    out: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    if cfg.enc_dec:
        # the decoder keeps text tokens; the encoder gets stub frames
        out["embeds"] = rng.standard_normal(
            (cfg.batch, cfg.enc_len, cfg.d_model), dtype=np.float32)
    elif cfg.frontend != "none":
        # modality stub (vlm): patch embeddings replace the token stream
        out["embeds"] = rng.standard_normal(
            (cfg.batch, cfg.seq_len, cfg.d_model), dtype=np.float32)
        del out["tokens"]
    return out


class PrefetchIterator:
    """Keeps up to `depth` batches in flight on `device`: each is copied
    from pinned host memory with `non_blocking=True` (on the card), so
    the copies queue behind the running step.  Yields (step, batch of
    tensors).  `specs` and `mesh`: each key's rows cut to this rank's
    `local_shard` before the copy."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None,
                 specs: Optional[Dict[str, Any]] = None, mesh: Any = None):
        self.cfg = cfg
        self.specs, self.mesh = specs, mesh
        self.step = start_step
        self.depth = max(1, depth)
        self.device = resolve_device(device)
        self.ring: collections.deque = collections.deque()

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for key, arr in batch.items():
            host = torch.from_numpy(arr)
            if self.specs is not None:
                host = local_shard(host, self.specs[key],
                                   self.mesh).contiguous()
            if self.device.type == "cuda":
                host = host.pin_memory()
            out[key] = host.to(self.device, non_blocking=True)
        return out

    def _fill(self) -> None:
        while len(self.ring) < self.depth:
            self.ring.append(
                (self.step, self._put(synth_batch(self.cfg, self.step))))
            self.step += 1

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        self._fill()
        step, batch = self.ring.popleft()
        self._fill()               # the producer pushes ahead
        return step, batch


def make_pipeline(cfg: DataConfig, start_step: int = 0, depth: int = 2,
                  device: Optional[Union[str, torch.device]] = None,
                  specs: Optional[Dict[str, Any]] = None, mesh: Any = None
                  ) -> PrefetchIterator:
    """The prefetching iterator from `start_step` onto `device` (the GPU
    unless the caller asks for the CPU); with `specs` and `mesh`, this
    rank's rows of each batch."""
    return PrefetchIterator(cfg, start_step, depth, device, specs, mesh)
