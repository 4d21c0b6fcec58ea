"""Roofline terms of one counted step, the port of
`repro/roofline/analysis.py`, against one NVIDIA H100.

Three terms per (arch x shape x mesh), all per card (a cell is rank 0's
program):

  compute    = sum over product dtypes of FLOPs / that dtype's peak
  memory     = bytes / HBM_BW
  collective = collective bytes sent / the link rate of the layout

The counts come from `roofline/cost.py`'s `CostCounter` over the step's
aten ops and kernel formulas.  The rates are published peaks, not
measurements (NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB at
700 W: 989 TFLOP/s dense bf16 and fp16, 67 TFLOP/s f32 outside the tensor
cores (the port's f32 products run with TF32 off, `layers.true_f32`),
1,979 TOP/s int8, 3.35 TB/s HBM3, fourth-generation NVLink
900 GB/s a card both ways, 450 each; NVIDIA DGX H100 user guide: eight
ConnectX-7 400 Gb/s ports, one a card, 50 GB/s).  Inside one host of
eight cards a collective crosses NVLink; the production layouts (256 and
512 cards) cross hosts on every axis, so their collectives are held to the
card's one network port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s a card
# product FLOP/s a card by the dtype of the product's operands
PEAKS = {"bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS, "float32": 67e12,
         "int8": 1979e12}
HBM_BW = 3.35e12             # bytes/s a card
NVLINK_BW = 450e9            # bytes/s a card, each way, inside a host
NET_BW = 50e9                # bytes/s a card: one 400 Gb/s NIC
HOST_CARDS = 8               # cards a host (DGX H100)


def link_bw(chips: int) -> float:
    """The rate a card's collective bytes leave at: NVLink when the
    layout fits one host, else the card's network port."""
    return NVLINK_BW if chips <= HOST_CARDS else NET_BW


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per card
    flops_by_dtype: Dict[str, float]  # per card, by operand dtype
    bytes: float                 # per card, the ideal-fusion model
    coll_bytes: float            # per card, sent
    coll_by_op: Dict[str, float]
    model_flops: float           # 6 N D / 2 N D useful FLOPs, all cards

    @property
    def t_compute(self) -> float:
        return sum(f / PEAKS.get(dt, PEAK_FLOPS)
                   for dt, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / link_bw(self.chips)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """Model FLOPs over the counted FLOPs of every card: how much of
        the computed work is useful (replication, remat, padding)."""
        tot = self.flops * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The useful FLOPs' ideal time over the bounding term: 1.0 means
        the dominant resource is fully busy with useful work only."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_time if self.bound_time else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.flops,
            "flops_by_dtype": self.flops_by_dtype,
            "hlo_bytes_per_chip": self.bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_by_op": self.coll_by_op,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_estimate(cfg, shape_name: str, seq: int, batch: int,
                         kind: str) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for a forward
    pass (prefill), 2·N_active·batch for one decode token."""
    del shape_name
    n_active = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch


def analyze(counter, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float) -> RooflineTerms:
    """The terms of a closed `cost.CostCounter`."""
    return RooflineTerms(arch=arch, shape=shape, mesh=mesh_name,
                         chips=chips, flops=counter.flops,
                         flops_by_dtype=dict(counter.flops_by_dtype),
                         bytes=counter.bytes,
                         coll_bytes=counter.coll_bytes,
                         coll_by_op=dict(counter.coll_by_op),
                         model_flops=model_flops)
