"""Workload profiles (Table IV) calibrated against the paper's reported breakdowns.

Each profile describes one application run as `n_iters` iterations of a
{CCM tasks -> result back-transfer -> host tasks} pipeline, matching how the
paper's benchmarks offload (Table I):

  * KNN          - vector distance calc on CCM, top-K merge on host
  * SSSP/PageRank- edge traversal + vertex update on CCM, rank/frontier on host
  * SSB (OLAP)   - filter/SELECT marking on CCM, aggregation on host
  * OPT-2.7B     - attention block on CCM, MLP on host, per layer
  * DLRM         - embedding lookup + SLS on CCM, interaction MLP on host

Calibration targets (component ratios of the RP end-to-end runtime) are the
values stated in the paper:
  (a) KNN(2048,128):  BS=90.46%, AXLE p1=63.41% of RP         [SS V-B]
  (b) KNN(1024,256):  AXLE p100 = 1.18x AXLE p1               [SS V-B]
  (e) PageRank:       T_C=49.9%, T_D=48%, T_H=2.1% under RP   [SS III-C]
                      AXLE p1 -50.14% vs RP, -48.88% vs BS    [SS V-B]
  (f) SSB Q1_1 (BS):  CCM 22.24%, DM 0.58%, host 75.84%; AXLE=77.12%  [SS V-B]
  (h) OPT-2.7B:       AXLE ~= baselines; gains appear with fewer host
                      units (fig11: 75.99% at p10)            [SS V-B]

`iter_dependent` encodes the cross-iteration dependency discussed in
SS III-C: graph analytics and layer-by-layer LLM inference must wait for
host processing before launching the next offload iteration, whereas
independent query/request batches (KNN, OLAP, DLRM) may pipeline across
iterations under an asynchronous protocol (the serialized RP/BS flows
cannot exploit this either way).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    key: str                 # paper's annotation letter (a)..(i)
    domain: str
    application: str
    characteristics: str
    n_iters: int
    # CCM side: n_ccm_tasks per iteration, mean duration (ns), result bytes/task.
    n_ccm_tasks: int
    t_ccm_ns: float
    bytes_per_task: int
    # Host side: n_host_tasks per iteration, mean duration (ns).
    n_host_tasks: int
    t_host_ns: float
    # Host task j depends on CCM tasks [j*fanin, (j+1)*fanin).
    # Invariant: n_ccm_tasks == n_host_tasks * fanin.
    fanin: int
    # Deterministic task-duration heterogeneity (+- fraction of the mean).
    het: float
    # Whether iteration i+1's offload depends on iteration i's host results.
    iter_dependent: bool
    # Granularity of the cross-iteration dependency under AXLE:
    #   "barrier" - iteration i+1 launches only after ALL host tasks of
    #               iteration i complete (graph frontier computation);
    #   "group"   - CCM tasks [j*fanin,(j+1)*fanin) of iteration i+1 launch
    #               as soon as host task j of iteration i completes
    #               (per-block LLM layer chains).  RP/BS remain fully
    #               serialized either way (their protocols block the host).
    dep_granularity: str = "barrier"
    # How strongly the CCM RR scheduler's requeue churn (SS V-E: not-ready
    # tasks are moved to the back of the queue) scrambles completion order
    # w.r.t. data offsets.  0 = offset order (attention partials consumed
    # in sequence), 1 = full scrambling (uniform fine-grained chunks).
    sched_scramble: float = 0.5

    def __post_init__(self) -> None:
        if self.n_ccm_tasks != self.n_host_tasks * self.fanin:
            raise ValueError(
                f"{self.key}: n_ccm_tasks ({self.n_ccm_tasks}) != "
                f"n_host_tasks*fanin ({self.n_host_tasks * self.fanin})")

    @property
    def iter_result_bytes(self) -> int:
        return self.n_ccm_tasks * self.bytes_per_task


US = 1_000.0  # ns per microsecond

WORKLOADS: Dict[str, WorkloadProfile] = {
    # (a) KNN Dim=2048 #Rows=128 - CCM-heavy; one 4B distance per row; the
    # host streams top-K merges (7 waves of fine-grained merge tasks).
    # Iterative beam-search-style KNN (CXL-ANNS [19]) => cross-iteration dep.
    "a": WorkloadProfile(
        key="a", domain="VectorDB", application="KNN",
        characteristics="Dim: 2048, #Rows: 128",
        n_iters=8, n_ccm_tasks=448, t_ccm_ns=5.5 * US, bytes_per_task=4,
        n_host_tasks=448, t_host_ns=1.0 * US, fanin=1,
        het=0.15, iter_dependent=True),
    # (b) KNN Dim=1024 #Rows=256 - finer-grained CCM tasks; host share grows.
    "b": WorkloadProfile(
        key="b", domain="VectorDB", application="KNN",
        characteristics="Dim: 1024, #Rows: 256",
        n_iters=12, n_ccm_tasks=448, t_ccm_ns=3.0 * US, bytes_per_task=4,
        n_host_tasks=448, t_host_ns=2.0 * US, fanin=1,
        het=0.15, iter_dependent=True),
    # (c) KNN Dim=512 #Rows=512 - host-processing intensive (fig4 trend).
    "c": WorkloadProfile(
        key="c", domain="VectorDB", application="KNN",
        characteristics="Dim: 512, #Rows: 512",
        n_iters=12, n_ccm_tasks=512, t_ccm_ns=3.5 * US, bytes_per_task=4,
        n_host_tasks=512, t_host_ns=1.8 * US, fanin=1,
        het=0.15, iter_dependent=True),
    # (d) SSSP #V=264346 #E=733846 - data-movement heavy (~2.1 MB of updated
    # vertex data per iteration); frontier computed on host between iters.
    "d": WorkloadProfile(
        key="d", domain="Graph Analytics", application="SSSP",
        characteristics="#V: 264346, #E: 733846",
        n_iters=12, n_ccm_tasks=2048, t_ccm_ns=3.625 * US, bytes_per_task=1_050,
        n_host_tasks=2048, t_host_ns=0.3875 * US, fanin=1,
        het=0.35, iter_dependent=True, sched_scramble=1.0),
    # (e) PageRank #V=299067 #E=977676 - calibrated to the stated RP split
    # T_C=49.9% / T_D=48% / T_H=2.1% (SS III-C): 2.4 MB of vertex values per
    # iteration, tiny host rank update.
    "e": WorkloadProfile(
        key="e", domain="Graph Analytics", application="PageRank",
        characteristics="#V: 299067, #E: 977676",
        n_iters=10, n_ccm_tasks=2048, t_ccm_ns=4.825 * US, bytes_per_task=1_175,
        n_host_tasks=2048, t_host_ns=0.05 * US, fanin=1,
        het=0.35, iter_dependent=True, sched_scramble=1.0),
    # (f) SSB Q1_1 - host-dominated OLAP aggregation after CCM-side filtering.
    "f": WorkloadProfile(
        key="f", domain="OLAP", application="SSB",
        characteristics="Query: Q1_1",
        n_iters=6, n_ccm_tasks=256, t_ccm_ns=22.0 * US, bytes_per_task=150,
        n_host_tasks=128, t_host_ns=38.0 * US, fanin=2,
        het=0.20, iter_dependent=False),
    # (g) SSB Q1_2 - more balanced than Q1_1 but still host-leaning.
    "g": WorkloadProfile(
        key="g", domain="OLAP", application="SSB",
        characteristics="Query: Q1_2",
        n_iters=6, n_ccm_tasks=256, t_ccm_ns=35.0 * US, bytes_per_task=150,
        n_host_tasks=128, t_host_ns=27.5 * US, fanin=2,
        het=0.20, iter_dependent=True),
    # (h) OPT-2.7B, 1K tokens - attention offloaded per layer (iter = layer);
    # sparse/grouped dependency: each host MLP task needs a contiguous block
    # of 32 attention partials; intermediate result is small ([1, hidden]).
    "h": WorkloadProfile(
        key="h", domain="LLM Inference", application="OPT 2.7b",
        characteristics="#Tokens: 1K",
        n_iters=32, n_ccm_tasks=512, t_ccm_ns=4.0 * US, bytes_per_task=320,
        n_host_tasks=16, t_host_ns=12.0 * US, fanin=32,
        het=0.25, iter_dependent=True, sched_scramble=0.0),
    # (i) DLRM / Criteo Dim=256 #Rows=1M - CCM(SLS)-dominated; pooled
    # embedding bags streamed to interaction MLP on host.
    "i": WorkloadProfile(
        key="i", domain="DLRM", application="Criteo",
        characteristics="Dim: 256, #Rows: 1M",
        n_iters=8, n_ccm_tasks=2048, t_ccm_ns=7.5 * US, bytes_per_task=1_024,
        n_host_tasks=2048, t_host_ns=0.25 * US, fanin=1,
        het=0.35, iter_dependent=False, sched_scramble=1.0),
}

WORKLOAD_KEYS = tuple(sorted(WORKLOADS))


def get_workload(key: str) -> WorkloadProfile:
    return WORKLOADS[key]
