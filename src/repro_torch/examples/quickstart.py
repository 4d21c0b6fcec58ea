"""Quickstart, the port of `examples/quickstart.py`: the paper's protocol
in two parts.

1. Simulate the three offloading protocols on a paper workload (PageRank,
   workload "e") and print the headline comparison (Figs. 10 and 12):
   runtime against RP, and the CCM's and the host's idle shares.
2. Run the protocol on the device: decode attention over a KV cache in 8
   chunks, merged under BS and under AXLE, and check that they agree (the
   back-streaming correctness contract).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the GPU unless `--device cpu` is given, and raises when no GPU
is present and none was asked for, or when the two merges differ by 1e-4
or more.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.backstream import (OffloadConfig, OffloadProtocol,
                                         decode_attention_combined,
                                         use_offload)
from repro_torch.core.protocol import POLL_P1, AxleConfig
from repro_torch.core.simulator import compare_protocols
from repro_torch.core.workloads import WORKLOADS

B, S, H, HD = 2, 1024, 4, 64


def simulate() -> Dict[str, object]:
    """Part 1: the protocols on workload "e" at the P1 polling interval.
    Returns the results by protocol name."""
    wl = WORKLOADS["e"]                   # PageRank: data-movement heavy
    results = compare_protocols(wl, cfg=AxleConfig(poll_interval_ns=POLL_P1))
    rp = results["RP"]
    print(f"workload (e) {wl.application}: {wl.characteristics}")
    for name, r in results.items():
        print(f"  {name:4s} runtime {r.runtime_ns / 1e3:9.1f} us  "
              f"({r.runtime_ns / rp.runtime_ns * 100:6.2f}% of RP)   "
              f"ccm_idle {r.ccm_idle_ratio * 100:5.1f}%  "
              f"host_idle {r.host_idle_ratio * 100:5.1f}%")
    red = 1 - results["AXLE"].runtime_ns / rp.runtime_ns
    print(f"  -> AXLE reduces end-to-end runtime by {red * 100:.1f}% "
          "(paper: up to 50.14%)\n")
    return results


def merge_error(device: torch.device) -> float:
    """Part 2: decode attention of q (B, 1, H, HD) over a (B, H, S, HD)
    f32 cache at position S - 1, merged under BS and under AXLE with 8
    chunks a shard.  Returns their max |difference|."""
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((B, 1, H, HD), generator=gen, device=device)
    k = torch.randn((B, H, S, HD), generator=gen, device=device)
    v = torch.randn((B, H, S, HD), generator=gen, device=device)
    pos = torch.tensor(S - 1, dtype=torch.int32, device=device)
    outs = {}
    for proto in (OffloadProtocol.BS, OffloadProtocol.AXLE):
        with use_offload(OffloadConfig(protocol=proto, chunks_per_shard=8)):
            outs[proto.name] = decode_attention_combined(q, k, v, pos)
    return float((outs["BS"] - outs["AXLE"]).abs().max())


def main(device: Optional[str] = None) -> Dict[str, float]:
    """Both parts on `device` (default: the GPU).  Returns AXLE's runtime
    reduction against RP and the BS vs AXLE max error."""
    dev = resolve_device(device)
    results = simulate()
    err = merge_error(dev)
    print("decode attention: BS (bulk merge) vs AXLE (streamed merge) "
          f"max|err| = {err:.2e}  -> identical results, overlapped schedule")
    if not err < 1e-4:
        raise RuntimeError(f"BS and AXLE merges differ by {err}")
    return {"axle_reduction": 1 - results["AXLE"].runtime_ns
            / results["RP"].runtime_ns, "max_err": err}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run here)")
    main(ap.parse_args().device)
