"""KNN partial offload (Table I, VectorDB row), the port of
`examples/knn_offload.py`: the CUDA distance kernel is the producer-side
(memory-resident) task, the top-K select the consumer-side task, and
`stream_offload` folds database chunks through the merge under the BS,
RP and AXLE schedules, chunk results back-streaming into the running
top-K like the paper's ring-buffer payloads.

    PYTHONPATH=src python -m repro_torch.examples.knn_offload [--device cpu]

It runs on the GPU unless `--device cpu` is given, and raises when no GPU
is present and none was asked for.  It prints each protocol's wall time,
checks that the three protocols give equal bits and that their top-K
distances match the one-call `ops.knn_topk` within 1e-4.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.backstream import (OffloadConfig, OffloadProtocol,
                                         stream_offload, use_offload)
from repro_torch.kernels import ops, ref

Q, N, D, K, CHUNKS = 64, 4096, 256, 8, 8
PROTOCOLS = (OffloadProtocol.BS, OffloadProtocol.RP, OffloadProtocol.AXLE)


def knn_stream(queries: torch.Tensor, db: torch.Tensor, k: int,
               num_chunks: int, protocol: OffloadProtocol,
               global_ids: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest db rows of each query, with db streamed in
    `num_chunks` equal chunks of rows through `stream_offload`: the
    producer computes one chunk's distances (`ops.knn_distances`), the
    consumer folds that chunk's k best into the running top-k, keeping
    the earlier entry of a tie as the reference's stable argsort does.
    Ids are chunk-local, as in the reference's example, or, with
    `global_ids`, the row's index in db (the result is then the top-k of
    the whole db, ties lowest id first).  Returns (dists (Q,k) f32,
    ids (Q,k) int64)."""
    n = db.shape[0]
    if n % num_chunks or n // num_chunks < k:
        raise ValueError(f"knn_stream: {n} rows do not split into "
                         f"{num_chunks} equal chunks of at least k={k}")
    size = n // num_chunks

    def producer(i: int):
        return ops.knn_distances(queries, db[i * size:(i + 1) * size]), \
            i * size

    def consumer(carry, partial):
        top_d, top_i = carry
        dists, start = partial
        chunk_d, chunk_i = ref.smallest_k(dists, k)
        if global_ids:
            chunk_i = chunk_i + start
        merged_d = torch.cat([top_d, chunk_d], dim=1)
        merged_i = torch.cat([top_i, chunk_i], dim=1)
        best_d, at = ref.smallest_k(merged_d, k)
        return best_d, torch.gather(merged_i, 1, at)

    nq = queries.shape[0]
    init = (torch.full((nq, k), float("inf"), device=queries.device),
            torch.zeros((nq, k), dtype=torch.int64, device=queries.device))
    return stream_offload(producer, consumer, init, num_chunks, protocol)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None
         ) -> Dict[OffloadProtocol, Tuple[torch.Tensor, torch.Tensor]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    queries = torch.randn(Q, D, generator=gen).to(dev)
    db = torch.randn(N, D, generator=gen).to(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"KNN offload on {name}: Q={Q} N={N} D={D} K={K}, {CHUNKS} chunks")
    outs = {}
    for proto in PROTOCOLS:
        with use_offload(OffloadConfig(protocol=proto, ring_depth=2)):
            knn_stream(queries, db, K, CHUNKS, proto)       # warm-up
            _sync(dev)
            t0 = time.perf_counter()
            outs[proto] = knn_stream(queries, db, K, CHUNKS, proto)
            _sync(dev)
            print(f"  {proto.name:4s} top-{K} distances in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    bs = outs[OffloadProtocol.BS]
    for proto, (dists, ids) in outs.items():
        if not (torch.equal(dists, bs[0]) and torch.equal(ids, bs[1])):
            raise RuntimeError(f"{proto.name} differs from BS")
    ref_d, _ = ops.knn_topk(queries, db, K)
    if not torch.allclose(bs[0].sort(dim=1).values,
                          ref_d.sort(dim=1).values, atol=1e-4, rtol=0.0):
        raise RuntimeError("the streamed top-K differs from ops.knn_topk")
    print("all protocols agree with the monolithic top-K")
    return outs


if __name__ == "__main__":
    main()
