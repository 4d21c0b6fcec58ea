"""Batched serving with offload-protocol selection, the port of
`examples/serve_offload.py`: a mistral-nemo-family model served with
continuous batching under the three host-memory coordination protocols,
bulk-synchronous (BS), serialized round-trips (RP) and asynchronous
back-streaming (AXLE), whose tokens must be identical (the protocol only
changes the schedule of the partial-attention merge, never its value);
then the other ported architecture families through the same real
prefill-into-cache admission and streamed decode loop.

On one device BS and AXLE take the same fused decode kernel, so their
tokens are equal bit for bit.  RP runs the per-chunk partial kernel and
a merge (`chunks_per_shard=4`): the same sums in another order, each
chunk's statistics scaled by its own maximum before the merge rescales
them (with one chunk RP gives the fused route's bits on the card too).  At
smoke size its tokens are BS's; at full width with random weights a
stream can meet an exact or near tie of the two best logits, where that
last-bit difference picks the other token.  So `main` requires RP to
equal BS or to part only where the two choices' logits lie within
NEAR_TIE of each other (in a prefill of the prompt and the common
prefix), and prints each parting.

    PYTHONPATH=src python -m repro_torch.examples.serve_offload \\
        [--device cpu] [--full]

It runs on the GPU unless `--device cpu` is given, and raises when no GPU
is present and none was asked for.  `--full` serves the full-width
configs (random weights from seed 0) instead of the smoke ones.  On one
device BS and AXLE take the fused decode kernel and RP the per-chunk
partial kernel plus a merge (`chunks_per_shard=4`).  The families are the
reference's: mamba2_370m, jamba_1_5_large and the encoder-decoder
whisper_large_v3, each of whose requests brings random frames from the
stub audio frontend (an encoder pass and per-slot cross-K/V at
admission).  Under `--full`, jamba_1_5_large is its CARD config
(`configs.get_card_config`: the full widths, its first five layers),
which one 80 GB card holds.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_card_config
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import transformer

ARCH = "mistral_nemo_12b"
FAMILIES = ("mamba2_370m", "jamba_1_5_large", "whisper_large_v3")
PROTOCOLS = ("bs", "rp", "axle")
NEAR_TIE = 0.1


def _sync(server: BatchedServer) -> None:
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)


def serve_with(protocol: str, n_requests: int = 6, max_new: int = 12, *,
               device: Optional[str] = None, full: bool = False,
               params: Optional[Dict[str, Any]] = None
               ) -> Tuple[Dict[int, Tuple[int, ...]], BatchedServer, float]:
    """The reference's run: 3 slots, max_seq 128, `chunks_per_shard=4`,
    `n_requests` prompts of 4-9 tokens from seed 7, per-token decode.
    `params`: the weights to serve (the reference's layout); None draws
    the port's own from seed 0.  Returns ({rid: tokens}, the drained
    server, the seconds it took to drain)."""
    rng = np.random.default_rng(7)
    server = BatchedServer(ARCH, smoke=not full, device=device,
                           batch_slots=3, max_seq=128, protocol=protocol,
                           chunks_per_shard=4, params=params)
    for i in range(n_requests):
        plen = int(rng.integers(4, 10))
        server.submit(Request(i, rng.integers(
            1, server.cfg.vocab, plen).astype(np.int32), max_new))
    _sync(server)
    t0 = time.perf_counter()
    server.run_until_drained()
    _sync(server)
    dt = time.perf_counter() - t0
    gens = {r.rid: tuple(r.generated) for r in server.completed}
    toks = sum(len(g) for g in gens.values())
    print(f"  {protocol:4s}: {len(gens)} requests, {toks} tokens, "
          f"{server.steps} batched steps, {dt:.2f}s")
    return gens, server, dt


def partings(server: BatchedServer, got: Dict[int, Tuple[int, ...]],
             want: Dict[int, Tuple[int, ...]]
             ) -> List[Tuple[int, int, float]]:
    """Each stream of `got` that parts from `want`: (rid, the first index
    where they differ, the distance between the two choices' logits in a
    prefill of the prompt and the common prefix on `server`'s model)."""
    prompts = {r.rid: r.prompt for r in server.completed}
    out = []
    for rid, a in got.items():
        b = want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = torch.from_numpy(np.concatenate(
            [prompts[rid], np.asarray(b[:t], np.int32)])).to(server.device)
        cache = transformer.init_cache(server.cfg, 1, server.max_seq,
                                       device=server.device)
        lg, _ = transformer.prefill_into_cache(server.cfg, server.params,
                                               cache, seq, 0, len(seq))
        out.append((rid, t, abs(lg[a[t]] - lg[b[t]]).item()))
    return out


def serve_family(arch_id: str, n_requests: int = 3, max_new: int = 8, *,
                 device: Optional[str] = None, full: bool = False
                 ) -> Dict[int, List[int]]:
    """Every ported family goes through the SAME real prefill-into-cache
    admission (attention K/V capture, SSM recurrent-state capture, or an
    encoder pass and per-slot cross-K/V) and the same streamed decode
    loop.  Returns {rid: tokens}."""
    rng = np.random.default_rng(11)
    server = BatchedServer(arch_id, smoke=not full, device=device,
                           batch_slots=2, max_seq=64, protocol="bs",
                           stream=True,
                           cfg=get_card_config(arch_id) if full else None)
    for i in range(n_requests):
        plen = int(rng.integers(4, 8))
        embeds = None
        if server.cfg.enc_dec:     # the stub audio frontend: random frames
            embeds = rng.standard_normal(
                (server.cfg.enc_len, server.cfg.d_model)).astype(np.float32)
        server.submit(Request(i, rng.integers(
            1, server.cfg.vocab, plen).astype(np.int32), max_new,
            embeds=embeds))
    server.run_until_drained()
    toks = sum(len(r.generated) for r in server.completed)
    spt = server.decode_syncs / max(1, toks)
    print(f"  {arch_id:16s} ({server.cfg.family:6s}): "
          f"{len(server.completed)} requests, {toks} tokens, "
          f"{spt:.3f} host syncs/token (streamed)")
    return {r.rid: list(r.generated) for r in server.completed}


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--full", action="store_true",
                        help="the full-width configs (default: smoke)")
    args = parser.parse_args(argv)
    print("continuous-batching server, one run per protocol:")
    outs: Dict[str, Dict] = {}
    params = None
    for protocol in PROTOCOLS:
        outs[protocol], server, _ = serve_with(
            protocol, device=args.device, full=args.full, params=params)
        params = server.params              # one weight draw for all three
    if outs["bs"] != outs["axle"]:
        raise RuntimeError("bs and axle (the same fused kernel) must "
                           "generate identical tokens")
    parts = partings(server, outs["rp"], outs["bs"])
    for rid, t, gap in parts:
        print(f"  rp parts from bs in request {rid} at token {t}: the two "
              f"choices' logits {gap:.4f} apart")
        if gap >= NEAR_TIE:
            raise RuntimeError(f"rp parts from bs in request {rid} at "
                               f"token {t}, not at a near tie ({gap})")
    print("all protocols generated identical tokens "
          "(schedule changes, values don't)" if not parts else
          "bs == axle; rp == bs up to near ties")
    del params, server
    print("streamed serving across architecture families "
          "(real prefill for all):")
    for arch in FAMILIES:
        serve_family(arch, device=args.device, full=args.full)
    return outs


if __name__ == "__main__":
    main()
