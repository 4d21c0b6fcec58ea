"""Mesh-sharded serving on this host's ranks, held to the single device.

    PYTHONPATH=src python -m repro_torch.examples.mesh_serve \\
        [--full] [--layers N] [--device cpu] [--mesh 1x2] [--json out.json] \\
        [--serves plain,churn,prefix,chunked] [--offload] \\
        [--evict-after N] [--prefix-cache] [--prefill-chunk C]

First the single-device server serves the requests (on the card its
segments are CUDA graph replays) and one of its decode steps is timed;
then a DATAxMODEL gloo group of fresh processes (`launch/mesh.spawn`; on
a one-card host every rank shares the card) serves the same requests
with `BatchedServer(mesh=)`, eagerly: every rank's tokens, decode syncs
and page ledger must equal the single device's bit for bit.  Each rank
reports its launches of every kernel over the serve, its wire bytes
beside the ledger's formula, and one eager decode step's device and wall
ms with the fused partial's launches in it.  In the same group, `--ring-
seq S` runs the sequence-sharded schedules (BS, AXLE, RP) of
`decode_attention_combined` over a cache of S slots split across the
model ranks, in bf16 and f32, each held to the single-device fused
decode on every rank, with each AXLE hop's wall ms.

`--serves` names the serves, each on its own server (the weights drawn
once a process and shared), each held to its single-device twin:

  plain    the requests below, on a server with the serving CLI's
           `--offload`, `--evict-after`, `--prefix-cache` and
           `--prefill-chunk` when given;
  churn    the host tier, every slot evictable after one segment, two
           more requests than slots;
  prefix   the prefix cache: one prompt served, repeated and extended;
  chunked  chunked admission (`--prefill-chunk`, default 256): a
           `--long-prompt`-token prompt third in the queue, beside the
           streams in flight.

Under a data split a restore or a prefix hit that lands in another data
group's slot moves its snapshot there: each rank reports its evictions,
restores, prefix hits, chunks, `tier_moves` and `tier_bytes_moved`, the
restores' host ms (moved and local) and its resident cache bytes.

It runs on the GPU unless `--device cpu` is given, and raises when no GPU
is present and none was asked for.  The requests: half greedy, half
sampled (temperature 0.8, top_p 0.95), prompts of `--prompt-lo` to
`--prompt-hi` tokens drawn from seed 0, `--max-new` tokens each.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import backstream
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import BatchedServer, Request, SamplingParams
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import ShardingRules, use_rules

# the sequence-sharded schedules' tolerance against the fused decode:
# bf16 outputs one unit in the last place below 4; f32 one summation
# order apart
RING_ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def make_requests(vocab: int, n: int, lo: int, hi: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """n requests, odd ids sampled (T 0.8, top_p 0.95, seed 1000 + id),
    even ids greedy, prompts of lo..hi tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
        sampling = (SamplingParams(temperature=0.8, top_p=0.95,
                                   seed=1000 + i) if i % 2 else None)
        reqs.append(Request(i, prompt.astype(np.int32), max_new,
                            sampling=sampling))
    return reqs


SERVES = ("plain", "churn", "prefix", "chunked")
# what a serve on the mesh must equal on the single device
EQUAL = ("tokens", "syncs", "ledger", "evictions", "restores", "prefix",
         "prefill_chunks", "host_bytes")


def serve_setup(name: str, vocab: int, opts: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], List[Request]]:
    """Serve `name`'s server options and requests (see the module's
    docstring)."""
    lo, hi, new = opts["prompt_lo"], opts["prompt_hi"], opts["max_new"]
    if name == "plain":
        kw = dict(host_offload=opts["offload"],
                  evict_after=opts["evict_after"],
                  prefix_cache=opts["prefix_cache"],
                  prefill_chunk=opts["prefill_chunk"])
        return kw, make_requests(vocab, opts["requests"], lo, hi, new)
    if name == "churn":
        # two more requests than slots: at 2 rows a group every restore
        # lands in the other group's slots (four more keep each request
        # in its own group)
        return (dict(host_offload=True, evict_after=1),
                make_requests(vocab, opts["slots"] + 2, lo, hi, new))
    if name == "prefix":
        # at 2 rows a group, slots 0 and 1 lie in group 0: the first
        # prompt's entry is a miss there, its repeat in slot 1 a full hit
        # in place; its extension in slot 2 and its second repeat in
        # slot 3 move the entry to group 1
        reqs = make_requests(vocab, 6, lo, hi, new, seed=1)
        first = reqs[0].prompt
        for i, prompt in ((1, first), (3, first), (2, np.concatenate(
                [first, reqs[2].prompt[:lo]])), (5, np.concatenate(
                    [first, reqs[5].prompt[:lo]]))):
            reqs[i].prompt = prompt
        return dict(prefix_cache=True), reqs
    if name == "chunked":
        reqs = make_requests(vocab, 4, lo, hi, new, seed=2)
        rng = np.random.default_rng(3)
        reqs[2].prompt = rng.integers(1, vocab, opts["long_prompt"]).astype(
            np.int32)
        return dict(prefill_chunk=opts["prefill_chunk"] or 256), reqs
    raise ValueError(f"unknown serve {name!r}; want one of {SERVES}")


def _config(opts: Dict[str, Any]) -> ArchConfig:
    """The served config: the arch's (full or smoke), its first
    `--layers` layers when given."""
    cfg = (get_config if opts["full"] else get_smoke_config)(opts["arch"])
    if opts["layers"]:
        cfg = dataclasses.replace(cfg, arch_id=f"{cfg.arch_id}_first"
                                  f"{opts['layers']}", n_layers=opts["layers"])
    return cfg


def _server(opts: Dict[str, Any], device, mesh=None, params=None,
            **kw) -> BatchedServer:
    return BatchedServer(opts["arch"], cfg=_config(opts), device=device,
                         batch_slots=opts["slots"], max_seq=opts["max_seq"],
                         protocol=opts["protocol"], stream=True,
                         seg_len=opts["seg_len"], mesh=mesh, params=params,
                         **kw)


def _serve(server: BatchedServer, reqs: List[Request]) -> Dict[str, Any]:
    """Serve the requests; tokens, syncs, ledger, the host tier's counts,
    wall."""
    for req in reqs:
        server.submit(req)
    _sync(server.device)
    t0 = time.perf_counter()
    server.run_until_drained()
    _sync(server.device)
    wall = time.perf_counter() - t0
    server.assert_ledger()
    n_tok = sum(len(r.generated) for r in server.completed)
    s = server
    local = s.restores - s.restores_moved
    tier, prefix = s.host_tier, s.prefix
    return dict(tokens={r.rid: list(map(int, r.generated))
                        for r in server.completed},
                syncs=server.decode_syncs,
                ledger=(server.pages_allocated, server.pages_freed,
                        server.pages_resident_peak),
                evictions=s.evictions, restores=s.restores,
                prefix=(s.prefix_hits_full, s.prefix_hits_partial,
                        s.prefix_misses),
                prefill_chunks=s.prefill_chunks,
                # host bytes evicted and restored, the prefix cache's peak
                # (a rank's stubs count the holder's bytes)
                host_bytes=(tier.bytes_evicted if tier is not None else 0,
                            tier.bytes_restored if tier is not None else 0,
                            prefix.bytes_stored_peak if prefix is not None
                            else 0),
                tier_moves=s.tier_moves,
                tier_bytes_moved=s.tier_bytes_moved,
                restores_moved=s.restores_moved,
                restore_ms=(1e3 * s.restore_dispatch_time / s.restores
                            if s.restores else None),
                restore_moved_ms=(1e3 * s.restore_moved_time
                                  / s.restores_moved
                                  if s.restores_moved else None),
                restore_local_ms=(1e3 * (s.restore_dispatch_time
                                         - s.restore_moved_time) / local
                                  if local else None),
                cache_bytes=_cache_bytes(s),
                wall_s=wall, tok_s=n_tok / wall, tokens_n=n_tok,
                graph_replays=server.graph_replays)


def _cache_bytes(server: BatchedServer) -> int:
    """The bytes of this rank's device cache (and the draft's)."""
    caches = [server.cache] + ([server.draft_cache] if server.spec else [])
    return sum(t.numel() * t.element_size() for c in caches
               for t in c.values())


def serve_all(opts: Dict[str, Any], device: torch.device, mesh=None,
              step: bool = True) -> Dict[str, Any]:
    """Every serve of `opts["serves"]` on a server of its own, the weights
    drawn once (seed 0) and shared, each server freed before the next;
    with the launch counts set to 0 just before each serve and read just
    after.  The plain serve's report is the result's top level (with one
    decode step's times when `step`), every serve's under "serves"."""
    out: Dict[str, Any] = {"serves": {}}
    params = None
    for name in opts["serves"]:
        kw, reqs = serve_setup(name, _config(opts).vocab, opts)
        server = _server(opts, device, mesh, params, **kw)
        params = server.params
        kbuild.reset_launch_counts()
        backstream.WIRE.reset()
        rep = _serve(server, reqs)
        rep["launches"] = dict(kbuild.LAUNCHES)
        rep["gathers"] = backstream.WIRE.gathers
        rep["bytes_sent"] = backstream.WIRE.bytes_sent
        out["serves"][name] = rep
        if name == "plain":
            out.update(rep)
            w = server.wire
            out.update(
                wire=server.wire_bytes_per_shard,
                wire_model=dict(n_shards=w.n_shards,
                                rows_local=w.rows_local,
                                heads_local=w.heads_local,
                                head_dim=w.head_dim, merges=w.merges,
                                bytes_per_merge=w.bytes_per_merge),
                merges_per_step=server.merges_per_round)
            if step:
                out["step"] = step_times(server)
        del server
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out



def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_times(server: BatchedServer) -> Dict[str, Any]:
    """One decode step (the server's one-step segment function, graphed on
    a single card, eager under a mesh) of the drained server: its wall ms
    (a warmed call, synchronized), and on the card its device ms and
    kernels under torch.profiler, and the launches it makes by kernel.
    Every rank of a mesh calls it at once (the step gathers)."""
    args = (server.params, server.cache, server.state)

    def step():
        with server.segment_scope():
            server.step_fn(*args)

    step()
    _sync(server.device)
    before = dict(kbuild.LAUNCHES)
    t0 = time.perf_counter()
    step()
    _sync(server.device)
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v - before[k] for k, v in kbuild.LAUNCHES.items()
                if v != before[k]}
    out = dict(wall_ms=wall, launches=launches, device_ms=None, kernels=None)
    if server.device.type == "cuda":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step()
            _sync(server.device)
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in ev)
        out.update(device_ms=total / 1e3 if total else None,
                   kernels=sum(e.count for e in ev))
    return out


def _ring_inputs(opts: Dict[str, Any], cfg, device: torch.device):
    """q (B,1,H,hd), k/v (B,KH,S,hd), ragged clocks (the last row's inside
    the first span) and the current token's extra, from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    b, s = opts["slots"], opts["ring_seq"]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    pos = torch.tensor([s - 1 - (s * j) // (b + 1) for j in range(b - 1)]
                       + [s // 8], dtype=torch.int32, device=device)
    extra = (randn(b, h, hd), randn(b, h), torch.ones(b, h, device=device))
    return randn(b, 1, h, hd), randn(b, kh, s, hd), randn(b, kh, s, hd), \
        pos, extra


def ring_run(mesh, device: torch.device, cfg,
             opts: Dict[str, Any]) -> Dict[str, Any]:
    """BS, AXLE and RP over this rank's span of a sequence-sharded cache,
    bf16 and f32, each against the single-device fused decode of the
    whole cache (the kernel on the card): max |err|, the tolerance, the
    call's wall ms, the transport's counts and the AXLE hops' ms."""
    rules = ShardingRules(mesh, seq_shard_attn=True)
    n, r = rules.model_size(), rules.rank("model")
    q, k, v, pos, extra = _ring_inputs(opts, cfg, device)
    s_l = k.shape[2] // n
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        want = ops.decode_attention_fused(qd, kd, vd, pos, extra, blk_c=128)
        k_l = kd[:, :, r * s_l:(r + 1) * s_l].contiguous()
        v_l = vd[:, :, r * s_l:(r + 1) * s_l].contiguous()
        for proto in ("bs", "axle", "rp"):
            cfg_o = backstream.OffloadConfig(
                protocol=backstream.OffloadProtocol(proto))
            with backstream.use_offload(cfg_o), use_rules(rules):
                backstream.decode_attention_combined(qd, k_l, v_l, pos,
                                                     extra=extra)
                backstream.WIRE.reset()
                _sync(device)
                t0 = time.perf_counter()
                got = backstream.decode_attention_combined(
                    qd, k_l, v_l, pos, extra=extra)
                _sync(device)
                wall = (time.perf_counter() - t0) * 1e3
            w = backstream.WIRE
            err = (got.float() - want.float()).abs().max().item()
            out[f"{proto}/{str(dtype)[6:]}"] = dict(
                err=err, atol=RING_ATOL[dtype], ms=wall, gathers=w.gathers,
                hops=w.hops, broadcasts=w.broadcasts,
                bytes_sent=w.bytes_sent, hop_ms=list(w.hop_ms))
    return out


def rank_main(mesh, device: str, opts: Dict[str, Any]) -> List[Dict]:
    """One rank: every serve on a mesh server (`serve_all`: the launch
    counts set to 0 just before each serve and read just after), one
    eager decode step of the plain serve timed, the sequence-sharded
    schedules; every rank's report, gathered."""
    dev = mesh_lib.rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    report = serve_all(opts, dev, mesh)
    report["rank"] = dist.get_rank()
    if opts["ring_seq"]:
        report["ring"] = ring_run(mesh, dev, _config(opts), opts)
    every: List[Optional[Dict]] = [None] * dist.get_world_size()
    dist.all_gather_object(every, report)
    return every


def run(opts: Dict[str, Any]) -> Dict[str, Any]:
    """The single-device serve, then the mesh's; raises if a rank's tokens,
    syncs or ledger part from the single device's, or a ring schedule
    passes its tolerance.  Returns both sides' reports."""
    device = resolve_device(opts["device"])
    base = serve_all(opts, device)
    n_data, n_model = mesh_lib.parse_mesh(opts["mesh"])
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(rank_main, n_data, n_model,
                           device=str(device.type), args=(opts,),
                           threads=opts["threads"])
    group_s = time.perf_counter() - t0
    for rep in ranks:
        for name, srv in rep["serves"].items():
            for key in EQUAL:
                if srv[key] != base["serves"][name][key]:
                    raise AssertionError(
                        f"mesh {opts['mesh']} rank {rep['rank']} serve "
                        f"{name}: {key} {srv[key]} != the single device's "
                        f"{base['serves'][name][key]}")
        wm = rep.get("wire_model")
        if wm and (rep["wire"] != wm["merges"] * wm["bytes_per_merge"]
                   or rep["bytes_sent"] != rep["wire"]):
            raise AssertionError(f"rank {rep['rank']}: wire {rep['wire']} "
                                 f"sent {rep['bytes_sent']} model {wm}")
        for name, row in rep.get("ring", {}).items():
            if not row["err"] <= row["atol"]:
                raise AssertionError(
                    f"rank {rep['rank']} ring {name}: err {row['err']} > "
                    f"{row['atol']}")
    return dict(base=base, ranks=ranks, group_s=group_s)


def report_lines(res: Dict[str, Any], opts: Dict[str, Any]) -> List[str]:
    """The `[mesh]` lines of a run: the plain serve's, then the tier's."""
    lines = plain_lines(res, opts) if "plain" in opts["serves"] else []
    return lines + tier_lines(res, opts)


def plain_lines(res: Dict[str, Any], opts: Dict[str, Any]) -> List[str]:
    """The plain serve's line, its decode step's and the ring's."""
    base, ranks = res["base"], res["ranks"]
    wm = ranks[0]["wire_model"]
    lines = [
        f"[mesh] serve {opts['arch']} ({'full' if opts['full'] else 'smoke'}"
        f") {opts['mesh']} gloo ranks on {opts['device'] or 'cuda'}, "
        f"{opts['requests']} requests x {opts['max_new']} tokens, prompts "
        f"{opts['prompt_lo']}-{opts['prompt_hi']}, {opts['slots']} slots, "
        f"seg_len {opts['seg_len']}, eager segments: tokens, decode syncs "
        f"({base['syncs']}) and ledger {tuple(base['ledger'])} == the single "
        f"device's on every rank, bitwise; wire_bytes_per_shard "
        f"{ranks[0]['wire']} = {wm['merges']} merges x "
        f"{wm['bytes_per_merge']} B ((n-1) x {wm['rows_local']} rows x "
        f"{wm['heads_local']} heads x ({wm['head_dim']} + 2) x 4), "
        f"{ranks[0]['merges_per_step']} merges a step; the single device "
        f"{base['tok_s']:.1f} tok/s ({base['graph_replays']} graph "
        f"replays), the mesh {ranks[0]['tok_s']:.1f} tok/s; group "
        f"{res['group_s']:.1f} s"]
    bstep = base["step"]
    parts = []
    for rep in ranks:
        st = rep["step"]
        part = st["launches"].get("decode_attention_fused_partial", 0)
        parts.append(
            f"rank {rep['rank']}: {part} fused-partial launches a step "
            f"(serve: {rep['launches'].get('decode_attention_fused_partial', 0)}), "
            f"eager step device {_ms(st['device_ms'])} ms over "
            f"{st['kernels']} kernels, wall {st['wall_ms']:.3f} ms")
    lines.append(
        "[mesh] step: " + "; ".join(parts) + f"; the single device's "
        f"graphed step device {_ms(bstep['device_ms'])} ms over "
        f"{bstep['kernels']} kernels, wall {bstep['wall_ms']:.3f} ms")
    if "ring" in ranks[0]:
        cells = []
        for name in ranks[0]["ring"]:
            rows = [rep["ring"][name] for rep in ranks]
            hops = [f"{t:.3f}" for row in rows for t in row["hop_ms"]]
            cells.append(
                f"{name} err {max(r['err'] for r in rows):.3g} <= "
                f"{rows[0]['atol']} call {max(r['ms'] for r in rows):.3f} ms"
                + (f" hops {'/'.join(hops)} ms" if hops else ""))
        lines.append(f"[mesh] ring S={opts['ring_seq']} over "
                     f"{opts['mesh']} (every rank against the fused "
                     f"decode): " + "; ".join(cells))
    return lines


def tier_lines(res: Dict[str, Any], opts: Dict[str, Any]) -> List[str]:
    """One `[mesh] tier` line a serve that evicted, hit the prefix cache
    or admitted by chunks: its counts (equal on the single device and
    every rank), each rank's moves, bytes moved, restore host ms (moved /
    local) and resident cache bytes, beside the single device's."""
    base, ranks = res["base"], res["ranks"]
    lines = []
    for name, b in base["serves"].items():
        if not (b["evictions"] or any(b["prefix"]) or b["prefill_chunks"]):
            continue
        per_rank = []
        for rep in ranks:
            r = rep["serves"][name]
            per_rank.append(
                f"rank {rep['rank']}: {r['tier_moves']} moves "
                f"{r['tier_bytes_moved']} B, restore ms moved "
                f"{_ms(r['restore_moved_ms'])} local "
                f"{_ms(r['restore_local_ms'])}, cache "
                f"{r['cache_bytes']} B, {r['tok_s']:.1f} tok/s")
        full, partial, miss = b["prefix"]
        lines.append(
            f"[mesh] tier {name} {opts['mesh']} {_config(opts).arch_id}: "
            f"tokens, decode syncs "
            f"({b['syncs']}), ledger {tuple(b['ledger'])}, evictions "
            f"{b['evictions']}, restores {b['restores']}, prefix "
            f"{full}full+{partial}partial+{miss}miss, chunks "
            f"{b['prefill_chunks']} == the single device's on every rank; "
            + "; ".join(per_rank) + f"; the single device: restore ms "
            f"{_ms(b['restore_ms'])}, cache {b['cache_bytes']} B, "
            f"{b['tok_s']:.1f} tok/s ({b['graph_replays']} graph replays)")
    return lines


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: the smoke one)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the config's first N layers (default all)")
    ap.add_argument("--device", default=None,
                    help="torch device type (default cuda; 'cpu' to run "
                         "here)")
    ap.add_argument("--mesh", default="1x2", metavar="DATAxMODEL")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-lo", type=int, default=64)
    ap.add_argument("--prompt-hi", type=int, default=512)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--seg-len", type=int, default=8)
    ap.add_argument("--protocol", default="bs", choices=["bs", "axle", "rp"])
    ap.add_argument("--ring-seq", type=int, default=8192,
                    help="slots of the sequence-sharded schedules' cache "
                         "(0: skip them)")
    ap.add_argument("--threads", type=int, default=1,
                    help="torch threads a rank")
    ap.add_argument("--serves", default="plain",
                    help="comma-separated serves: " + ", ".join(SERVES))
    ap.add_argument("--offload", action="store_true",
                    help="the plain serve's host tier (as the serving CLI)")
    ap.add_argument("--evict-after", type=int, default=1,
                    help="segments a slot decodes before it may be evicted")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="the plain serve's prefix cache")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="the plain serve's chunked admission; the chunked "
                         "serve's chunk (default 256)")
    ap.add_argument("--long-prompt", type=int, default=900,
                    help="tokens of the chunked serve's long prompt")
    ap.add_argument("--json", default=None,
                    help="write both sides' reports here")
    args = ap.parse_args(argv)
    opts = {k.replace("-", "_"): v for k, v in vars(args).items()}
    opts["serves"] = opts["serves"].split(",")
    res = run(opts)
    for line in report_lines(res, opts):
        print(line, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh)
    return res


if __name__ == "__main__":
    main()
