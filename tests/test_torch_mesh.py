"""The port's mesh (`repro_torch.launch.mesh`, `sharding`,
`launch/partition`, the mesh schedules of `core/backstream`,
`BatchedServer(mesh=)`), on the CPU.

Part 1 runs in this process: the partition rules against the JAX
package's, and the mesh decode's producer, `ops.decode_attention_fused_
partial`, against the JAX function (f32, within 1e-6: both are the plain
version, one f32 summation apart), with the head-group identity the
serving mesh rests on held bitwise: per-group fused partials concatenated
and normalised ARE the fused decode.

Part 2 serves through gloo ranks started by `mesh.spawn` (one torch
thread a rank, as the single-device baselines here): one group a mesh
shape, each running every arch and check of its cell once, the results
memoised.  The JAX mesh path fails on this machine (ROADMAP.md queue 3),
so the mesh is held to the port's single-device server, BITWISE (tokens,
decode syncs, the page ledger), which the other port tests hold to the
JAX single-device server; the sequence-sharded schedules are held to the
JAX single-device `decode_attention_combined` in f32 within 1e-4 (AXLE
merges in ring order, an f32 re-association of the single device's)."""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_IDS, get_config,          # noqa: E402
                                 get_smoke_config)
from repro_torch.kernels import ops, ref                        # noqa: E402
from repro_torch.launch import mesh as mesh_lib                 # noqa: E402
from repro_torch.launch import partition                        # noqa: E402
from repro_torch.sharding import ShardingRules, Spec            # noqa: E402

SERVE_ARCHES = ["starcoder2_3b", "granite_moe_3b", "mamba2_370m",
                "mistral_nemo_12b"]
SHAPES = ["1x2", "1x4", "2x1", "2x2"]


class _Layout:
    """A mesh's shape alone, for planning without a process group."""

    def __init__(self, n_data, n_model):
        self.mesh_dim_names = ("data", "model")
        self.shape = (n_data, n_model)


def _plan(n_data, n_model, **rules):
    return partition.PartitionPlan(
        rules=ShardingRules(_Layout(n_data, n_model), **rules), fsdp=False)


# ===========================================================================
# Part 1: partition rules and the fused partial, in this process
# ===========================================================================

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_head_regime_matches_jax(arch):
    """(shard_q, shard_kv) of the port equal the JAX function's for the
    smoke and full configs at n = 1, 2, 4, 8 (the JAX function reads only
    plan.tp and plan.mesh.shape: it gets a stand-in plan)."""
    from repro.configs import get_config as jget, get_smoke_config as jsmoke
    from repro.launch import partition as jpartition
    for port_cfg, jax_cfg in ((get_smoke_config(arch), jsmoke(arch)),
                              (get_config(arch), jget(arch))):
        for n in (1, 2, 4, 8):
            jplan = types.SimpleNamespace(
                tp="model", mesh=types.SimpleNamespace(shape={"model": n}))
            want = jpartition.serve_head_regime(jax_cfg, jplan)
            got = partition.serve_head_regime(
                port_cfg, _plan(1, n, head_shard_attn=True))
            assert got == tuple(want), (arch, port_cfg.arch_id, n)


def test_head_regimes_of_the_served_archs():
    """The divisibility table of the reference's mesh test, and the full
    starcoder2_3b (H 24, KH 2) splitting its KV heads at n = 2."""
    def regime(cfg, n):
        return partition.serve_head_regime(
            cfg, _plan(1, n, head_shard_attn=True))
    sc = get_smoke_config
    assert regime(sc("starcoder2_3b"), 2) == (True, False)
    assert regime(sc("starcoder2_3b"), 4) == (True, False)
    assert regime(sc("mistral_nemo_12b"), 2) == (True, True)
    assert regime(sc("mistral_nemo_12b"), 4) == (False, False)
    assert regime(sc("granite_moe_3b"), 2) == (True, True)
    assert regime(sc("granite_moe_3b"), 4) == (False, False)
    assert regime(sc("mamba2_370m"), 2) == (False, False)
    assert regime(get_config("starcoder2_3b"), 2) == (True, True)
    assert regime(get_config("starcoder2_3b"), 4) == (False, False)
    assert regime(get_config("mistral_nemo_12b"), 4) == (True, True)


def test_page_split_guard():
    """A sequence split of a paged pool that would cut a page raises; one
    whose pages lie inside the shards shards the sequence axis."""
    plan = _plan(1, 4, seq_shard_attn=True)
    cfg = get_smoke_config("starcoder2_3b")
    meta = dict(device="meta")
    bad = {"k0": torch.empty(2, 2, 2, 64, 8, **meta),
           "v0": torch.empty(2, 2, 2, 64, 8, **meta),
           "page_table": torch.empty(2, 2, dtype=torch.int32, **meta)}
    with pytest.raises(ValueError, match="split a page"):
        partition.cache_specs(bad, cfg, plan)
    ok = dict(bad, page_table=torch.empty(2, 4, dtype=torch.int32, **meta))
    specs = partition.cache_specs(ok, cfg, plan)
    assert specs["k0"] == Spec(None, ("data",), None, "model", None)
    assert specs["page_table"] == Spec(("data",), None)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "jamba_1_5_large"])
def test_serve_specs_replicate_all_but_the_batch(arch):
    """The serving specs: every parameter replicated, no cache leaf on the
    model axis, the cache rows over the data axis."""
    from repro_torch.models.registry import get_model
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    plan = _plan(2, 2, head_shard_attn=True)

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    pspecs = list(leaves(partition.serve_param_specs(params, cfg, plan)))
    assert pspecs and all(s == Spec() for s in pspecs)
    cache = model.init_cache(cfg, 4, 64, device=torch.device("cpu"))
    cspecs = partition.serve_cache_specs(cache, cfg, plan)
    for key, spec in cspecs.items():
        assert "model" not in [a for a in spec if isinstance(a, str)], key
        if key != "pos" and cache[key].dim() > 1 and key != "page_table":
            assert spec[1] == ("data",), (key, spec)


def test_local_shard_takes_the_ranks_slice():
    full = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    layout = _Layout(2, 2)
    spec = Spec(("data",), None, "model")
    for d in range(2):
        for m in range(2):
            got = partition.local_shard(full, spec, layout,
                                        coords={"data": d, "model": m})
            assert torch.equal(got, full[2 * d:2 * d + 2, :,
                                         4 * m:4 * m + 4])
    with pytest.raises(ValueError):
        partition.local_shard(full[:, :5], Spec(None, "model"), layout,
                              coords={"data": 0, "model": 0})


def test_rules_refuse_both_attention_layouts():
    with pytest.raises(AssertionError):
        ShardingRules(_Layout(1, 2), head_shard_attn=True,
                      seq_shard_attn=True)
    rules = ShardingRules(_Layout(2, 4), head_shard_attn=True)
    assert (rules.batch_axes, rules.model_axis, rules.model_size(),
            rules.data_size()) == (("data",), "model", 4, 2)


# --------------------------------------------------- the fused partial

B, S, HD, PAGE = 2, 48, 16, 16
POS = np.array([0, 37], np.int32)


def _inputs(rng, h, kh, dtype="float32", hd=HD):
    """q, k, v, the current token's extra partial, and a permuted page
    table, as numpy."""
    q = rng.standard_normal((B, 1, h, hd)).astype(np.float32)
    k = rng.standard_normal((B, kh, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, kh, S, hd)).astype(np.float32)
    extra = (rng.standard_normal((B, h, hd)).astype(np.float32),
             rng.standard_normal((B, h)).astype(np.float32),
             rng.uniform(0.5, 2.0, (B, h)).astype(np.float32))
    table = np.stack([rng.permutation(S // PAGE)
                      for _ in range(B)]).astype(np.int32)
    return q, k, v, extra, table


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


FEATURES = {
    "dense": dict(),
    "paged": dict(paged=True),
    "int8": dict(int8=True),
    "window": dict(window=7, paged=True),
    "extra": dict(extra=True, paged=True, int8=True, window=20),
}


def _case(rng, h, kh, feats, dtype=torch.float32):
    """The port's arguments (and the same numbers for JAX) of one case."""
    q, k, v, extra, table = _inputs(rng, h, kh)
    scales = None
    if feats.get("int8"):
        k8, ks = ref.quantize_kv_pages(_torch(k), PAGE)
        v8, vs = ref.quantize_kv_pages(_torch(v), PAGE)
        k, v, scales = k8.numpy(), v8.numpy(), (ks.numpy(), vs.numpy())
    pages = table if feats.get("paged") else None
    return dict(q=q, k=k, v=v, extra=extra if feats.get("extra") else None,
                pages=pages, scales=scales, window=feats.get("window", 0),
                dtype=dtype)


def _port_call(fn, c, heads=None, kvs=None):
    """fn (ops.decode_attention_fused or _partial) on case c, on the query
    heads `heads` and KV heads `kvs` (slices; None: all)."""
    heads = heads or slice(None)
    kvs = kvs or slice(None)
    q = _torch(c["q"][:, :, heads], c["dtype"])
    kdt = torch.int8 if c["scales"] is not None else c["dtype"]
    k = _torch(np.ascontiguousarray(c["k"][:, kvs]), kdt)
    v = _torch(np.ascontiguousarray(c["v"][:, kvs]), kdt)
    extra = (None if c["extra"] is None else
             tuple(_torch(np.ascontiguousarray(t[:, heads]))
                   for t in c["extra"]))
    scales = (None if c["scales"] is None else
              tuple(_torch(np.ascontiguousarray(s[:, kvs]))
                    for s in c["scales"]))
    pages = None if c["pages"] is None else _torch(c["pages"], torch.int32)
    return fn(q, k, v, _torch(POS, torch.int32), extra, pages, scales,
              window=c["window"], blk_c=PAGE)


@pytest.mark.parametrize("feature", list(FEATURES))
def test_fused_partial_matches_jax(feature):
    """ops.decode_attention_fused_partial against the JAX
    ops.decode_attention_fused_partial on the CPU, f32, within 1e-6."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    c = _case(np.random.default_rng(11), 8, 2, FEATURES[feature])
    got = _port_call(ops.decode_attention_fused_partial, c)
    j = lambda x: None if x is None else jnp.asarray(x)    # noqa: E731
    want = jops.decode_attention_fused_partial(
        j(c["q"]), j(c["k"]), j(c["v"]), j(POS),
        None if c["extra"] is None else tuple(map(j, c["extra"])),
        j(c["pages"]),
        None if c["scales"] is None else tuple(map(j, c["scales"])),
        window=c["window"], blk_c=PAGE)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    # normalised, the raw statistics are the fused decode
    full = _port_call(ops.decode_attention_fused, c)
    assert torch.equal(ref.normalize_fused_partial(got[0], got[2],
                                                   full.dtype), full)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("regime", ["kv_heads", "q_only"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_groups_concatenate_to_the_fused_decode(n, regime, dtype):
    """The identity of the serving mesh: for every feature mix, each of
    n head groups' fused partial (the KV heads split with them when
    n | KH; with KH == 1 only q), concatenated along the head axis and
    normalised, is `decode_attention_fused` BITWISE."""
    h, kh = (8, 4) if regime == "kv_heads" else (8, 1)
    for name, feats in FEATURES.items():
        c = _case(np.random.default_rng(n * 31 + len(name)), h, kh, feats,
                  dtype)
        full = _port_call(ops.decode_attention_fused, c)
        hl, khl = h // n, kh // n
        accs, ls = [], []
        for r in range(n):
            kvs = slice(r * khl, (r + 1) * khl) if regime == "kv_heads" \
                else None
            acc, _, l = _port_call(ops.decode_attention_fused_partial, c,
                                   heads=slice(r * hl, (r + 1) * hl),
                                   kvs=kvs)
            accs.append(acc)
            ls.append(l)
        got = ref.normalize_fused_partial(torch.cat(accs, 1),
                                          torch.cat(ls, 1), dtype)
        assert got.dtype == full.dtype and torch.equal(got, full), name


# ===========================================================================
# Part 2: served through gloo ranks
# ===========================================================================

def _workload(vocab, n=6, seed=7, prompts="", new=(2, 9)):
    """The reference mesh test's workload: greedy, fixed-seed sampled, and
    sampled with a stop token, in turn.  `prompts` "prefix": every third
    request from the second on repeats the first prompt (a full hit),
    every third from the third on extends it by 4 tokens (a partial hit);
    "long": a 21-token prompt second in the queue (6 chunks of 4).
    Budgets are drawn from [new[0], new[1])."""
    from repro_torch.launch.serve import Request, SamplingParams
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(1, min(vocab, 512),
                              rng.integers(3, 9)).astype(np.int32)
        max_new = int(rng.integers(*new))
        kind = i % 3
        if kind == 0:
            sampling = None
        elif kind == 1:
            sampling = SamplingParams(temperature=0.9, top_p=0.85,
                                      seed=100 + i)
        else:
            sampling = SamplingParams(
                temperature=1.1, top_k=16, seed=200 + i,
                stop_tokens=(int(rng.integers(vocab)),))
        if prompts == "prefix" and i % 3 and reqs:
            first = reqs[0].prompt
            prompt = first if i % 3 == 1 else np.concatenate(
                [first, rng.integers(1, min(vocab, 512), 4).astype(
                    np.int32)])
        if prompts == "long" and i == 1:
            prompt = rng.integers(1, min(vocab, 512), 21).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=max_new,
                            sampling=sampling))
    return reqs


def _serve(arch, mesh=None, slots=2, requests=6, prompts="", new=(2, 9),
           **kw):
    """Serve the workload; what the checks compare."""
    from repro_torch.core import backstream
    from repro_torch.launch.serve import BatchedServer
    backstream.WIRE.reset()
    kw = dict(dict(protocol="bs"), **kw)
    server = BatchedServer(arch, smoke=True, device="cpu",
                           batch_slots=slots, max_seq=64, stream=True,
                           seg_len=4, mesh=mesh, **kw)
    kinds = {}
    reqs = _workload(server.cfg.vocab, requests, prompts=prompts, new=new)
    for req in reqs:
        kinds[req.rid] = 0 if req.sampling is None else 1
        server.submit(req)
    server.run_until_drained(max_steps=100_000)
    assert not server.queue and all(r is None for r in server.active)
    assert not server.suspended and not server.prefilling
    w = server.wire
    tier = server.host_tier
    entry = (server.prefix.lookup(reqs[0].prompt)
             if server.prefix is not None else None)
    return dict(
        tokens={r.rid: list(map(int, r.generated))
                for r in server.completed},
        kinds=kinds, syncs=server.decode_syncs,
        wire=int(server.wire_bytes_per_shard),
        wire_model=(w.n_shards, w.rows_local, w.heads_local, w.head_dim,
                    w.merges),
        gathers=backstream.WIRE.gathers,
        bytes_sent=backstream.WIRE.bytes_sent,
        pages_allocated=server.pages_allocated,
        pages_freed=server.pages_freed,
        evictions=server.evictions, restores=server.restores,
        prefix=(server.prefix_hits_full, server.prefix_hits_partial,
                server.prefix_misses),
        prefill_chunks=server.prefill_chunks,
        tier_moves=server.tier_moves,
        tier_bytes_moved=server.tier_bytes_moved,
        restores_moved=server.restores_moved,
        # the bytes of one eviction's snapshot (every one is a whole row)
        # and of the first prompt's prefix entry (every hit's)
        evicted_bytes=tier.bytes_evicted // max(1, server.evictions)
        if tier is not None else 0,
        entry_bytes=entry.pages.nbytes if entry is not None else 0)


# the sequence-sharded schedules: benchmarks/tpu_backstream.py's shapes
# (B 4, H = KH 8, hd 64) with S cut to 512; row 3's clock lies in the
# first span, so at n = 4 three spans of it are empty
RB, RH, RHD, RS = 4, 8, 64, 512
RPOS = np.array([511, 300, 100, 7], np.int32)
RING_CASES = {"full": 0, "window": 200}


def _ring_inputs():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((RB, 1, RH, RHD)).astype(np.float32)
    k = rng.standard_normal((RB, RH, RS, RHD)).astype(np.float32)
    v = rng.standard_normal((RB, RH, RS, RHD)).astype(np.float32)
    extra = (rng.standard_normal((RB, RH, RHD)).astype(np.float32),
             rng.standard_normal((RB, RH)).astype(np.float32),
             np.ones((RB, RH), np.float32))
    return q, k, v, extra


def _ring_job(mesh):
    """Every protocol and case over this rank's span of the sequence, with
    the transport's counts a call, and the sharded cache write; every
    rank's outputs gathered to rank 0."""
    import torch.distributed as dist
    from repro_torch.core import backstream as bs
    from repro_torch.sharding import use_rules
    rules = ShardingRules(mesh, seq_shard_attn=True)
    n, r = rules.model_size(), rules.rank("model")
    span = slice(r * RS // n, (r + 1) * RS // n)
    arrays = _ring_inputs()
    q, k, v = (_torch(x) for x in arrays[:3])
    extra = tuple(_torch(x) for x in arrays[3])
    k_l, v_l = k[:, :, span].contiguous(), v[:, :, span].contiguous()
    pos = _torch(RPOS, torch.int32)
    out = {}
    with use_rules(rules):
        for proto in ("bs", "axle", "rp"):
            cfg = bs.OffloadConfig(protocol=bs.OffloadProtocol(proto))
            for case, window in RING_CASES.items():
                bs.WIRE.reset()
                with bs.use_offload(cfg):
                    o = bs.decode_attention_combined(
                        q, k_l, v_l, pos, window=window, extra=extra)
                out[proto, case] = (o.numpy(), bs.WIRE.gathers,
                                    bs.WIRE.hops, bs.WIRE.broadcasts)
        cache = torch.zeros(RB, 2, RS // n, 4)
        new = torch.arange(RB * 2 * 4, dtype=torch.float32).reshape(
            RB, 2, 1, 4) + 1
        bs.cache_update_sharded(cache, new, pos)
        out["cache"] = cache.numpy()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def _build_job(mesh):
    """Servers with the host tier and the prefix cache, and with the host
    tier and chunked admission, built on this data split: each rank's
    rows and data rank, its features, and the row count its segments'
    products are padded to."""
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import quantize
    out = []
    for kw in (dict(host_offload=True, prefix_cache=True),
               dict(host_offload=True, prefill_chunk=4)):
        server = BatchedServer("starcoder2_3b", smoke=True, device="cpu",
                               batch_slots=4, max_seq=64, mesh=mesh, **kw)
        with server.segment_scope():
            pad = quantize._PAD_ROWS.get()
        out.append((server.rows_local, server.row0, server.data_rank,
                    server.host_tier is not None, server.prefix is not None,
                    server.prefill_chunk, pad))
    return out


def _cell_main(mesh, device, jobs):
    """One mesh shape's cell: the serves, then the ring job if asked."""
    out = {}
    for key, arch, kw in jobs:
        out[key] = (_ring_job(mesh) if arch == "ring" else
                    _build_job(mesh) if arch == "build" else
                    _serve(arch, mesh, **kw))
    return out


SPEC = dict(spec=True, spec_k=2)
# 4 slots, 6 requests of 6-19 tokens, evicted after one segment: under
# a data split most restores land in the other group's slots (a spec
# round emits up to 3 tokens: its requests take 12-24, so that rows live
# through their restores)
CHURN = dict(host_offload=True, evict_after=1, slots=4, requests=6,
             new=(6, 20))
SPEC_CHURN = dict(SPEC, **dict(CHURN, new=(12, 25)))
RP = dict(protocol="rp")
PREFIX = dict(prefix_cache=True, requests=8, prompts="prefix")
CHUNKED = dict(prefill_chunk=4, prompts="long")
# the single-device twin of each job key
_KW = {"": {}, "spec": SPEC, "churn": CHURN, "rp": RP,
       "spec_churn": SPEC_CHURN, "prefix": PREFIX,
       "chunked": CHUNKED}
_JOBS = {
    "1x2": [(a, a, {}) for a in SERVE_ARCHES]
    + [("spec", "starcoder2_3b", SPEC), ("churn", "starcoder2_3b", CHURN),
       ("rp", "starcoder2_3b", RP), ("encdec", "whisper_large_v3", {}),
       ("ring", "ring", {})],
    "1x4": [(a, a, {}) for a in SERVE_ARCHES] + [("ring", "ring", {})],
    "2x1": [(a, a, {}) for a in SERVE_ARCHES]
    + [("churn", "starcoder2_3b", CHURN),
       ("churn_mamba", "mamba2_370m", CHURN),
       ("prefix", "starcoder2_3b", PREFIX),
       ("chunked", "starcoder2_3b", CHUNKED),
       ("build", "build", {})],
    "2x2": [(a, a, {}) for a in SERVE_ARCHES]
    + [("spec", "starcoder2_3b", SPEC), ("churn", "starcoder2_3b", CHURN),
       ("spec_churn", "starcoder2_3b", SPEC_CHURN),
       ("chunked", "starcoder2_3b", CHUNKED)],
}


@functools.lru_cache(maxsize=None)
def _cell(shape):
    n_data, n_model = mesh_lib.parse_mesh(shape)
    return mesh_lib.spawn(_cell_main, n_data, n_model, device="cpu",
                          args=(_JOBS[shape],), timeout=600)


@functools.lru_cache(maxsize=None)
def _base(arch, key=""):
    """The single-device serve, at the ranks' one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _serve(arch, **_KW[key])
    finally:
        torch.set_num_threads(threads)


def _assert_bitwise(base, run):
    assert run["tokens"] == base["tokens"]
    assert run["syncs"] == base["syncs"]
    assert run["pages_allocated"] == base["pages_allocated"]
    assert run["pages_freed"] == base["pages_freed"]
    for key in ("evictions", "restores", "prefix", "prefill_chunks"):
        assert run[key] == base[key], key


@pytest.mark.parametrize("arch", SERVE_ARCHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_serve_is_bitwise_the_single_device(shape, arch):
    """Streamed tokens (greedy, sampled, stop-token rows through slot
    recycling), decode syncs and the page ledger at every mesh shape are
    the single-device server's, bit for bit; the ledger closes."""
    base, run = _base(arch), _cell(shape)[arch]
    _assert_bitwise(base, run)
    assert sum(k != 0 for k in run["kinds"].values()) >= 3
    assert run["pages_allocated"] == run["pages_freed"] > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_wire_is_the_formula_times_the_merges(shape):
    """wire_bytes_per_shard = merges x merge_wire_bytes_per_shard, and
    it is what the transport really sent: one gather a merge."""
    from repro_torch.core import ring
    for arch in SERVE_ARCHES:
        run = _cell(shape)[arch]
        n, rows, heads, hd, merges = run["wire_model"]
        assert run["wire"] == merges * ring.merge_wire_bytes_per_shard(
            n, rows, heads, hd)
        assert run["bytes_sent"] == run["wire"]
        assert run["gathers"] == (merges if n > 1 else 0)
    assert _base("starcoder2_3b")["wire"] == 0


def test_wire_scaling_and_the_replicated_regimes():
    """1x4 moves more than 1x2 (smaller groups, more peers), 2x2 half of
    1x2 (half the rows); granite (KH 2, H 6) and mistral (KH 2) at 1x4
    and the pure SSM mamba2 anywhere replicate: zero wire."""
    m12, m14, m22 = _cell("1x2"), _cell("1x4"), _cell("2x2")
    assert m14["starcoder2_3b"]["wire"] > m12["starcoder2_3b"]["wire"] > 0
    assert m22["starcoder2_3b"]["wire"] * 2 == m12["starcoder2_3b"]["wire"]
    assert m14["granite_moe_3b"]["wire"] == 0
    assert m14["mistral_nemo_12b"]["wire"] == 0
    for cell in (m12, m14, m22, _cell("2x1")):
        assert cell["mamba2_370m"]["wire"] == 0
    assert _cell("2x1")["starcoder2_3b"]["wire"] == 0


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_spec_serve_is_bitwise_on_the_mesh(shape):
    """Speculative serving (self-draft, spec_k 2): the same tokens, syncs
    and ledger, and the wire charges (k + 1) merges an attention
    sublayer a round (the draft's attention stays whole)."""
    run = _cell(shape)["spec"]
    _assert_bitwise(_base("starcoder2_3b", "spec"), run)
    assert run["wire"] > 0 and run["bytes_sent"] == run["wire"]
    assert run["gathers"] == run["wire_model"][-1]


def _assert_moved(run, per_move):
    """Snapshots crossed data groups, and the bytes counted are theirs."""
    assert run["tier_moves"] > 0
    assert run["tier_bytes_moved"] == run["tier_moves"] * per_move > 0


@pytest.mark.parametrize("shape, arch, key", [
    ("1x2", "starcoder2_3b", "churn"), ("2x1", "starcoder2_3b", "churn"),
    ("2x2", "starcoder2_3b", "churn"), ("2x1", "mamba2_370m", "churn_mamba"),
    ("2x2", "starcoder2_3b", "spec_churn")])
def test_host_tier_churn_is_bitwise_on_the_mesh(shape, arch, key):
    """Evictions to the host tier and restores (4 slots, 6 requests,
    evicted after a segment): the same tokens, syncs, ledger and tier
    counts as the single device, and the churn really happened on both
    sides.  Under a data split a restore into the other group's slot
    moves the snapshot (every one a whole row's bytes: mamba2's
    recurrent states; under speculation the draft's row with the
    target's); on one data group nothing moves."""
    base = _base(arch, "churn" if key == "churn_mamba" else key)
    run = _cell(shape)[key]
    _assert_bitwise(base, run)
    assert run["evictions"] == base["evictions"] > 0
    assert run["restores"] == base["restores"] > 0
    assert base["tier_moves"] == 0
    if shape.startswith("1x"):
        assert run["tier_moves"] == 0
    else:
        _assert_moved(run, base["evicted_bytes"])
        assert 0 < run["restores_moved"] <= run["tier_moves"]


def test_prefix_serve_is_bitwise_on_the_mesh():
    """The prefix cache at 2x1: repeated and extended prompts give full
    and partial hits, bitwise the single device's (tokens, syncs, ledger,
    hit counts); a hit lands in the other group's slot and moves the
    first prompt's entry there."""
    base, run = _base("starcoder2_3b", "prefix"), _cell("2x1")["prefix"]
    _assert_bitwise(base, run)
    full, partial, miss = run["prefix"]
    assert full >= 1 and partial >= 1 and miss >= 1
    assert run["entry_bytes"] == base["entry_bytes"]
    _assert_moved(run, base["entry_bytes"])


@pytest.mark.parametrize("shape", ["2x1", "2x2"])
def test_chunked_serve_is_bitwise_on_the_mesh(shape):
    """Chunked admission (chunks of 4; a 21-token prompt in 6 beside the
    streams in flight): each chunk runs on the slot's data group alone,
    the last chunk's logits go to every rank, and tokens, syncs, ledger
    and chunk count are the single device's."""
    base, run = _base("starcoder2_3b", "chunked"), _cell(shape)["chunked"]
    _assert_bitwise(base, run)
    assert run["prefill_chunks"] == base["prefill_chunks"] >= 6


def test_rp_and_encdec_serves_are_bitwise_on_the_mesh():
    """Under rp each head group runs the chunked schedule (one partial a
    chunk, merged raw) before the gather; whisper's decoder gathers its
    cross reads too (two merges a layer and step): both bitwise the
    single device, and the ledger charged every gather."""
    cell = _cell("1x2")
    for key, arch, base_key in (("rp", "starcoder2_3b", "rp"),
                                ("encdec", "whisper_large_v3", "")):
        run = cell[key]
        _assert_bitwise(_base(arch, base_key), run)
        assert run["gathers"] == run["wire_model"][-1] > 0
        assert run["bytes_sent"] == run["wire"]


def test_data_split_builds_the_host_tier():
    """A 2x1 layout builds with the host tier and the prefix cache, and
    with the host tier and chunked admission: each rank holds its half
    of the 4 slots, and its segments pad their products to all 4 rows."""
    built = _cell("2x1")["build"]
    assert built == [(2, 0, 0, True, True, None, 4),
                     (2, 0, 0, True, False, 4, 4)]


def test_nested_padded_rows_keep_the_larger_count():
    """A data split's segment pads to the batch's rows; a speculative
    draft's own `padded_rows` inside it keeps the larger count."""
    from repro_torch.models.quantize import invariant_rows, padded_rows
    x = torch.ones(2, 3)
    with padded_rows(8):
        with padded_rows(6):
            inner = invariant_rows(x)[0].shape[0]
        outer = invariant_rows(x)[0].shape[0]
    with padded_rows(4):
        with padded_rows(6):
            wider = invariant_rows(x)[0].shape[0]
    assert (inner, outer, wider, invariant_rows(x)[0].shape[0]) == \
        (8, 8, 6, 2)


class _SplitLayout(_Layout):
    """A 2x1 mesh's shape and rank 0's coordinates, without a group."""

    def __init__(self):
        super().__init__(2, 1)

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("arch, kw, match", [
    ("starcoder2_3b", dict(prefix_cache=True, spec=True), "spec"),
    ("starcoder2_3b", dict(prefill_chunk=4, prefix_cache=True),
     "prefix_cache"),
    ("starcoder2_3b", dict(prefill_chunk=4, spec=True), "spec"),
    ("whisper_large_v3", dict(prefix_cache=True), "encoder-decoder"),
    ("whisper_large_v3", dict(prefill_chunk=4), "encoder-decoder")])
def test_data_split_keeps_the_reference_refusals(arch, kw, match):
    """The reference's own refusals raise under a data split as off it."""
    from repro_torch.launch.serve import BatchedServer
    with pytest.raises(ValueError, match=match):
        BatchedServer(arch, device="cpu", batch_slots=2, max_seq=64,
                      mesh=_SplitLayout(), **kw)


def _stub_twin(cache_bytes, sizes, order):
    """Two PrefixCaches of `cache_bytes`: one holding every entry's bytes,
    one holding stubs of the same sizes; the same puts and lookups in
    `order` on both.  Their keys, byte counts and evictions after each."""
    from repro_torch.core.backstream import (HostSnapshot, PrefixCache,
                                             SnapshotStub, snapshot_layout)
    caches = [PrefixCache(capacity_bytes=cache_bytes) for _ in range(2)]
    seen = [[], []]
    for op, key in order:
        if op == "put":
            leaves = {"k": torch.zeros(sizes[key], dtype=torch.bfloat16),
                      "logits": torch.zeros(7)}
            snaps = [HostSnapshot(leaves, holder=1),
                     SnapshotStub(snapshot_layout(leaves), 1)]
        for i, cache in enumerate(caches):
            if op == "put":
                cache.put(key, snaps[i])
            else:
                hit = cache.lookup(key)
                seen[i].append(None if hit is None else
                               (hit.tokens, hit.pages.nbytes,
                                hit.pages.holder))
            seen[i].append((list(cache._lru), cache.bytes_stored,
                            cache.entries_evicted))
    return seen


@pytest.mark.parametrize("cache_bytes", [0, 50, 100, 150, 250, None])
def test_prefix_stubs_evict_the_holders_keys(cache_bytes):
    """A rank that keeps only stubs evicts the same keys at the same puts
    as the rank that holds the bytes, and looks up the same entries, for
    a capacity below one entry, between one and all, and none."""
    sizes = {(1, 2): 8, (1, 2, 3): 20, (4,): 3, (1,): 30, (4, 5, 6): 12}
    order = [("put", (1, 2)), ("put", (4,)), ("get", (1, 2, 3, 9)),
             ("put", (1, 2, 3)), ("put", (1,)), ("get", (4, 5)),
             ("put", (4, 5, 6)), ("get", (1, 2, 3)), ("put", (1, 2)),
             ("get", (4, 5, 6, 7))]
    holder, stub = _stub_twin(cache_bytes, sizes, order)
    assert holder == stub
    assert holder[-1][2] == 0 if cache_bytes is None else \
        holder[-1][2] > 0


@functools.lru_cache(maxsize=None)
def _jax_ring(case):
    import jax.numpy as jnp
    from repro.core import backstream as jbs
    q, k, v, extra = _ring_inputs()
    with jbs.use_offload(jbs.OffloadConfig(protocol=jbs.OffloadProtocol.BS)):
        out = jbs.decode_attention_combined(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(RPOS), window=RING_CASES[case],
            extra=tuple(map(jnp.asarray, extra)))
    return np.asarray(out)


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("proto", ["bs", "axle", "rp"])
@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_sequence_sharded_schedules_match_jax(shape, proto, case):
    """Every rank's output of BS, AXLE and RP over the sequence-sharded
    cache within 1e-4 of the JAX single-device decode (f32); AXLE took
    n - 1 point-to-point hops, BS one gather, RP n broadcasts."""
    n = int(shape[-1])
    want = _jax_ring(case)
    for rank_out in _cell(shape)["ring"]:
        got, gathers, hops, broadcasts = rank_out[proto, case]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert (gathers, hops, broadcasts) == {
            "bs": (1, 0, 0), "axle": (0, n - 1, 0), "rp": (0, 0, n)}[proto]


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_bs_and_rp_are_the_single_device_chunked_merge(shape):
    """BS and RP merge the same partials in sequence order: bitwise the
    single device's chunked schedule over n chunks, on every rank."""
    from repro_torch.core import backstream as bs
    n = int(shape[-1])
    q, k, v, extra = _ring_inputs()
    for case, window in RING_CASES.items():
        with bs.use_offload(bs.OffloadConfig(
                protocol=bs.OffloadProtocol.RP, chunks_per_shard=n)):
            want = bs.decode_attention_combined(
                _torch(q), _torch(k), _torch(v), _torch(RPOS, torch.int32),
                window=window, extra=tuple(map(_torch, extra))).numpy()
        for rank_out in _cell(shape)["ring"]:
            assert np.array_equal(rank_out["bs", case][0], want)
            assert np.array_equal(rank_out["rp", case][0], want)


@pytest.mark.parametrize("shape", ["1x2", "1x4"])
def test_cache_update_sharded_writes_the_owner_span(shape):
    """The ranks' spans after a per-row sharded write, joined, are the
    one-device write at the same slots."""
    n = int(shape[-1])
    spans = [rank_out["cache"] for rank_out in _cell(shape)["ring"]]
    got = np.concatenate(spans, axis=2)
    want = np.zeros((RB, 2, RS, 4), np.float32)
    new = np.arange(RB * 2 * 4, dtype=np.float32).reshape(RB, 2, 4) + 1
    for b in range(RB):
        want[b, :, RPOS[b]] = new[b]
    assert len(spans) == n and np.array_equal(got, want)


_EXAMPLE = dict(arch="starcoder2_3b", full=False, layers=None, device="cpu",
                requests=4, max_new=6, prompt_lo=4, prompt_hi=20, slots=4,
                max_seq=64, seg_len=4, protocol="bs", threads=1, json=None,
                offload=False, evict_after=1, prefix_cache=False,
                prefill_chunk=None, long_prompt=40)


def test_mesh_serve_example_on_the_cpu():
    """`examples/mesh_serve.py` (chip_smoke.py's [mesh] phase at full
    width on the card) at smoke size: the single-device serve, a 1x2
    group's, bitwise on every rank, the wire as the ledger's formula, the
    fused partial launched nowhere on the CPU (the plain version runs),
    and the sequence-sharded schedules within tolerance of the fused
    decode, AXLE in one hop."""
    from repro_torch.examples import mesh_serve
    opts = dict(_EXAMPLE, mesh="1x2", serves=["plain"], ring_seq=256)
    res = mesh_serve.run(opts)
    base, ranks = res["base"], res["ranks"]
    assert len(ranks) == 2
    for rep in ranks:
        assert (rep["tokens"], rep["syncs"], rep["ledger"]) == \
            (base["tokens"], base["syncs"], base["ledger"])
        wm = rep["wire_model"]
        assert rep["wire"] == wm["merges"] * wm["bytes_per_merge"] > 0
        assert rep["merges_per_step"] == 2
        assert rep["launches"]["decode_attention_fused_partial"] == 0
        ring = rep["ring"]
        assert set(ring) == {f"{p}/{d}" for p in ("bs", "axle", "rp")
                             for d in ("bfloat16", "float32")}
        assert all(row["err"] <= row["atol"] for row in ring.values())
        assert len(ring["axle/float32"]["hop_ms"]) == 1
    lines = mesh_serve.report_lines(res, opts)
    assert [ln.split()[1] for ln in lines] == ["serve", "step:", "ring"]


def test_mesh_serve_example_tier_serves_on_the_cpu():
    """The example's churn, prefix and chunked serves (chip_smoke.py's
    [mesh] tier phase at full width on the card) at smoke size on a 2x1
    group: every serve's tokens, syncs, ledger and tier counts equal the
    single device's on both ranks (the example raises otherwise); the
    churn and prefix serves move snapshots between the groups, the
    same count on both ranks; each rank holds half the single device's
    cache rows; the chunked serve admits its 40-token prompt in 5 chunks of
    8."""
    from repro_torch.examples import mesh_serve
    opts = dict(_EXAMPLE, mesh="2x1", serves=["churn", "prefix", "chunked"],
                prefill_chunk=8, max_new=12, ring_seq=0)
    res = mesh_serve.run(opts)
    base, ranks = res["base"]["serves"], res["ranks"]
    assert len(ranks) == 2
    assert base["churn"]["evictions"] > 0
    full, partial, _ = base["prefix"]["prefix"]
    assert full >= 2 and partial >= 1
    assert base["chunked"]["prefill_chunks"] >= 5
    for name in ("churn", "prefix"):
        moves = {rep["serves"][name]["tier_moves"] for rep in ranks}
        assert len(moves) == 1 and moves.pop() > 0, name
    for rep in ranks:
        for name in opts["serves"]:
            srv = rep["serves"][name]
            # the slot rows split; the scalar int32 clock does not
            assert 2 * srv["cache_bytes"] - base[name]["cache_bytes"] == 4
            assert srv["launches"]["decode_attention_fused"] == 0
    lines = mesh_serve.report_lines(res, opts)
    assert [ln.split()[2] for ln in lines] == opts["serves"]
