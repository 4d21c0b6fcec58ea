"""The dry-run and the roofline of the port against the JAX package: the
benchmark shapes, the abstract trees, the model-FLOPs estimate, the cost
counter against `hlo_cost` and torch's `FlopCounterMode`, the kernels'
meta routes and formulas, `knn_topk`, the sequence-sharded decode on a
gloo mesh, and production-mesh cells in a process of their own.

Tolerances: shapes, dtypes, specs, skip reasons and `model_flops_estimate`
exactly; product FLOPs against `hlo_cost.analyze_text` of the reference's
jitted step within 2%; the sequence-sharded decode within 1e-5 (f32) of
the single device's.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import knn as jknn
from repro.launch import steps as jsteps
from repro.models.registry import get_model as jget_model
from repro.optim import adamw as jadamw
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_cost
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, partition
from repro_torch.launch import steps
from repro_torch.models.registry import get_model
from repro_torch.roofline import analysis, cost
from repro_torch.sharding import ShardingRules

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
F32 = torch.float32


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _flat_torch(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
    for k, v in items:
        out.update(_flat_torch(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _nbytes(flat):
    size = {"bfloat16": 2, "float32": 4, "int32": 4, "int8": 1}
    return sum(math.prod(s) * size[d] for s, d in flat.values())


# --------------------------------------------------------------------------
# Shapes, abstract trees, model FLOPs
# --------------------------------------------------------------------------

def test_shapes_and_input_specs_equal_the_reference():
    assert configs.SHAPES == jconfigs.SHAPES
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for shape in configs.SHAPES:
            assert configs.shape_supported(cfg, shape) == \
                jconfigs.shape_supported(jcfg, shape), (arch, shape)
            got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for k, v in configs.input_specs(cfg, shape).items()}
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in jconfigs.input_specs(jcfg, shape).items()}
            assert got == want, (arch, shape)
            assert all(v.is_meta
                       for v in configs.input_specs(cfg, shape).values())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_trees_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    params = model.abstract_params(cfg)
    assert all(t.is_meta for t in _leaves(params))
    got, want = _flat_torch(params), _flat_jax(jmodel.abstract_params(jcfg))
    assert got == want
    assert _nbytes(got) == _nbytes(want)
    got = _flat_torch(model.abstract_cache(cfg, 8, 2048))
    want = _flat_jax(jmodel.abstract_cache(jcfg, 8, 2048))
    assert got == want
    assert _nbytes(got) == _nbytes(want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_model_flops_estimate_equals_the_reference():
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for shape, (seq, batch, kind) in configs.SHAPES.items():
            assert analysis.model_flops_estimate(cfg, shape, seq, batch,
                                                 kind) == \
                janalysis.model_flops_estimate(jcfg, shape, seq, batch,
                                               kind), (arch, shape)


def test_specs_cover_every_leaf():
    """The reference's coverage test (`tests/test_dryrun.py`) over the
    port's serving specs: one spec a leaf, one entry a dim."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(16, 16))
    for arch in ("phi3_5_moe_42b", "jamba_1_5_large", "whisper_large_v3"):
        cfg = configs.get_config(arch)
        model = get_model(cfg)
        plan = partition.PartitionPlan(
            rules=ShardingRules(mesh, seq_shard_attn=True), fsdp=True)
        ab = model.abstract_params(cfg)
        specs = partition.serve_param_specs(ab, cfg, plan)
        flat_p, flat_s = _leaves(ab), _leaves_specs(specs)
        assert len(flat_p) == len(flat_s)
        for p, s in zip(flat_p, flat_s):
            assert isinstance(s, partition.Spec) and len(s) <= p.dim()
        cache = model.abstract_cache(cfg, 128, 32768)
        c_specs = partition.cache_specs(cache, cfg, plan)
        assert set(c_specs) == set(cache)
        for k, leaf in cache.items():
            assert isinstance(c_specs[k], partition.Spec)
            assert len(c_specs[k]) == leaf.dim() or (
                k == "pos" and len(c_specs[k]) == 0), (arch, k)


def _leaves_specs(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_specs(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_specs(v)]
    return [tree]


# --------------------------------------------------------------------------
# The counter
# --------------------------------------------------------------------------

def test_counter_counts_every_loop_iteration():
    """The reference's scan test: eager PyTorch runs the 10 iterations, so
    their products count 10 times, exactly."""
    x, w = torch.randn(128, 128), torch.randn(128, 128)

    def f(c, w):
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    counter, _ = dryrun.count_step(f, (x, w))
    assert counter.flops == 2 * 128 ** 3 * 10
    assert counter.coll_bytes == 0


def test_counter_fusion_memory_model():
    """A bf16 -> f32 tanh chain fuses into the product, which reads the
    bf16 source and the f32 weight and writes its f32 result."""
    x = torch.randn(256, 256).to(torch.bfloat16)
    w = torch.randn(256, 256)

    def f(x, w):
        y = torch.tanh(x.float()) * 2.0 + 1.0
        return y @ w

    counter, _ = dryrun.count_step(f, (x, w))
    assert counter.flops == 2 * 256 ** 3
    assert counter.bytes == 256 * 256 * (2 + 4 + 4)
    assert counter.memory()["argument_bytes"] == 256 * 256 * (2 + 4)
    assert counter.memory()["output_bytes"] == 256 * 256 * 4


def test_counter_products_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 32, generator=gen, requires_grad=True)
    w1 = torch.randn(32, 64, generator=gen, requires_grad=True)
    w2 = torch.randn(64, 32, generator=gen, requires_grad=True)

    def f(x, w1, w2):
        h = torch.nn.functional.gelu(x @ w1) @ w2
        a = torch.einsum("bqd,bkd->bqk", h, x)
        out = torch.softmax(a, -1) @ x
        torch.autograd.grad(out.sum(), (x, w1, w2))
        return out.detach()

    counter, _ = dryrun.count_step(f, (x, w1, w2))
    with FlopCounterMode(display=False) as fc:
        f(x, w1, w2)
    assert counter.flops == fc.get_total_flops()


# the reference's jitted steps and the port's at smoke size
def _jax_flops(arch, kind, b, s):
    jcfg = jconfigs.get_smoke_config(arch)
    model = jget_model(jcfg)
    params = model.init_params(jcfg, jax.random.key(0))
    toks = jnp.zeros((b, s), jnp.int32)
    if kind == "prefill":
        fn, args = jsteps.make_prefill_step(jcfg), (params, {"tokens": toks})
    elif kind == "decode":
        cache = model.init_cache(jcfg, b, s)
        fn = jsteps.make_serve_step(jcfg)
        args = (params, cache, jnp.zeros((b, 1), jnp.int32))
    else:
        fn = jsteps.make_train_step(jcfg, jadamw.AdamWConfig())
        args = (params, jadamw.init(params), None,
                {"tokens": toks, "labels": toks})
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_cost.analyze_text(text).flops


def _port_flops(arch, kind, b, s):
    cfg = configs.get_smoke_config(arch)
    step, args = dryrun.device_cell(cfg, kind, b, s,
                                    device=torch.device("cpu"), real=True)
    with torch.no_grad() if kind != "train" else contextlib.nullcontext():
        counter, _ = dryrun.count_step(step, args)
    return counter.flops


def _dead_chunk_states(arch, kind, b, s):
    """FLOPs of `ssd_chunked`'s chunk-state product (2 b s h p n a mamba
    layer) in a prefill: its only use there is the final SSM state, which
    `logits_fn` drops, so XLA removes it as dead code while eager PyTorch
    runs it (at one chunk even the inter-chunk output reads no state)."""
    cfg = configs.get_smoke_config(arch)
    if kind != "prefill":
        return 0.0
    n_mamba = cfg.n_blocks * cfg.block_pattern.count("mamba")
    return (n_mamba * 2.0 * b * s * cfg.n_ssm_heads * cfg.ssm_head_dim
            * cfg.ssm_state)


# measured at b 2, s 64 (port / reference): starcoder2 prefill 1.0000,
# decode 1.0000, train 1.0000; mamba2 prefill 1.0370 (1.0000 without the
# dead chunk states), decode 1.0000, train 1.0000
@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_370m"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_counter_flops_equal_hlo_cost(arch, kind):
    """Product FLOPs of the port's step against `hlo_cost` of the
    reference's jitted step, within 2%, less the dead chunk-state product
    of a mamba prefill (`_dead_chunk_states`).  The decode's attention is
    the fused kernel's formula (the cache's whole span) in the port and
    the oracle's two products over the whole cache in the reference."""
    b, s = 2, 64
    torch.manual_seed(0)
    got, want = _port_flops(arch, kind, b, s), _jax_flops(arch, kind, b, s)
    dead = _dead_chunk_states(arch, kind, b, s)
    assert got - dead == pytest.approx(want, rel=0.02), (got, dead, want)


# --------------------------------------------------------------------------
# The kernels' meta routes and formulas
# --------------------------------------------------------------------------

def _kernel_cases():
    g = torch.Generator().manual_seed(1)

    def r(*shape, dtype=F32):
        return torch.randn(*shape, generator=g).to(dtype)

    b, s, h, kh, hd = 2, 32, 4, 2, 16
    q, k, v = r(b, s, h, hd), r(b, s, kh, hd), r(b, s, kh, hd)
    q1 = r(b, 1, h, hd)
    kc, vc = r(b, kh, s, hd), r(b, kh, s, hd)
    pos = torch.tensor([s - 1, s // 2], dtype=torch.int32)
    valid = torch.ones(b, s, dtype=torch.bool)
    table = torch.arange(4, dtype=torch.int32).repeat(b, 1)
    from repro_torch.kernels.quant import quantize_tensor
    qt = quantize_tensor(r(64, 48), "q8_0")
    ssd = (r(b, s, h, 8), torch.rand(b, s, h, generator=g),
           -torch.rand(h, generator=g), r(b, s, 8), r(b, s, 8))
    db, qs = r(40, 24), r(6, 24)
    tab = r(50, 12)
    idx = torch.randint(0, 50, (5, 7), generator=g, dtype=torch.int32)
    return [
        ("flash_attention", ops.flash_attention, (q, k, v),
         dict(causal=True), False),
        ("flash_attention", ops.flash_attention, (q, k, v),
         dict(causal=False), True),
        ("decode_attention_partial", ops.decode_attention_partial,
         (q1, kc, vc, valid), {}, True),
        ("decode_attention_fused", ops.decode_attention_fused,
         (q1, kc, vc, pos), dict(blk_c=8), True),
        ("decode_attention_fused", ops.decode_attention_fused,
         (q1, kc, vc, pos, None, table), dict(blk_c=8), True),
        ("decode_attention_fused_partial",
         ops.decode_attention_fused_partial, (q1, kc, vc, pos),
         dict(blk_c=8), True),
        ("ssd_scan", ops.ssd_scan, ssd, {}, True),
        ("quant_matmul", ops.quant_matmul, (r(5, 64), qt), {}, True),
        ("knn_distances", ops.knn_distances, (qs, db), {}, True),
        ("knn_topk", ops.knn_topk, (qs, db, 3), {}, True),
        ("sls", ops.sls, (tab, idx, r(5, 7)), {}, False),
    ]


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, tuple):
        return tuple(_meta(t) for t in x)
    if hasattr(x, "quants"):
        return type(x)(_meta(x.scales), _meta(x.quants),
                       None if x.mins is None else _meta(x.mins), x.fmt,
                       x.d_in)
    return x


def _outs(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


@pytest.mark.parametrize("case", range(11))
def test_kernel_meta_route_and_formula(case):
    name, entry, args, kw, unmasked = _kernel_cases()[case]
    twin_counter, twin = dryrun.count_step(
        lambda *a: _twin(entry, *a, **kw), args)
    meta = entry(*_meta(args), **kw)
    assert [(tuple(t.shape), t.dtype) for t in _outs(meta)] == \
        [(tuple(t.shape), t.dtype) for t in _outs(twin)]
    assert all(t.is_meta for t in _outs(meta))
    formula = cost.kernel_cost(name, *args, **kw).flops
    assert formula <= twin_counter.flops
    if unmasked:
        assert formula == twin_counter.flops
    # the entry charges its formula and hides the twin's ops
    counter, _ = dryrun.count_step(lambda *a: entry(*a, **kw), args)
    assert counter.flops == formula and counter.n_ops == 1
    assert counter.kernels[name][2] == 1


def _twin(entry, *args, **kw):
    """The entry's plain version, counted op by op (no cost counter sees
    an entry here: the counter is suspended around `ops._charged`)."""
    saved = cost._active.stack[:]
    cost._active.stack.clear()
    try:
        return entry(*args, **kw)
    finally:
        cost._active.stack[:] = saved


def test_knn_topk_matches_the_reference_with_ties():
    g = np.random.default_rng(0)
    db = g.standard_normal((96, 16)).astype(np.float32)
    db[40] = db[7]                       # equal distances: ids 7 and 40
    db[71] = db[7]
    qs = g.standard_normal((8, 16)).astype(np.float32)
    qs[3] = db[7]
    want_d, want_i = jknn.knn_topk(jnp.asarray(qs), jnp.asarray(db), 5,
                                   blk_q=8, blk_n=32, interpret=True)
    got_d, got_i = ops.knn_topk(torch.from_numpy(qs), torch.from_numpy(db),
                                5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-4)
    assert list(got_i[3, :3].numpy()) == [7, 40, 71]
    d2, i2 = ref.knn_topk_reference(torch.from_numpy(qs),
                                    torch.from_numpy(db), 5)
    assert torch.equal(i2, got_i) and torch.equal(d2, got_d)


# --------------------------------------------------------------------------
# Production-mesh cells, one process
# --------------------------------------------------------------------------

def test_production_mesh_cells():
    """mamba2_370m decode_32k on the 2x16x16 mesh (the reference's
    `test_production_mesh_cell_compiles`), one prefill row and one train
    row, all counted with their roofline, in a process of their own (the
    fake group is one a process)."""
    code = (
        "import json;"
        "from repro_torch.launch.dryrun import run_cell;"
        "rows = [run_cell('mamba2_370m', s, multi_pod=True) for s in"
        " ('decode_32k', 'prefill_32k', 'train_4k')];"
        "print(json.dumps(rows))")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    dec, pre, train = json.loads(out.stdout.strip().splitlines()[-1])
    for row in (dec, pre, train):
        assert row["status"] == "ok", row
        assert row["mesh"] == "2x16x16" and row["roofline"]["chips"] == 512
        mem = row["memory"]
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert row["roofline"]["hlo_flops_per_chip"] > 0
    # decode: 4 rows a rank (128 over 32), SSM states by head group (2 of
    # 32 heads), one all-gather of the groups' outputs a layer
    cfg = configs.get_config("mamba2_370m")
    assert dec["roofline"]["coll_by_op"]["all-gather"] == \
        cfg.n_blocks * 15 * 4 * 2 * (2 * 64) * 2
    assert dec["roofline"]["dominant"] == "memory"
    # train: the step on rank 0's shards (mamba2_370m is under 5e9
    # params: no FSDP), its weights gathered and their gradients
    # reduce-scattered over the model axis, replicated leaves' gradients
    # all-reduced over the data axes
    assert train["fsdp"] is False
    assert train["roofline"]["model_flops"] > 0
    coll = train["roofline"]["coll_by_op"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0


# --------------------------------------------------------------------------
# The sequence-sharded decode step on a gloo mesh
# --------------------------------------------------------------------------

SEQ_ARCHES = ("starcoder2_3b", "mamba2_370m", "whisper_large_v3")
SEQ_B, SEQ_S, SEQ_POS = 2, 64, 45


def _seq_setup(arch):
    """f32 smoke weights and a dense cache (no page table) filled with
    random state up to SEQ_POS, the same on every process."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.init_params(cfg, gen, torch.device("cpu"))
    cache = model.init_cache(cfg, SEQ_B, SEQ_S, device=torch.device("cpu"))
    cache.pop("page_table", None)
    for key, leaf in cache.items():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.5)
    cache["pos"].fill_(SEQ_POS)
    tokens = torch.randint(0, cfg.vocab, (2, SEQ_B, 1), generator=gen)
    return cfg, params, cache, tokens


def _two_steps(cfg, params, cache, tokens):
    step = steps.make_serve_step(cfg)
    return [step(params, cache, tokens[i])[1] for i in range(2)]


def _seq_decode_job(mesh, device):
    """Two decode steps of each arch on this rank's shards of the cache
    (`partition.cache_specs` under `seq_shard_attn`): the AXLE ring over
    the KV span, mamba's head groups, the sharded token write between
    the steps; rank 0's logits."""
    from repro_torch.sharding import use_rules
    rules = ShardingRules(mesh, seq_shard_attn=True)
    plan = partition.PartitionPlan(rules=rules, fsdp=False)
    out = {}
    for arch in SEQ_ARCHES:
        cfg, params, cache, tokens = _seq_setup(arch)
        specs = partition.cache_specs(cache, cfg, plan)
        local = {k: partition.local_shard(v, specs[k], mesh).clone()
                 for k, v in cache.items()}
        with use_rules(rules), torch.no_grad():
            out[arch] = [t.numpy() for t in
                         _two_steps(cfg, params, local, tokens)]
    return out


def test_sequence_sharded_decode_equals_one_device():
    from repro_torch.launch import mesh as mesh_lib
    got = mesh_lib.spawn(_seq_decode_job, 1, 2, timeout=600)
    for arch in SEQ_ARCHES:
        cfg, params, cache, tokens = _seq_setup(arch)
        with torch.no_grad():
            want = _two_steps(cfg, params, cache, tokens)
        for g, w in zip(got[arch], want):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=arch)
