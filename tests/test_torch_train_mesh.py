"""Training on a DATA x MODEL mesh (`launch/partition`'s training specs,
`sharding.TrainLayout`, `core/collectives`, `layers.moe_ffn_dist`, the
mesh-aware loss of `models/transformer` and `models/encdec`,
`steps.make_train_step(layout=)`, `launch/train.train(mesh=)`, the
mesh-agnostic checkpoint), on the CPU.

Part 1, in this process: the port's `param_specs`, `opt_state_specs` and
`batch_specs` equal the JAX functions' leaf by leaf (a JAX
`AbstractMesh`: no devices), for every full config at 16x16, 2x16x16,
1x2, 2x1 and 2x2 with and without FSDP, and on quantized trees.

Part 2: `moe_ffn_dist` on a 2x2 gloo mesh against JAX's on four forced
CPU devices (a child process), f32, within atol and rtol 2e-5 (the
reference's own test's tolerance): E 6 and the padded E 5, capacity
factor 8.0 and the binding 1.0 at T 2048 (1,024 tokens a data shard: the
expert-parallel branch), rows split over data and replicated (B 1), and
the fallback below 512 tokens.

Part 3: the mesh train step against the port's single-device step, one
`mesh.spawn` a mesh shape running every case (one torch thread a rank,
as the single-device runs here): f32 smoke configs, B 2 x S 32 (and
granite_moe_3b at B 4 x S 256, whose data shards route 512 or 1,024
tokens: the expert-parallel branch, held to its single-device twin,
`layers.expert_parallel_twin`), batches 0, 1, 2 of `synth_batch`, AdamW
lr 1e-3 with one warmup step.  Gates
(those of `test_torch_train_steps.py`): the metrics (loss, ce, aux,
grad_norm, lr) within rtol 1e-4; the step-0 gradients, gathered whole,
within 1e-5 of each leaf's max |value|; after 3 steps the parameters,
mu, nu, master and residual within rtol 2e-4 plus atol 1e-5 x the leaf's
max (5e-2 for the residual; against at least 1 for the parameters that
start at zero as an offset of 1: the norm scales, A_log, dt_bias,
`examples/mesh_train.UNIT_LEAVES`), with at most 0.1% of a leaf off (0.5%
compressed), but at least one element (in a leaf of a few hundred: an
Adam step of a gradient element near zero, or a flip of the int8
rounding at a .5 boundary), and those within 3 lr (moments 5%, residual
one quantum).  jamba_1_5_large's state is held
to those gates after its first step, and after its third every element
within the 3 lr bound: after three steps its zero-initialised norm
scales and A_log hold the small residue of +-lr Adam steps, which f32
rounding moves past the gate's atol in up to a fifth of such a leaf, on
one device against the JAX package too (210 of its leaves over the
allowance).  Every stored leaf is exactly its rank's `local_shard`.

Part 4: checkpoints across meshes (2x2 -> one device and 1x2, one device
-> 2x2), and a 2x2 run stopped after step 2 and restarted ends at the
uninterrupted run's state, bit for bit.  Part 5: the CLI under torchrun.
"""
import dataclasses
import functools
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from jax.sharding import AbstractMesh                         # noqa: E402

from repro import sharding as JS                              # noqa: E402
from repro.configs import get_config as jax_config            # noqa: E402
from repro.configs import get_smoke_config as jax_smoke       # noqa: E402
from repro.launch import partition as JP                      # noqa: E402
from repro.models import quantize as JQ                       # noqa: E402
from repro.models.registry import get_model as jax_model      # noqa: E402
from repro_torch import tree                                  # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_lib           # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,  # noqa: E402
                                 get_smoke_config, input_specs)
from repro_torch.core import collectives as C                 # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.kernels.quant import QTensor                 # noqa: E402
from repro_torch.launch import mesh as mesh_lib               # noqa: E402
from repro_torch.launch import partition                      # noqa: E402
from repro_torch.examples.mesh_train import (UNIT_LEAVES,    # noqa: E402
                                              leaf_names)
from repro_torch.launch import steps                          # noqa: E402
from repro_torch.launch.train import mesh_layout, train       # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402
from repro_torch.models.quantize import quantize_params       # noqa: E402
from repro_torch.models.registry import get_model             # noqa: E402
from repro_torch.optim import adamw, compression              # noqa: E402
from repro_torch.sharding import (ShardingRules, TrainLayout,  # noqa: E402
                                  use_rules, use_train_layout)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
CPU = torch.device("cpu")


# ===========================================================================
# Part 1: the training specs against the JAX package's
# ===========================================================================

class _Mesh:
    """A mesh's axes alone, for planning without a process group."""

    def __init__(self, shape, names):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(shape)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _norm(spec):
    """A spec as a tuple of None or tuples of axis names (JAX writes a
    one-axis tuple as the name)."""
    return tuple(None if not a else ((a,) if isinstance(a, str)
                                     else tuple(a)) for a in spec)


def _jax_flat(specs):
    out = {}
    for path, sp in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)
        out[key] = _norm(sp)
    return out


def _port_flat(specs, prefix=""):
    out = {}
    if isinstance(specs, dict):
        for k, v in specs.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
    elif isinstance(specs, QTensor):
        for k in ("scales", "quants", "mins"):
            if getattr(specs, k) is not None:
                out[f"{prefix}{k}"] = _norm(getattr(specs, k))
    elif isinstance(specs, (list, tuple)) and not isinstance(specs,
                                                             partition.Spec):
        for i, v in enumerate(specs):
            out.update(_port_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = _norm(specs)
    return out


def _plans(mesh_name, fsdp):
    shape, names = MESHES[mesh_name]
    jplan = JP.PartitionPlan(
        rules=JS.ShardingRules(AbstractMesh(shape, names)), fsdp=fsdp)
    tplan = partition.PartitionPlan(
        rules=ShardingRules(_Mesh(shape, names)), fsdp=fsdp)
    return jplan, tplan


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(arch):
    """Every leaf's spec of the full config's parameter tree, and of
    AdamW's state, at every mesh, with and without FSDP."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jab = jax_model(jcfg).abstract_params(jcfg)
    tab = get_model(tcfg).abstract_params(tcfg)
    for mesh_name in MESHES:
        for fsdp in (False, True):
            jplan, tplan = _plans(mesh_name, fsdp)
            jspecs = JP.param_specs(jab, jcfg, jplan)
            tspecs = partition.param_specs(tab, tcfg, tplan)
            want = _jax_flat(jspecs)
            assert _port_flat(tspecs) == want, (mesh_name, fsdp)
            jopt = JP.opt_state_specs(None, jspecs)
            topt = partition.opt_state_specs(None, tspecs)
            for field in ("mu", "nu", "master"):
                assert _port_flat(getattr(topt, field)) == _jax_flat(
                    getattr(jopt, field))
            assert _norm(topt.step) == _norm(jopt.step) == ()


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_quantized_param_specs_equal_the_reference(fmt):
    """A quantized tree's QTensor children: only the out-column axis
    splits, over tp or (wo / out_proj / w_down) the fsdp axes."""
    for arch in ("starcoder2_3b", "jamba_1_5_large"):
        jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
        jp = JQ.quantize_params(jax_model(jcfg).init_params(
            jcfg, jax.random.key(0)), fmt)
        tp = quantize_params(get_model(tcfg).init_params(
            tcfg, torch.Generator().manual_seed(0), CPU), fmt)
        for mesh_name in ("2x2", "16x16"):
            for fsdp in (False, True):
                jplan, tplan = _plans(mesh_name, fsdp)
                assert _port_flat(partition.param_specs(tp, tcfg, tplan)) \
                    == _jax_flat(JP.param_specs(jp, jcfg, jplan)), (
                        arch, mesh_name, fsdp)


def test_batch_specs_equal_the_reference():
    """Rows over the batch axes; batch 1, or a batch that does not divide,
    replicated."""
    cases = [{k: jax.ShapeDtypeStruct(v.shape, np.int32)
              for k, v in input_specs(get_config(a), s).items()}
             for a in ("starcoder2_3b", "qwen2_vl_2b", "whisper_large_v3")
             for s in SHAPES]
    cases += [{"tokens": jax.ShapeDtypeStruct((b, 64), np.int32),
               "labels": jax.ShapeDtypeStruct((b, 64), np.int32)}
              for b in (1, 2, 3, 6)]
    for mesh_name in MESHES:
        jplan, tplan = _plans(mesh_name, False)
        for batch in cases:
            want = {k: _norm(v) for k, v in
                    JP.batch_specs(batch, jplan).items()}
            got = {k: _norm(v) for k, v in
                   partition.batch_specs(batch, tplan).items()}
            assert got == want, (mesh_name, {k: v.shape
                                             for k, v in batch.items()})


def test_seq_rule_and_span():
    """The "batch" activation rule: S over model when it divides and S >=
    n_model, else replicated; a rank's span follows its model index and
    its rows follow the batch's spec."""
    from repro_torch.sharding import seq_axis

    class _Ranked(_Mesh):
        def get_local_rank(self, axis):
            return {"data": 1, "model": 3}[axis]

    rules = ShardingRules(_Ranked((2, 4), ("data", "model")),
                          seq_shard_acts=True)
    assert seq_axis(rules, 32) == "model"
    assert seq_axis(rules, 30) is None and seq_axis(rules, 2) is None
    assert seq_axis(ShardingRules(_Mesh((2, 4), ("data", "model"))),
                    32) is None
    split = TrainLayout(rules, None, {"tokens": partition.Spec(("data",),
                                                               None)})
    act = split.act(32)
    assert (act.rows, act.seq, act.s, act.start, act.length) == (
        ("data",), "model", 32, 24, 8)
    whole = TrainLayout(rules, None, {"tokens": partition.Spec(None, None)})
    act = whole.act(30)
    assert (act.rows, act.seq, act.start, act.length) == (None, None, 0, 30)


# ===========================================================================
# Part 2: moe_ffn_dist on a 2x2 gloo mesh against JAX's
# ===========================================================================

MOE_D, MOE_F, MOE_K = 32, 48, 2
# (B, S, E, capacity factor): T = B*S rows; 1,024 tokens a data shard or
# more take the expert-parallel branch, 32 the fallback
MOE_CASES = [(2, 1024, 6, 8.0), (2, 1024, 5, 8.0), (2, 1024, 6, 1.0),
             (2, 1024, 5, 1.0), (1, 2048, 5, 1.0), (2, 32, 6, 1.25),
             (2, 32, 5, 1.25)]

_JAX_MOE = """
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import jax, numpy as np
from repro.models import layers as L
from repro import sharding as sh
data = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((2, 2), ('data', 'model'))
out = {}
for i, (b, s, e, cf) in enumerate(%r):
    a = [data[f'{n}{i}'] for n in ('x', 'router', 'wg', 'wu', 'wd')]
    a[0] = a[0].reshape(b * s, -1)
    out[f'ref{i}'] = np.asarray(L.moe_ffn(*a, %d, capacity_factor=cf))
    with mesh, sh.use_rules(sh.ShardingRules(mesh)):
        out[f'dist{i}'] = np.asarray(jax.jit(lambda *t: L.moe_ffn_dist(
            *t, top_k=%d, capacity_factor=cf))(*a))
np.savez(sys.argv[2], **out)
""" % (MOE_CASES, MOE_K, MOE_K)


def _moe_inputs():
    rng = np.random.default_rng(0)
    data = {}
    for i, (b, s, e, _) in enumerate(MOE_CASES):
        data[f"x{i}"] = rng.standard_normal((b, s, MOE_D), np.float32)
        data[f"router{i}"] = (rng.standard_normal((MOE_D, e), np.float32)
                              * 0.3)
        for n, shape in (("wg", (e, MOE_D, MOE_F)), ("wu", (e, MOE_D, MOE_F)),
                         ("wd", (e, MOE_F, MOE_D))):
            data[f"{n}{i}"] = (rng.standard_normal(shape, np.float32)
                               * 0.1)
    return data


def _moe_job(mesh, device, data):
    """Every MoE case on this rank's rows and span, the expert stacks as
    `param_specs` stores them (E 6 over the model axis, the padded E 5
    split on F); the outputs gathered whole to rank 0."""
    rules = ShardingRules(mesh, seq_shard_acts=True)
    plan = partition.PartitionPlan(rules=rules, fsdp=False)
    out = {}
    for i, (b, s, e, cf) in enumerate(MOE_CASES):
        x = torch.from_numpy(data[f"x{i}"])
        ws = {"w_gate": data[f"wg{i}"], "w_up": data[f"wu{i}"],
              "w_down": data[f"wd{i}"]}
        specs = {k: partition.Spec(*partition._leaf_spec(
            plan, None, k, np.empty((1,) + v.shape))[1:])
            for k, v in ws.items()}
        local = {k: partition.local_shard(torch.from_numpy(v), specs[k],
                                          mesh).clone()
                 for k, v in ws.items()}
        layout = TrainLayout(rules, None, partition.batch_specs(
            {"tokens": x[..., 0]}, plan))
        act = layout.act(s)
        xl = partition.local_shard(x, partition.Spec(act.rows, act.seq,
                                                     None), mesh)
        with use_rules(rules), torch.no_grad():
            y = L.moe_ffn_dist(
                xl.contiguous(), torch.from_numpy(data[f"router{i}"]),
                local["w_gate"], local["w_up"], local["w_down"], MOE_K,
                cf, act=act, w_specs=tuple(specs[k] for k in
                                           ("w_gate", "w_up", "w_down")))
            if act.seq:
                y = C.all_gather(y, 1, act.seq)
            if act.rows:
                y = C.all_gather(y, 0, act.rows)
        out[i] = (y.reshape(b * s, -1).numpy(), tuple(specs["w_gate"]))
    return out


@functools.lru_cache(maxsize=None)
def _moe_results():
    data = _moe_inputs()
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(src, **data)
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        # the JAX child runs beside the port's ranks
        child = subprocess.Popen([sys.executable, "-c", _JAX_MOE, src, dst],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            port = mesh_lib.spawn(_moe_job, 2, 2, args=(data,), timeout=600)
            _, err = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
        assert child.returncode == 0, err[-3000:]
        jax_out = dict(np.load(dst))
    return data, jax_out, port


@pytest.mark.parametrize("case", range(len(MOE_CASES)),
                         ids=[f"B{b}xS{s}-E{e}-cf{cf}"
                              for b, s, e, cf in MOE_CASES])
def test_moe_ffn_dist_matches_jax_on_a_2x2_mesh(case):
    data, jax_out, port = _moe_results()
    b, s, e, cf = MOE_CASES[case]
    got, wg_spec = port[case]
    np.testing.assert_allclose(got, jax_out[f"dist{case}"], atol=2e-5,
                               rtol=2e-5)
    # the single-device twin of the branch (`layers.moe_ffn_ep`), which
    # the mesh train step is held to where it takes the branch
    if b * s // 2 >= 512:
        twin = L.moe_ffn_ep(
            torch.from_numpy(data[f"x{case}"]).reshape(b * s, -1),
            *(torch.from_numpy(data[f"{n}{case}"])
              for n in ("router", "wg", "wu", "wd")), MOE_K, cf, 2,
            2).numpy()
        np.testing.assert_allclose(twin, jax_out[f"dist{case}"], atol=2e-5,
                                   rtol=2e-5)
    # E 6 splits over the model axis (EP), the padded E 5 splits F
    assert wg_spec == (("model", None, None) if e == 6
                       else (None, None, "model"))
    if b * s // 2 >= 512 and cf == 1.0:
        # the binding capacity: the per-shard dispatch parts from moe_ffn
        ref = jax_out[f"ref{case}"]
        assert np.abs(got - ref).max() > 1e-2
        port_ref = L.moe_ffn(
            torch.from_numpy(data[f"x{case}"]).reshape(b * s, -1),
            *(torch.from_numpy(data[f"{n}{case}"])
              for n in ("router", "wg", "wu", "wd")), MOE_K, cf).numpy()
        np.testing.assert_allclose(port_ref, ref, atol=2e-5, rtol=2e-5)
    elif b * s // 2 < 512:
        np.testing.assert_allclose(got, jax_out[f"ref{case}"], atol=2e-5,
                                   rtol=2e-5)


# ===========================================================================
# Part 3: the mesh train step against the single-device step
# ===========================================================================

B, S, LR, N_STEPS = 2, 32, 1e-3, 3
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)
FIVE = ("starcoder2_3b", "mamba2_370m", "granite_moe_3b",
        "whisper_large_v3", "jamba_1_5_large")
OTHERS = tuple(a for a in ARCH_IDS if a not in FIVE)


def _case_jobs(shape):
    jobs = [(a, None, c, B, S) for a in FIVE for c in (False, True)]
    if shape in ("2x1", "2x2"):
        jobs += [(a, True, False, B, S) for a in FIVE]
    if shape in ("1x2", "2x2"):          # the expert-parallel branch
        jobs += [("granite_moe_3b", None, c, 4, 256) for c in (False, True)]
    if shape == "2x2":
        jobs += [(a, None, False, B, S) for a in OTHERS]
        # replicated rows (batch 1) and a sequence that does not split
        jobs += [("starcoder2_3b", None, False, 1, 33),
                 ("granite_moe_3b", None, True, 1, 30)]
    return jobs


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _batches(cfg, b, s):
    d = DataConfig(vocab=cfg.vocab, batch=b, seq_len=s,
                   frontend=cfg.frontend, d_model=cfg.d_model,
                   enc_dec=cfg.enc_dec, enc_len=s if cfg.enc_dec else 0)
    return [synth_batch(d, i) for i in range(N_STEPS)]


def _params(cfg):
    return get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                      CPU)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state_np(params, opt, comp):
    out = {"params": params, "mu": opt.mu, "nu": opt.nu,
           "master": opt.master}
    if comp is not None:
        out["residual"] = comp.residual
    return {k: [x.numpy().copy() for x in tree.leaves(v)]
            for k, v in out.items()}


def _stored_exactly(full, local, specs, mesh):
    """Every local leaf has its local_shard's shape and owns no more
    storage than its elements."""
    for f, x, sp in zip(tree.leaves(full), tree.leaves(local),
                        tree.leaves(specs)):
        want = partition.local_shard(f, sp, mesh).shape
        if x.shape != want or x.untyped_storage().nbytes() != \
                x.numel() * x.element_size():
            return False
    return True


def _run_case(mesh, arch, fsdp, compress, b, s):
    """Three mesh steps of one case (and the step-0 gradients gathered
    whole); rank 0's gathered state."""
    cfg = _cfg(arch)
    full = _params(cfg)
    batches = _batches(cfg, b, s)
    layout = mesh_layout(cfg, mesh, full, batches[0], fsdp)
    params = partition.shard_tree(full, layout.params, mesh)
    local = [partition.shard_tree(_t(x), layout.batch, mesh)
             for x in batches]
    out = {}
    if not compress:
        _, _, grads = steps.loss_and_grads(cfg, params, local[0], layout)
        with use_rules(layout.rules), torch.no_grad():
            out["grads"] = [C.gather(g, sp).numpy() for g, sp in zip(
                tree.leaves(grads), tree.leaves(layout.params))]
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT),
                                 compress_grads=compress, layout=layout)
    state = (params, adamw.init(params),
             compression.init(params) if compress else None)
    metrics = []
    for i, batch in enumerate(local):
        *state, m = step(*state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["state1"] = _gathered_state(layout, *state)
    p, opt, comp = state
    specs = {"params": layout.params, "opt": partition.opt_state_specs(
        None, layout.params), "comp": compression.CompressionState(
        layout.params)}
    stored = {"params": p, "opt": opt, "comp": comp}
    fulls = {"params": full, "opt": adamw.init(full),
             "comp": compression.init(full) if compress else None}
    out["stored_exactly"] = all(
        _stored_exactly(fulls[k], stored[k], specs[k], mesh)
        for k in stored if stored[k] is not None)
    out["state"] = _gathered_state(layout, p, opt, comp)
    out["metrics"] = metrics
    with use_rules(layout.rules):
        out["comp_bytes"] = (compression.compressed_bytes(p, layout.params),
                             compression.compressed_bytes(full))
    out["fsdp"] = any(ax and "data" in (ax if isinstance(ax, tuple)
                                        else (ax,))
                      for sp in tree.leaves(layout.params) for ax in sp)
    return out


def _gathered_state(layout, p, opt, comp):
    """`_state_np` of the whole tensors gathered from the rank's shards."""
    with use_rules(layout.rules), torch.no_grad():
        def whole(tree_):
            return tree.map_leaves(C.gather, tree_, layout.params)
        opt_full = adamw.OptState(opt.step, whole(opt.mu), whole(opt.nu),
                                  whole(opt.master))
        comp_full = (None if comp is None
                     else compression.CompressionState(whole(comp.residual)))
        return _state_np(whole(p), opt_full, comp_full)


def _thread_backward(mesh, arch, b, s):
    """The mesh loss's backward run on a thread of its own, which holds
    none of the forward's thread-local rules (on the card the autograd
    engine runs a CUDA backward so): its gradients against
    `loss_and_grads`', both gathered whole."""
    cfg = _cfg(arch)
    full = _params(cfg)
    batch = _batches(cfg, b, s)[0]
    layout = mesh_layout(cfg, mesh, full, batch)
    params = partition.shard_tree(full, layout.params, mesh)
    local = partition.shard_tree(_t(batch), layout.batch, mesh)
    _, _, want = steps.loss_and_grads(cfg, params, local, layout)
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with L.true_f32(), use_train_layout(layout):
        loss, _ = get_model(cfg).loss_fn(cfg, tree.unflatten(params, leaves),
                                         local)
    box = {}

    def backward():
        with L.true_f32():
            box["grads"] = torch.autograd.grad(loss / layout.world(), leaves)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=300)
    assert not worker.is_alive() and "grads" in box
    grads = C.sum_over_replicas(list(box["grads"]),
                                tree.leaves(layout.params), layout.rules)
    with use_rules(layout.rules), torch.no_grad():
        return [(C.gather(g, sp).numpy(), C.gather(w, sp).numpy())
                for g, w, sp in zip(grads, tree.leaves(want),
                                    tree.leaves(layout.params))]


def _mesh_job(mesh, device, jobs, ckpt_dir):
    out = {}
    for job in jobs:
        out[job] = _run_case(mesh, *job)
    if ckpt_dir is not None:
        out["ckpt"] = _ckpt_job(mesh, ckpt_dir)
    if ckpt_dir is not None and len(ckpt_dir) == 3:
        out["thread"] = {arch: _thread_backward(mesh, arch, b, s)
                         for arch, b, s in THREAD_CASES}
    return out


@functools.lru_cache(maxsize=None)
def _single(arch, compress, b, s, shape):
    """The port's single-device run of a case, at one torch thread, the
    MoE as the mesh `shape` computes it (`expert_parallel_twin`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with L.expert_parallel_twin(*mesh_lib.parse_mesh(shape)):
            return _single_run(arch, compress, b, s)
    finally:
        torch.set_num_threads(threads)


def _single_run(arch, compress, b, s):
    """One single-device run: step-0 gradients, metrics, states."""
    cfg = _cfg(arch)
    params = _params(cfg)
    batches = [_t(x) for x in _batches(cfg, b, s)]
    out = {}
    if not compress:
        _, _, grads = steps.loss_and_grads(cfg, params, batches[0])
        out["grads"] = [g.numpy() for g in tree.leaves(grads)]
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**OPT),
                                 compress_grads=compress)
    state = (params, adamw.init(params),
             compression.init(params) if compress else None)
    metrics = []
    for i, batch in enumerate(batches):
        *state, m = step(*state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["state1"] = _state_np(*state)
    out["state"] = _state_np(*state)
    out["metrics"] = metrics
    return out


# the largest |mesh - single| where an element was sent another way, by
# kind of leaf: (a multiple of LR, a multiple of the leaf's max)
BOUND = {"params": (3, 0), "master": (3, 0), "mu": (0, 0.05),
         "nu": (0, 0.05), "residual": (0, 2.01)}
ATOL = {"residual": 5e-2}


def _assert_close(t, j, name, compress, what, bound_only=False,
                  unit=False):
    diff = np.abs(t - j)
    top = max(float(np.abs(j).max()), float(np.abs(t).max()))
    scale = max(top, 1.0) if unit else top
    off = diff > 2e-4 * np.abs(j) + ATOL.get(name, 1e-5) * scale
    allowed = max((5e-3 if compress else 1e-3) * t.size, 1)
    assert bound_only or off.sum() <= allowed, (what, int(off.sum()), t.size)
    lr_x, max_x = BOUND[name]
    assert diff.max() <= lr_x * LR + max_x * top, (what, diff.max())


MESH_SHAPES = ("1x2", "2x1", "2x2")
_CKPT_DIRS = {}


def _ckpt_dir(name):
    if name not in _CKPT_DIRS:
        _CKPT_DIRS[name] = tempfile.mkdtemp(prefix=f"mesh_ckpt_{name}_")
    return _CKPT_DIRS[name]


@functools.lru_cache(maxsize=None)
def _cell(shape):
    n_data, n_model = mesh_lib.parse_mesh(shape)
    ckpt = None
    if shape == "2x2":
        _single_ckpt()                   # the one-device file it restores
        ckpt = (_ckpt_dir("single"), _ckpt_dir("2x2"), _ckpt_dir("2x2b"))
    elif shape == "1x2":
        _cell("2x2")                     # the 2x2 files it restores
        ckpt = (_ckpt_dir("1x2"),)
        shutil.rmtree(ckpt[0])
        shutil.copytree(_ckpt_dir("2x2"), ckpt[0])
    return mesh_lib.spawn(_mesh_job, n_data, n_model,
                          args=(_case_jobs(shape), ckpt), timeout=900)


def _check_case(shape, job):
    arch, fsdp, compress, b, s = job
    run, base = _cell(shape)[job], _single(arch, compress, b, s, shape)
    assert run["stored_exactly"], job
    # the compressed all-reduce's bytes count the global tree
    assert run["comp_bytes"][0] == run["comp_bytes"][1], job
    if fsdp:
        assert run["fsdp"], job
    for step_i, (got, want) in enumerate(zip(run["metrics"],
                                             base["metrics"])):
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert got[key] == pytest.approx(want[key], rel=1e-4,
                                             abs=1e-7), (job, step_i, key)
    if not compress:
        for i, (g, w) in enumerate(zip(run["grads"], base["grads"])):
            top = float(np.abs(w).max()) or 1.0
            assert np.abs(g - w).max() <= 1e-5 * top, (job, i)
    names = leaf_names(_params(_cfg(arch)))
    for key in ("state1", "state"):
        bound_only = arch == "jamba_1_5_large" and key == "state"
        for name, leaves in base[key].items():
            for i, (t, j) in enumerate(zip(run[key][name], leaves)):
                unit = name in ("params", "master") and \
                    names[i] in UNIT_LEAVES
                _assert_close(t, j, name, compress, (job, key, name, i),
                              bound_only, unit)


THREAD_CASES = (("granite_moe_3b", 4, 256), ("jamba_1_5_large", 2, 32),
                ("whisper_large_v3", 2, 32))


@pytest.mark.parametrize("arch", [a for a, _, _ in THREAD_CASES])
def test_backward_reads_no_thread_local_state(arch):
    """The 2x2 mesh loss's backward (the checkpointed blocks'
    recomputation with their gathers) on another thread gives
    `loss_and_grads`' gradients bitwise: the recomputation reads its
    mesh from its arguments, not from the forward thread's rules."""
    for got, want in _cell("2x2")["thread"][arch]:
        assert np.array_equal(got, want)


def _ids(jobs):
    return [f"{a}-{'fsdp' if f else 'plan'}-"
            f"{'compressed' if c else 'plain'}-B{b}xS{s}"
            for a, f, c, b, s in jobs]


@pytest.mark.parametrize("job", _case_jobs("1x2"), ids=_ids(
    _case_jobs("1x2")))
def test_train_step_on_1x2_equals_one_device(job):
    _check_case("1x2", job)


@pytest.mark.parametrize("job", _case_jobs("2x1"), ids=_ids(
    _case_jobs("2x1")))
def test_train_step_on_2x1_equals_one_device(job):
    _check_case("2x1", job)


@pytest.mark.parametrize("job", _case_jobs("2x2"), ids=_ids(
    _case_jobs("2x2")))
def test_train_step_on_2x2_equals_one_device(job):
    _check_case("2x2", job)


# ===========================================================================
# Part 4: the checkpoint across meshes
# ===========================================================================

CK_ARCH = "granite_moe_3b"
CK_RUN = dict(batch=2, seq_len=32, ckpt_every=2, compress=True,
              log_every=100, device="cpu", cfg=_cfg(CK_ARCH))


def _like():
    """A one-device state tree of `launch/train.train`
    (`TrainState.tree()`), and the gate's name of each of its leaves."""
    p = _params(_cfg(CK_ARCH))
    like = {"params": p, "opt": adamw.init(p), "comp": compression.init(p)}
    n = len(tree.leaves(p))
    names = (["residual"] * n + ["step"] + ["mu"] * n + ["nu"] * n
             + ["master"] * n + ["params"] * n)
    assert len(names) == len(tree.leaves(like))
    return like, names


@functools.lru_cache(maxsize=None)
def _single_ckpt():
    """One-device runs of `launch/train.train`: 2 steps (its checkpoint is
    what the 2x2 mesh resumes from) and 3 and 4 steps (the states to
    compare)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for steps_n in (2, 3, 4):
            d = _ckpt_dir(f"single{steps_n}") if steps_n != 2 else \
                _ckpt_dir("single")
            train(CK_ARCH, steps=steps_n, ckpt_dir=d, **CK_RUN)
            out[steps_n] = _full_state(d)[1]
        return out
    finally:
        torch.set_num_threads(threads)


def _full_state(ckpt_dir):
    got = ckpt_lib.restore(ckpt_dir, _like()[0])
    return got[0], [x.numpy() for x in tree.leaves(got[1])]


def _ckpt_job(mesh, dirs):
    """2x2: resume the one-device checkpoint of step 2 to step 3; run 4
    steps straight and, elsewhere, 2 then (restarted) 4.  1x2: resume the
    2x2 run's step-4 checkpoint to step 5.  Returns each final file's
    step."""
    out = {}
    if len(dirs) == 3:
        single, straight, restarted = dirs
        train(CK_ARCH, steps=3, ckpt_dir=single, mesh=mesh, **CK_RUN)
        train(CK_ARCH, steps=4, ckpt_dir=straight, mesh=mesh, **CK_RUN)
        train(CK_ARCH, steps=2, ckpt_dir=restarted, mesh=mesh, **CK_RUN)
        out["restarted"] = train(CK_ARCH, steps=4, ckpt_dir=restarted,
                                 mesh=mesh, **CK_RUN)["steps_run"]
    else:
        (src,) = dirs
        out["resumed"] = train(CK_ARCH, steps=5, ckpt_dir=src, mesh=mesh,
                               **CK_RUN)["steps_run"]
    return out


def _assert_state_close(got, want, what):
    """The compressed gates of Part 3, leaf by leaf; the step exactly."""
    for i, (name, t, j) in enumerate(zip(_like()[1], got, want)):
        if name == "step":
            assert int(t) == int(j), what
        else:
            _assert_close(t, j, name, True, (what, name, i))


def test_checkpoint_from_one_device_resumes_on_2x2():
    """The one-device step-2 checkpoint, restored by every 2x2 rank as its
    shards, steps once: the file it writes (whole leaves) is the
    one-device run's step-3 state within the compressed gates."""
    _cell("2x2")
    step, got = _full_state(_ckpt_dir("single"))
    assert step == 3
    _assert_state_close(got, _single_ckpt()[3], "single->2x2")


def test_restarted_mesh_run_ends_at_the_uninterrupted_state():
    """A 2x2 run stopped after step 2 and restarted from its checkpoint
    ends at the uninterrupted 2x2 run's state, bit for bit."""
    assert _cell("2x2")["ckpt"]["restarted"] == 2
    s1, a = _full_state(_ckpt_dir("2x2"))
    s2, b = _full_state(_ckpt_dir("2x2b"))
    assert s1 == s2 == 4
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_checkpoint_from_2x2_restores_on_one_device_and_1x2():
    """The 2x2 run's step-4 file restores on one device as the one-device
    run's step-4 state (within the gates), and on 1x2, whose ranks take
    their shards and step on to 5."""
    _, got = _full_state(_ckpt_dir("2x2"))
    _assert_state_close(got, _single_ckpt()[4], "2x2->single")
    assert _cell("1x2")["ckpt"]["resumed"] == 1
    assert _full_state(_ckpt_dir("1x2"))[0] == 5


# ===========================================================================
# Part 5: the CLI under torchrun
# ===========================================================================

def test_train_cli_under_torchrun():
    """`torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh
    1x2`: rank 0 prints the run, its loss the one-device CLI's."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
            "granite_moe_3b", "--steps", "2", "--batch", "2", "--seq-len",
            "32"]
    mesh = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(mesh_lib.free_port())] + args
        + ["--mesh", "1x2"], env=env, capture_output=True, text=True,
        timeout=300)
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    one = subprocess.run([sys.executable] + args, env=env,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    lines = [x for x in mesh.stdout.splitlines() if x.startswith("[train]")]
    assert any(x.startswith("[train] mesh=1x2 ranks=2 wire_bytes=")
               for x in lines), mesh.stdout
    done = [x for x in lines if x.startswith("[train] done")]
    assert len(done) == 1                   # rank 0 alone reports
    # bf16 (the CLI's smoke config): the rounding of other product shapes
    first = [float(x.split()[4]) for x in one.stdout.splitlines()
             if x.startswith("[train] step 0")]
    assert first[0] == pytest.approx(float([
        x for x in lines if x.startswith("[train] step 0")][0].split()[4]),
        abs=1e-2)

