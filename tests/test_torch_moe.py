"""Parity of the port's Mixture-of-Experts serving with the JAX package at
smoke size: `layers.moe_ffn` (the f32 router, the capacity-bounded
dispatch and its drops, the expert products, the f32 combine) and the
three MoE archs, granite_moe_3b (E 5, top-2, vocab 515 padded to 768),
phi3_5_moe_42b and the hybrid jamba_1_5_large (four mamba layers, one
attention layer, three more mamba; MoE on every other layer), through
prefill, decode, the speculative verify and the streamed servers.  The
port runs the JAX package's own weights, crossed over through
`repro_torch.interop`.

Tolerances: float32 (`dtype="float32"` in both packages) `moe_ffn`
outputs within atol = 1e-5 (the same f32 products and sums in another
order), model logits and cache leaves within 1e-4 (2e-4 through jamba's
8 layers, as LOGIT_ATOL says), greedy tokens equal.  bfloat16 `moe_ffn`
outputs within 2e-2 (one bf16 unit below 4: the same bf16 roundings, f32
sums in another order).  Dispatch tables (the token, gate and keep of
every slot) are compared as integers and bits: the same integer
computation on the same expert ids.

bfloat16 greedy streams equal the JAX server's except where one parts at
a near tie, in a replay of the stream's prefix as the server computes it
(the prefill of its padded bucket, then decode steps; a prefill of the
whole prefix would route other rows together, and so drop other pairs):
the two choices' logits within 0.1 (the gate of tests/test_quant.py), or
else a router near tie upstream: at the first MoE call where the two
packages send rows to other experts (an expert swap moves a whole logit
row, and shifts the capacity queues of the rows after it), each such row
has its k-th and (k+1)-th router logits within 0.1.  A `moe_ffn` case
whose routers pick other experts is held to that router gate only.
"""
import dataclasses
import functools
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_config as jax_config            # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jserve                      # noqa: E402
from repro.launch import steps as jsteps                      # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro.models import transformer as JT                    # noqa: E402
from repro_torch import configs, interop                      # noqa: E402
from repro_torch.examples import serve_offload                # noqa: E402
from repro_torch.kernels.quant import QTensor                 # noqa: E402
from repro_torch.launch import serve as tserve                # noqa: E402
from repro_torch.launch import steps as tsteps                # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402
from repro_torch.models import transformer as T               # noqa: E402
from repro_torch.models.quantize import (padded_rows,         # noqa: E402
                                         quantize_params)

ARCHS = ("granite_moe_3b", "phi3_5_moe_42b", "jamba_1_5_large")
GRANITE = "granite_moe_3b"
F32_ATOL, BF16_ATOL = 1e-5, 2e-2
# f32 logits and cache leaves: 1e-4 through a 2-layer smoke stack, as
# tests/test_torch_archs.py; jamba's smoke stack has 8 layers, four times
# the depth of sum-order drift (measured: 1.2e-4 at most; the 8-layer
# mamba2 smoke stack alone drifts 1.5e-4 in its SSM state), so 2e-4
LOGIT_ATOL = {"granite_moe_3b": 1e-4, "phi3_5_moe_42b": 1e-4,
              "jamba_1_5_large": 2e-4}
NEAR_TIE = 0.1
CPU = torch.device("cpu")
S, PAGE = 64, 16
LENGTHS = (30, 37)
N_STEPS = 6
SLOTS, SEG_LEN, N_REQ, MAX_NEW, SPEC_K = 2, 8, 4, 12, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: faster at smoke size, and it leaves the cores
    to the other test processes.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    assert dataclasses.asdict(configs.get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(configs.get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch,layers,gb", [
    ("granite_moe_3b", 32, 6.6), ("phi3_5_moe_42b", 24, 62.7),
    ("jamba_1_5_large", 5, 65.0)])
def test_card_config_cuts_depth_only(arch, layers, gb):
    """The card config keeps every width, the experts, top-k and
    `moe_every`; it changes only the id, the depth and (jamba) the
    pattern, to the real model's first layers."""
    full, card = configs.get_config(arch), configs.get_card_config(arch)
    changed = {k for k, v in dataclasses.asdict(card).items()
               if dataclasses.asdict(full)[k] != v}
    assert changed <= {"arch_id", "n_layers", "block_pattern"}
    assert card.n_layers == layers
    assert card.block_pattern == full.block_pattern[:len(card.block_pattern)]
    assert round(card.n_params() * 2 / 1e9, 1) == gb


# ------------------------------------------------------------ moe_ffn

def _moe_case(seed, t, d, e, f, k, skew=0.0):
    """Random inputs; `skew` biases the router toward low expert ids, so
    that their queues pass the capacity and pairs drop."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    router[0] += skew * np.linspace(1.0, 0.0, e, dtype=np.float32)
    x[:, 0] = np.abs(x[:, 0]) + skew
    w = [(rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    return x, router, w


def _reference_dispatch(expert_ids, gate_vals, e, cap):
    """The reference's slot table, as `repro.models.layers.moe_ffn`
    computes it (layers.py:305-317, 325-328): jnp scatters in which a
    dropped pair writes (E - 1, cap - 1) and the last writer wins."""
    t = expert_ids.shape[0]
    flat_expert = expert_ids.reshape(-1)
    onehot = jax.nn.one_hot(flat_expert, e, dtype=jnp.int32)
    pos_in_expert = (jnp.cumsum(onehot, axis=0) * onehot - 1).max(axis=-1)
    keep = pos_in_expert < cap
    token_ids = jnp.repeat(jnp.arange(t), expert_ids.shape[1])
    rows = jnp.where(keep, flat_expert, e - 1)
    cols = jnp.where(keep, pos_in_expert, cap - 1)
    slot_token = jnp.full((e, cap), t, dtype=jnp.int32).at[rows, cols].set(
        jnp.where(keep, token_ids, t), mode="drop")
    slot_gate = jnp.zeros((e, cap), jnp.float32).at[rows, cols].set(
        jnp.where(keep, gate_vals.reshape(-1), 0.0), mode="drop")
    return np.asarray(slot_token), np.asarray(slot_gate), np.asarray(keep)


def _port_dispatch(expert_ids, gate_vals, e, cap):
    dp = L.moe_dispatch(torch.from_numpy(np.array(expert_ids)).long(),
                        torch.from_numpy(np.array(gate_vals)), e, cap)
    return dp.slot_token.numpy(), dp.slot_gate.numpy(), dp.keep.numpy()


def _reference_route(x, router, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    gates, ids = jax.lax.top_k(probs, k)
    return gates / gates.sum(-1, keepdims=True), ids


def _two_queues(first, n_first, second, n_second):
    """Top-1 routing of n_first tokens to expert `first`, then n_second
    to `second`, over E 3, D 8, F 4: the router is the identity on the
    first 3 coordinates, with x[i, choice] = 5.  cap = max(8, ceil(T / 3
    x 1.25)) = 8 for T <= 19."""
    rng = np.random.default_rng(0)
    t = n_first + n_second
    x = (rng.standard_normal((t, 8)) * 0.1).astype(np.float32)
    x[:, :3] = 0.0
    x[:n_first, first] = 5.0
    x[n_first:, second] = 5.0
    router = np.zeros((8, 3), np.float32)
    router[:3, :3] = np.eye(3)
    # the model's init scales (fan-in^-0.5): outputs of order 1
    w = [(rng.standard_normal(s) * s[1] ** -0.5).astype(np.float32)
         for s in ((3, 8, 4), (3, 8, 4), (3, 4, 8))]
    return x, router, w


@pytest.mark.parametrize("first,n_first,second,n_second,slot27,zero", [
    # T 12: tokens 0-8 to expert 2 (= E - 1), 9-11 to expert 0.  Token 8
    # is dropped and still writes slot (2, 7) after token 7, its kept
    # occupant: rows 7 and 8 are zero
    (2, 9, 0, 3, 12, [7, 8]),
    # T 17: tokens 0-8 to expert 0, 9-16 to expert 2.  The drop (token 8)
    # comes first, so the occupant (token 16) writes last and keeps its
    # output: only row 8 is zero
    (0, 9, 2, 8, 16, [8]),
])
def test_moe_ffn_last_writer_of_the_drop_slot(first, n_first, second,
                                              n_second, slot27, zero):
    """A dropped pair writes (E - 1, cap - 1) with the sentinel token and
    gate 0; the last writer in flat order wins.  Both packages give the
    same slot table, and the same rows of the output are exactly zero."""
    x, router, w = _two_queues(first, n_first, second, n_second)
    t = n_first + n_second
    gates, ids = _reference_route(x, router, 1)
    assert np.asarray(ids)[:, 0].tolist() == \
        [first] * n_first + [second] * n_second
    want = _reference_dispatch(ids, gates, 3, 8)
    got = _port_dispatch(ids, gates, 3, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert want[0][2, 7] == slot27 and not want[2][8]
    jy = np.asarray(JL.moe_ffn(*(jnp.asarray(a) for a in (x, router, *w)),
                               1))
    ty = L.moe_ffn(*(torch.from_numpy(a) for a in (x, router, *w)),
                   1).numpy()
    assert [i for i in range(t) if not jy[i].any()] == zero
    assert [i for i in range(t) if not ty[i].any()] == zero
    np.testing.assert_allclose(ty, jy, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("seed,t,e,k,skew", [
    (1, 40, 5, 2, 2.0), (2, 64, 4, 2, 3.0), (3, 33, 6, 3, 1.5),
    (4, 24, 3, 1, 4.0), (5, 80, 8, 2, 5.0)])
def test_moe_dispatch_matches_the_reference_on_drops(seed, t, e, k, skew):
    """With the reference's expert ids and gates fed in, the slot table
    (token, gate) and the keep mask are the reference's, as integers and
    bits, on skewed routings that drop pairs."""
    x, router, _ = _moe_case(seed, t, 16, e, 8, k, skew)
    gates, ids = _reference_route(x, router, k)
    cap = L.moe_capacity(t, k, e)
    assert cap == max(8, int(math.ceil(t * k / e * 1.25)))
    want = _reference_dispatch(ids, gates, e, cap)
    got = _port_dispatch(ids, gates, e, cap)
    assert not want[2].all(), "the case drops nothing"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _router_near_tie(x, router, k):
    """Whether a row's k-th and (k+1)-th router logits lie within the
    near-tie gate (the reference's f32 router)."""
    logits = np.asarray(jnp.asarray(x, jnp.float32) @ jnp.asarray(router))
    top = -np.sort(-logits, axis=-1)
    return bool((top[:, k - 1] - top[:, k] < NEAR_TIE).any()) \
        if k < logits.shape[1] else False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,t,e,k,skew", [
    (11, 40, 5, 2, 2.0), (12, 7, 4, 2, 0.0), (13, 64, 6, 3, 3.0),
    (14, 30, 16, 2, 0.0)])
def test_moe_ffn_matches_the_reference(dtype, seed, t, e, k, skew):
    """Outputs within 1e-5 in f32 and 2e-2 in bf16 (the model dtype of x
    and the expert stacks; the router is f32 in both); where the two
    routers pick other experts, only at a router near tie."""
    x, router, w = _moe_case(seed, t, 32, e, 16, k, skew)
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx = jnp.asarray(x).astype(jdt)
    jw = [jnp.asarray(a).astype(jdt) for a in w]
    jy = JL.moe_ffn(jx, jnp.asarray(router), *jw, k)
    # the same rounded inputs on both sides
    tx = interop.tensor_from_numpy(np.asarray(jx), CPU)
    tw = [interop.tensor_from_numpy(np.asarray(a), CPU) for a in jw]
    ty = L.moe_ffn(tx, torch.from_numpy(router), *tw, k)
    assert ty.dtype == tdt and ty.shape == (t, 32)
    _, jids = _reference_route(np.asarray(jx.astype(jnp.float32)), router,
                               k)
    _, tids = L.moe_route(tx, torch.from_numpy(router), k)
    if not np.array_equal(np.asarray(jids), tids.numpy()):
        assert _router_near_tie(np.asarray(jx.astype(jnp.float32)), router,
                                k)
        return
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0,
                               atol=F32_ATOL if dtype == "float32"
                               else BF16_ATOL)


def test_silu_per_op_is_the_reference_silu_in_bf16():
    """The reference's bf16 silu rounds after each of exp, add, divide and
    multiply (up to 2 bf16 units from the exact value, where F.silu rounds
    once); `silu_per_op` gives its bits."""
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    jx = jnp.asarray(x * 4).astype(jnp.bfloat16)
    got = L.silu_per_op(interop.tensor_from_numpy(np.asarray(jx), CPU))
    np.testing.assert_array_equal(_np(got), _np(jax.nn.silu(jx)))


def test_moe_route_breaks_ties_to_the_lower_expert():
    x = torch.zeros((3, 4))
    router = torch.zeros((4, 6))
    gates, ids = L.moe_route(x, router, 3)
    assert ids.tolist() == [[0, 1, 2]] * 3
    torch.testing.assert_close(gates, torch.full((3, 3), 1 / 3))
    _, jids = _reference_route(np.zeros((3, 4), np.float32),
                               np.zeros((4, 6), np.float32), 3)
    assert np.asarray(jids).tolist() == ids.tolist()


def test_row_padding_does_not_reach_the_router():
    """Inside `padded_rows(n)` (a spec draft step's products) the router's
    product runs padded, but only the T real rows are routed: the
    capacity is T's and no zero row takes a slot.  Zero rows would route
    to experts 0..k-1 (a uniform softmax), so here they would fill expert
    0 past its capacity."""
    x, router, w = _moe_case(21, 4, 16, 4, 8, 2, 0.0)
    args = [torch.from_numpy(a) for a in (x, router, *w)]
    want = L.moe_ffn(*args, 2)
    with padded_rows(64):
        got = L.moe_ffn(*args, 2)
    assert torch.equal(got, want)


# ------------------------------------------------- the models, f32

@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    jp = JT.init_params(jcfg, jax.random.key(0))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


def test_moe_params_and_quantized_tree_keep_the_expert_stacks_fp():
    """The port's own draw gives the reference's MoE leaves (router f32,
    expert stacks in the model dtype), at every MoE position and only
    there; q8_0 quantizes the attention and mamba projections and the
    dense MLPs, and leaves the router and the rank-4 expert stacks fp, as
    the reference does."""
    for arch in ("granite_moe_3b", "jamba_1_5_large"):
        cfg = configs.get_smoke_config(arch)
        gen = torch.Generator().manual_seed(0)
        params = T.init_params(cfg, gen, CPU)
        nb, d, f, e = cfg.n_blocks, cfg.d_model, cfg.d_ff, cfg.n_experts
        for pos, block in enumerate(params["blocks"]):
            ffn = block["ffn"]
            if pos % cfg.moe_every == 0:
                assert ffn["router"].shape == (nb, d, e)
                assert ffn["router"].dtype == torch.float32
                assert ffn["w_gate"].shape == ffn["w_up"].shape == \
                    (nb, e, d, f)
                assert ffn["w_down"].shape == (nb, e, f, d)
                assert ffn["w_gate"].dtype == torch.bfloat16
            else:
                assert "router" not in ffn and ffn["w_gate"].shape == \
                    (nb, d, f)
        q = quantize_params(params, "q8_0")
        for pos, block in enumerate(q["blocks"]):
            moe = pos % cfg.moe_every == 0
            for name, leaf in block["ffn"].items():
                if name == "ln":
                    continue
                assert isinstance(leaf, QTensor) != moe, (arch, pos, name)
                if moe:
                    assert leaf is params["blocks"][pos]["ffn"][name]
            for sub in ("attn", "mamba"):
                if sub in block:
                    assert isinstance(block[sub].get("wq", block[sub].get(
                        "w_z")), QTensor)


def _prompt(rng, vocab, n):
    prompt = np.zeros(40, np.int32)
    prompt[:n] = rng.integers(1, vocab, n)
    return prompt


@functools.lru_cache(maxsize=None)
def _run_both(arch):
    """Prefill LENGTHS (the padded 40-token bucket routed whole, past the
    capacity of some expert) through a permuted page table, then N_STEPS
    teacher-forced decode steps (the JAX greedy token fed to both), row 1
    write-masked every third step, in f32.  Returns per-step (jax logits,
    port logits) and both final caches."""
    jcfg, tcfg, jp, tp = _setup(arch, "float32")
    rng = np.random.default_rng(4)
    jcache = JT.init_cache(jcfg, len(LENGTHS), S, page_size=PAGE)
    jcache["page_table"] = jnp.asarray(np.stack(
        [rng.permutation(S // PAGE) for _ in LENGTHS]).astype(np.int32))
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), CPU)
    jprefill = jax.jit(functools.partial(JT.prefill_into_cache, jcfg))
    jdecode = jax.jit(functools.partial(JT.decode_step, jcfg))
    out, first = [], []
    for row, n in enumerate(LENGTHS):
        prompt = _prompt(rng, jcfg.vocab, n)
        jl, jcache = jprefill(jp, jcache, jnp.asarray(prompt), row, n)
        tl, tcache = T.prefill_into_cache(tcfg, tp, tcache,
                                          torch.from_numpy(prompt), row, n)
        out.append((jl, tl))
        first.append(int(jnp.argmax(jl)))
    toks = np.asarray(first, np.int32)[:, None]
    pos = np.asarray(LENGTHS, np.int32)
    for t in range(N_STEPS):
        mask = np.array([True, t % 3 != 2])
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks),
                             positions=jnp.asarray(pos),
                             write_mask=jnp.asarray(mask))
        tl, tcache = T.decode_step(tcfg, tp, tcache, torch.from_numpy(toks),
                                   positions=torch.from_numpy(pos),
                                   write_mask=torch.from_numpy(mask))
        out.append((jl[:, -1], tl[:, -1]))
        toks = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = pos + mask.astype(np.int32)
    return out, jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_parity_f32(arch):
    """Prefill logits, then each decode step's, and every cache leaf (K/V
    pools, conv and SSM states)."""
    out, jcache, tcache = _run_both(arch)
    for i, (jl, tl) in enumerate(out):
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=LOGIT_ATOL[arch], err_msg=f"step {i}")
    for key in jcache:
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   rtol=0, atol=LOGIT_ATOL[arch], err_msg=key)


def test_prefill_bucket_drops_pairs(monkeypatch):
    """The granite smoke prefill routes its padded 40-row bucket, 80 pairs
    over 5 experts of 20 slots: some drop, so the parity above covers
    drops."""
    _, tcfg, _, tp = _setup(GRANITE, "float32")
    kept = []
    dispatch = L.moe_dispatch

    def spy(*a):
        dp = dispatch(*a)
        kept.append(bool(dp.keep.all()))
        return dp

    monkeypatch.setattr(L, "moe_dispatch", spy)
    cache = T.init_cache(tcfg, 1, S, device=CPU)
    prompt = _prompt(np.random.default_rng(4), tcfg.vocab, 37)
    T.prefill_into_cache(tcfg, tp, cache, torch.from_numpy(prompt), 0, 37)
    assert L.moe_capacity(40, tcfg.top_k, tcfg.n_experts) == 20
    assert len(kept) == tcfg.n_layers and not all(kept), kept


@pytest.mark.parametrize("arch", ["granite_moe_3b", "jamba_1_5_large"])
def test_decode_verify_parity_f32(arch):
    """The verify forward of 4 tokens per row from positions 30 and 37 (8
    rows routed together, in (b, t) order): logits, the K/V rows it
    writes and the recurrent snapshots."""
    jcfg, tcfg, jp, tp = _setup(arch, "float32")
    rng = np.random.default_rng(9)
    jcache = JT.init_cache(jcfg, 2, S, page_size=PAGE)
    for row, n in enumerate(LENGTHS):
        _, jcache = JT.prefill_into_cache(
            jcfg, jp, jcache, jnp.asarray(_prompt(rng, jcfg.vocab, n)), row,
            n)
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, jcache), CPU)
    toks = rng.integers(1, jcfg.vocab, (2, 4)).astype(np.int32)
    pos = np.asarray(LENGTHS, np.int32)
    jl, jcache, jsnaps = JT.decode_verify(jcfg, jp, jcache,
                                          jnp.asarray(toks), jnp.asarray(pos))
    tl, tcache, tsnaps = T.decode_verify(tcfg, tp, tcache,
                                         torch.from_numpy(toks),
                                         torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_ATOL[arch])
    for key in jcache:
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                   rtol=0, atol=LOGIT_ATOL[arch], err_msg=key)
    assert tsnaps.keys() == jsnaps.keys()
    for key in jsnaps:
        np.testing.assert_allclose(_np(tsnaps[key]), _np(jsnaps[key]),
                                   rtol=0, atol=LOGIT_ATOL[arch], err_msg=key)


# ------------------------------------------------------------- the servers

def _workload(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, int(rng.integers(4, 12))).astype(
        np.int32) for _ in range(N_REQ)]


@functools.lru_cache(maxsize=None)
def _servers(arch, dtype, spec=False, quant=None):
    """The JAX streamed server and the port's on its weights, drained on
    the same prompts (both in `dtype` arithmetic; `quant` a weight format
    each server applies to the same fp weights); returns (port server,
    port tokens, JAX tokens, prompts)."""
    kw = dict(spec=True, spec_k=SPEC_K, draft_arch="self:1") if spec else {}
    cfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    orig = jserve.get_smoke_config
    jserve.get_smoke_config = lambda a: cfg
    try:
        jsrv = jserve.BatchedServer(
            arch, smoke=True, batch_slots=SLOTS, max_seq=S, protocol="bs",
            stream=True, seg_len=SEG_LEN,
            quant=jsteps.QuantConfig(weights=quant) if quant else None, **kw)
    finally:
        jserve.get_smoke_config = orig
    prompts = _workload(cfg.vocab)
    for i, pr in enumerate(prompts):
        jsrv.submit(jserve.Request(i, pr, MAX_NEW))
    jsrv.run_until_drained()
    fp = (jsrv.params if quant is None
          else JT.init_params(cfg, jax.random.key(0)))
    tsrv = tserve.BatchedServer(
        arch, device="cpu", batch_slots=SLOTS, max_seq=S, protocol="bs",
        stream=True, seg_len=SEG_LEN,
        cfg=dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype),
        params=interop.params_from_jax(jax.tree.map(np.asarray, fp), CPU),
        quant=tsteps.QuantConfig(weights=quant) if quant else None, **kw)
    for i, pr in enumerate(prompts):
        tsrv.submit(tserve.Request(i, pr, MAX_NEW))
    tsrv.run_until_drained()
    assert tsrv.pages_allocated == tsrv.pages_freed
    toks = {r.rid: list(r.generated) for r in tsrv.completed}
    assert all(len(t) == MAX_NEW for t in toks.values())
    return tsrv, toks, {r.rid: list(r.generated) for r in jsrv.completed}, \
        prompts, jsrv


_JAX_ROUTES = []        # the JAX replay's router records, in call order


@functools.lru_cache(maxsize=None)
def _jax_replay_fns(cfg):
    """The JAX prefill and decode step, jitted with every MoE call
    reporting its router (expert ids, router logits) to _JAX_ROUTES, in
    order, through an ordered debug callback."""
    def record(ids, logits):
        _JAX_ROUTES.append((np.asarray(ids), np.asarray(logits)))

    def spying(fn):
        def run(*args, **kw):
            moe = JL.moe_ffn

            def spy(x, router, *a, **k):
                logits = x.astype(jnp.float32) @ router
                ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    cfg.top_k)[1]
                jax.debug.callback(record, ids, logits, ordered=True)
                return moe(x, router, *a, **k)

            JL.moe_ffn = spy          # seen by a trace, if this call traces
            try:
                return fn(*args, **kw)
            finally:
                JL.moe_ffn = moe
        return run

    return (spying(jax.jit(functools.partial(JT.prefill_into_cache, cfg))),
            spying(jax.jit(functools.partial(JT.decode_step, cfg))))


def _replay(srv, prompt, toks, jax_side):
    """Row `prompt` as the server computes it: the prefill of its padded
    bucket, then one decode step per token of `toks`, one row (a decode
    step of <= 4 rows drops nothing here, so a row's routing is its own).
    Returns (the logits after the prefill and after each step, the
    router's (expert ids, router logits) of every MoE call in order)."""
    cfg, params = srv.cfg, srv.params
    padded = np.zeros((tserve._prefill_bucket(len(prompt), S),), np.int32)
    padded[:len(prompt)] = prompt
    out = []
    if jax_side:
        prefill, decode = _jax_replay_fns(cfg)
        _JAX_ROUTES.clear()
        cache = JT.init_cache(cfg, 1, S)
        lg, cache = prefill(params, cache, jnp.asarray(padded), 0,
                            len(prompt))
        out.append(_np(lg))
        for i, tok in enumerate(toks):
            lg, cache = decode(
                params, cache, jnp.asarray([[tok]], jnp.int32),
                positions=jnp.asarray([len(prompt) + i], jnp.int32))
            out.append(_np(lg[0, -1]))
        jax.effects_barrier()
        return out, list(_JAX_ROUTES)
    routes = []
    route = L.moe_route

    def spy(x, router, k):
        gates, ids = route(x, router, k)
        routes.append((ids.numpy(), (x.float() @ router).numpy()))
        return gates, ids

    L.moe_route = spy
    try:
        cache = T.init_cache(cfg, 1, S, device=CPU)
        lg, cache = T.prefill_into_cache(cfg, params, cache,
                                         torch.from_numpy(padded), 0,
                                         len(prompt))
        out.append(_np(lg))
        for i, tok in enumerate(toks):
            lg, cache = T.decode_step(
                cfg, params, cache, torch.tensor([[tok]], dtype=torch.int32),
                positions=torch.tensor([len(prompt) + i], dtype=torch.int32))
            out.append(_np(lg[0, -1]))
    finally:
        L.moe_route = route
    return out, routes


def _first_router_flips(t_routes, j_routes, k):
    """The rows of the first MoE call at which the two routers send rows
    to other experts, each with its router margin (the k-th minus the
    (k+1)-th router logit, the smaller of the two packages'); [] if they
    never part.  Later calls are not compared: once a row takes another
    expert its hidden state moves, and the capacity queues of the rows
    after it shift, so routes part downstream of the first flip."""
    assert len(t_routes) == len(j_routes)
    for (tids, tl), (jids, jl) in zip(t_routes, j_routes):
        rows = np.flatnonzero((np.sort(tids, -1) != np.sort(jids, -1))
                              .any(-1))
        if len(rows):
            best = [[np.sort(lg[r])[::-1] for lg in (tl, jl)] for r in rows]
            return [(int(r), min(float(v[k - 1] - v[k]) for v in b))
                    for r, b in zip(rows, best)]
    return []


def _assert_near_tie_agree(tsrv, jsrv, got, want, prompts):
    """Equal streams, or streams that part at a near tie: in a replay of
    the stream's prefix as each server computes it (`_replay`), the two
    choices' logits lie within NEAR_TIE in the port's step, or else, at
    the first MoE call where the two routers send rows to other experts,
    each such row's router logits are within NEAR_TIE."""
    assert got.keys() == want.keys()
    for rid, a in got.items():
        b = want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        lg, t_routes = _replay(tsrv, prompts[rid], a[:t], False)
        gap = abs(lg[t][a[t]] - lg[t][b[t]])
        if gap < NEAR_TIE:
            continue
        # not a near tie of the logits: the routers must part upstream
        _, j_routes = _replay(jsrv, prompts[rid], a[:t], True)
        flips = _first_router_flips(t_routes, j_routes, tsrv.cfg.top_k)
        assert flips and all(m < NEAR_TIE for _, m in flips), \
            (rid, t, gap, flips)


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_server_matches_jax_f32(arch):
    tsrv, got, want, _, _ = _servers(arch, "float32")
    assert tsrv.cfg.dtype == "float32"
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_server_tokens_bf16_near_tie_gate(arch):
    tsrv, got, want, prompts, jsrv = _servers(arch, "bfloat16")
    _assert_near_tie_agree(tsrv, jsrv, got, want, prompts)


def test_granite_greedy_rows_emit_pad_ids_as_the_reference():
    """Greedy decoding takes the argmax over the padded vocabulary (768
    rows for granite's 515), in the reference and in the port: with
    random weights some greedy tokens are pad ids, the same ones."""
    tsrv, got, want, _, _ = _servers(GRANITE, "float32")
    assert tsrv.cfg.vocab == 515 and tsrv.cfg.padded_vocab == 768
    pads = [t for toks in want.values() for t in toks if t >= 515]
    assert pads and got == want


def test_granite_sampled_rows_never_emit_pad_ids():
    srv = tserve.BatchedServer(GRANITE, device="cpu", batch_slots=SLOTS,
                               max_seq=S, stream=True, seg_len=SEG_LEN)
    for i, pr in enumerate(_workload(srv.cfg.vocab)):
        srv.submit(tserve.Request(i, pr, MAX_NEW, sampling=(
            tserve.SamplingParams(temperature=1.5, seed=i))))
    srv.run_until_drained()
    toks = [t for r in srv.completed for t in r.generated]
    assert len(toks) == N_REQ * MAX_NEW and max(toks) < srv.cfg.vocab


def test_granite_spec_server_matches_jax_spec_server_f32():
    """The spec server (self:1 draft, spec_k 2): a verify routes 2 x 3
    rows together, so it can drop pairs a decode step keeps; its tokens
    and accept counts are held to the JAX spec server's, not to the
    non-spec stream."""
    tsrv, got, want, _, jsrv = _servers(GRANITE, "float32", spec=True)
    assert got == want
    assert (tsrv.draft_accepted, tsrv.draft_proposed) == \
        (jsrv.draft_accepted, jsrv.draft_proposed)
    assert tsrv.draft_proposed > 0


def test_granite_q8_0_matches_jax_up_to_near_ties():
    """Both servers quantize the same fp weights to q8_0: the attention
    projections go through the dequant-fused matmul, the router and the
    expert stacks stay fp (the same tensors as the fp tree's)."""
    tsrv, got, want, prompts, jsrv = _servers(GRANITE, "bfloat16",
                                              quant="q8_0")
    ffn = tsrv.params["blocks"][0]["ffn"]
    assert all(isinstance(tsrv.params["blocks"][0]["attn"][n], QTensor)
               for n in ("wq", "wk", "wv", "wo"))
    assert all(isinstance(ffn[n], torch.Tensor)
               for n in ("router", "w_gate", "w_up", "w_down"))
    jffn = jsrv.params["blocks"][0]["ffn"]
    for n in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(_np(ffn[n]), _np(jffn[n]))
    _assert_near_tie_agree(tsrv, jsrv, got, want, prompts)


# ------------------------------------------------------------ the examples

def test_serve_offload_serves_jamba_among_its_families():
    assert "jamba_1_5_large" in serve_offload.FAMILIES
    toks = serve_offload.serve_family("jamba_1_5_large", device="cpu")
    assert sorted(toks) == [0, 1, 2]
    assert all(len(t) == 8 for t in toks.values())


def test_serve_cli_runs_granite_q8_0_int8(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", GRANITE, "--device", "cpu", "--stream",
        "--quant-weights", "q8_0", "--quant-kv", "int8", "--requests", "3",
        "--slots", "2", "--max-seq", "64", "--max-new", "6"])
    assert tserve.main() == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "arch=granite_moe_3b_smoke" in line and "quant=q8_0/int8" in line
