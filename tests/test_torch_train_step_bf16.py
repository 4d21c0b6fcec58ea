"""Parity of the port's gradients with the JAX package in bfloat16 (the
smoke dtype), for all eleven archs at B 2 x S 32 (the batch of
`tests/test_archs.py::test_smoke_train_step`), on the JAX package's own
weights crossed over through `repro_torch.interop`.

The two packages round other intermediates to bf16 (XLA fuses and may
keep f32 between ops), and a random-weight stack amplifies each
rounding, by arch very differently: JAX's own bf16 gradients stand
1.3-15% from its f32 ones (L2, the worst leaf), jamba's 8 layers 54%.
So the port's bf16 gradients are held to the f32 truth no worse than
JAX's bf16 ones are: for every leaf, in L2,
    |port_bf16 - port_f32| <= 1.5 |jax_bf16 - port_f32| + 1e-3 |port_f32|
(the port's f32 gradients equal JAX's within 1e-4 of a leaf's max,
test_torch_train_step.py), and the loss within 2e-3 relative of JAX's
bf16 loss.  The MoE archs run routed alike: the port takes each MoE
layer's expert ids from the JAX step (reported through an unordered
debug callback, which the backward's recomputation repeats with the same
ids) and its own gates at those ids, since at a router near tie one bf16
unit sends a row to another expert.
"""
import collections
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import ARCH_IDS                            # noqa: E402
from repro.configs import get_smoke_config as jax_smoke       # noqa: E402
from repro.data.pipeline import DataConfig, synth_batch      # noqa: E402
from repro.models.registry import get_model as jax_model      # noqa: E402
from repro_torch import interop, tree                         # noqa: E402
from repro_torch.configs import get_smoke_config              # noqa: E402
from repro_torch.launch import steps as tsteps                # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro_torch.models import layers as L                    # noqa: E402

B, S = 2, 32
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: faster at smoke size, and it leaves the cores
    to the other test processes.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_np(cfg, step=0):
    dcfg = DataConfig(vocab=cfg.vocab, batch=B, seq_len=S,
                      frontend=cfg.frontend, d_model=cfg.d_model,
                      enc_dec=cfg.enc_dec, enc_len=S if cfg.enc_dec else 0)
    return synth_batch(dcfg, step)


def _to_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = jax_model(jcfg).init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp


def _port_params(jp):
    return interop.params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def _port_grads(arch, dtype):
    jcfg, tcfg, jp = _setup(arch, dtype)
    loss, _, grads = tsteps.loss_and_grads(tcfg, _port_params(jp),
                                           _to_t(_batch_np(jcfg)))
    return float(loss), tree.leaves(grads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


_ROUTES = collections.defaultdict(list)


def _record(key, ids):
    _ROUTES[np.asarray(key).tobytes()].append(np.asarray(ids))


def _jax_grads_bf16(arch):
    """JAX's (loss, gradient leaves with their paths, routes): the jitted
    `value_and_grad` of the reference's loss_fn, each MoE call reporting
    its layer (the router's first four values) and its expert ids."""
    jcfg, _, jp = _setup(arch, "bfloat16")
    moe = JL.moe_ffn_dist

    def spy(x, router, *a, **k):
        logits = x.astype(jnp.float32) @ router.astype(jnp.float32)
        ids = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)[1]
        jax.debug.callback(_record, router[0, :4], ids)
        return moe(x, router, *a, **k)

    _ROUTES.clear()
    JL.moe_ffn_dist = spy
    try:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            functools.partial(jax_model(jcfg).loss_fn, jcfg),
            has_aux=True))(jp, _to_j(_batch_np(jcfg)))
        jax.effects_barrier()
    finally:
        JL.moe_ffn_dist = moe
    routes = {}
    for key, seen in _ROUTES.items():
        assert all(np.array_equal(s, seen[0]) for s in seen), arch
        routes[key] = seen[0]
    return (float(loss), jax.tree_util.tree_flatten_with_path(grads)[0],
            routes)


def _routed_like(routes):
    """A stand-in for the port's `moe_route` that takes each layer's
    expert ids from `routes` and computes its own gates at them."""
    def route(x, router, k):
        key = router[0, :4].detach().float().numpy().tobytes()
        ids = torch.from_numpy(routes[key].astype(np.int64))
        with L.true_f32():
            probs = torch.softmax(x.float() @ router.float(), dim=-1)
        gates = probs.gather(1, ids)
        return gates / gates.sum(dim=-1, keepdim=True), ids
    return route


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_bf16(arch, monkeypatch):
    jloss, jgrads, routes = _jax_grads_bf16(arch)
    _, truth = _port_grads(arch, "float32")
    if jax_smoke(arch).is_moe:
        assert routes, arch
        monkeypatch.setattr(L, "moe_route", _routed_like(routes))
    tloss, tgrads = _port_grads(arch, "bfloat16")
    assert tloss == pytest.approx(jloss, rel=2e-3)
    assert len(tgrads) == len(jgrads) == len(truth)
    for (path, j), t, f in zip(jgrads, tgrads, truth):
        j, t, f = _np(j), _np(t), _np(f)
        ours, theirs = np.linalg.norm(t - f), np.linalg.norm(j - f)
        assert ours <= 1.5 * theirs + 1e-3 * np.linalg.norm(f), (
            jax.tree_util.keystr(path), ours, theirs)
