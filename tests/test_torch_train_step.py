"""Parity of the port's training forward and gradients with the JAX
package at smoke size, for all eleven archs at B 2 x S 32 (the batch of
`tests/test_archs.py::test_smoke_train_step`, from the reference's
`synth_batch`), on the JAX package's own weights crossed over through
`repro_torch.interop`, in float32 (`dtype="float32"` in both packages):
`steps.loss_and_grads` against the jitted `jax.value_and_grad` of the
reference's `loss_fn`, and `logits_fn` against the reference's.  The
bf16 gradients are in test_torch_train_step_bf16.py, three optimizer
steps in test_torch_train_steps.py.

Tolerances: the loss within rtol 1e-5; every gradient leaf within rtol
1e-4 and atol 1e-5 x the leaf's max |reference| (the same f32 products
and sums in another order), atol 1e-4 x for jamba_1_5_large, whose
8-layer hybrid stack amplifies a rounding ~25x more than the others' do
(its bf16 gradients stand 54% from its f32 ones in JAX, the others'
1.3-15%); the logits within atol 1e-4, 2e-4 for jamba (as
tests/test_torch_moe.py).  Inside the port, remat on == off bitwise
(the loss and every gradient leaf).
"""
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
from repro_torch.models import transformer as T               # noqa: E402
from repro_torch.models.registry import get_model             # noqa: E402

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


# the f32 gradient atol, x the leaf's max |reference|, and the logits'
GRAD_ATOL = {"jamba_1_5_large": 1e-4}
LOGIT_ATOL = {"jamba_1_5_large": 2e-4}


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    jcfg, _, jp = _setup(arch, "float32")
    (loss, _), grads = jax.jit(jax.value_and_grad(
        functools.partial(jax_model(jcfg).loss_fn, jcfg), has_aux=True))(
            jp, _to_j(_batch_np(jcfg)))
    return float(loss), jax.tree_util.tree_flatten_with_path(grads)[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_f32(arch):
    jloss, jgrads = _jax_grads(arch)
    tloss, tgrads = _port_grads(arch, "float32")
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert len(tgrads) == len(jgrads)
    for (path, j), t in zip(jgrads, tgrads):
        j, t = _np(j), _np(t)
        assert t.shape == j.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            t, j, rtol=1e-4, atol=GRAD_ATOL.get(arch, 1e-5) * np.abs(j).max(),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logits_fn_f32(arch):
    jcfg, tcfg, jp = _setup(arch, "float32")
    batch = _batch_np(jcfg)
    want = jax.jit(functools.partial(jax_model(jcfg).logits_fn, jcfg))(
        jp, _to_j(batch))
    got = get_model(tcfg).logits_fn(tcfg, _port_params(jp), _to_t(batch))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=LOGIT_ATOL.get(arch, 1e-4))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_is_bitwise_no_remat(arch, monkeypatch):
    """The loss and every gradient leaf with each block recomputed in the
    backward equal those with every activation kept, bit for bit."""
    with_remat = _port_grads(arch, "bfloat16")
    calls = []

    def run_block(fn, remat, *args):
        calls.append(remat)
        return fn(*args)

    monkeypatch.setattr(T, "run_block", run_block)
    without = _port_grads(arch, "bfloat16")
    assert calls and all(calls)          # the loss asks for remat
    assert with_remat[0] == without[0]
    for a, b in zip(with_remat[1], without[1]):
        assert torch.equal(a, b)
