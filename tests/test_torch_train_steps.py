"""Three `make_train_step` steps of the port against the JAX package's,
at smoke size in float32, with and without int8 error-feedback gradient
compression, for starcoder2_3b, mamba2_370m and granite_moe_3b (B 2 x S
32, batches 0, 1, 2 of the reference's `synth_batch`, AdamW lr 1e-3
with one warmup step), from the JAX package's own weights crossed over
through `repro_torch.interop`.

Tolerances: the metrics (loss, ce, aux, grad_norm, lr) within rtol
1e-4.  Every leaf of the parameters, mu, nu and the master within rtol
2e-4 and atol 1e-5 x its max |reference|, and of the residual (a
rounding error, at most half a quantum, max |g| / 254: against it a
gradient element's f32 spread weighs 254x more; mamba's 16-element
dt_bias residual parts by 2.5% of its max after three steps) within
atol 5e-2 x its max, except
for a few elements that two f32 gradients a rounding apart send other
ways: Adam's g / sqrt(v) steps a gradient element near zero by about
+-lr whatever its size, and the int8 compression rounds an element
within one f32 unit of a .5 boundary to the other integer.  Such
elements may be at most 0.1% of a leaf (0.5% with compression, where
one flip changes the next steps' residual), the parameters and the
master within 3 lr of the reference there, the moments within 5% of
their leaf's max, the residual within one quantum (2x its leaf's max).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_smoke_config as jax_smoke       # noqa: E402
from repro.data.pipeline import DataConfig, synth_batch      # noqa: E402
from repro.models.registry import get_model as jax_model      # noqa: E402
from repro_torch import interop, tree                         # noqa: E402
from repro_torch.configs import get_smoke_config              # noqa: E402
from repro_torch.launch import steps as tsteps                # noqa: E402
from repro.launch import steps as jsteps                      # noqa: E402
from repro.optim import adamw as jadamw                       # noqa: E402
from repro.optim import compression as jcomp                  # noqa: E402
from repro_torch.optim import adamw, compression              # noqa: E402

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


ARCHS = ("starcoder2_3b", "mamba2_370m", "granite_moe_3b")
LR = 1e-3
# the largest |port - reference| where an element was sent another way,
# by kind of leaf: (a multiple of LR, a multiple of the leaf's max)
BOUND = {"params": (3, 0), "master": (3, 0), "mu": (0, 0.05),
         "nu": (0, 0.05), "residual": (0, 2.01)}
# the atol, x the leaf's max
ATOL = {"residual": 5e-2}


def _assert_close(t, j, name, compress, what):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, what
    diff = np.abs(t - j)
    top = max(float(np.abs(j).max()), float(np.abs(t).max()))
    off = diff > 2e-4 * np.abs(j) + ATOL.get(name, 1e-5) * top
    assert off.mean() <= (5e-3 if compress else 1e-3), (
        what, int(off.sum()), t.size)
    lr_x, max_x = BOUND[name]
    assert diff.max() <= lr_x * LR + max_x * top, (what, diff.max())


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, compress):
    jcfg, tcfg, jp = _setup(arch, "float32")
    opt = dict(lr=LR, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jadamw.AdamWConfig(**opt), compress_grads=compress))
    tstep = tsteps.make_train_step(tcfg, adamw.AdamWConfig(**opt),
                                   compress_grads=compress)
    tp = _port_params(jp)
    jstate = (jp, jadamw.init(jp), jcomp.init(jp) if compress else None)
    tstate = (tp, adamw.init(tp),
              compression.init(tp) if compress else None)
    for step in range(3):
        batch = _batch_np(jcfg, step)
        *jstate, jm = jstep(*jstate, _to_j(batch))
        *tstate, tm = tstep(*tstate, _to_t(batch))
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(
                float(jm[key]), rel=1e-4, abs=1e-7), (step, key)
    jparams, jopt_state, jcomp_state = jstate
    tparams, topt_state, tcomp_state = tstate
    assert int(topt_state.step) == int(jopt_state.step) == 3
    pairs = [("params", jparams, tparams),
             ("mu", jopt_state.mu, topt_state.mu),
             ("nu", jopt_state.nu, topt_state.nu),
             ("master", jopt_state.master, topt_state.master)]
    if compress:
        pairs.append(("residual", jcomp_state.residual,
                      tcomp_state.residual))
    for name, jt, tt in pairs:
        jl = jax.tree_util.tree_flatten_with_path(jt)[0]
        tl = tree.leaves(interop.tree_to_numpy(tt))
        assert len(jl) == len(tl), name
        for (path, j), t in zip(jl, tl):
            _assert_close(t, j, name, compress,
                          f"{name}{jax.tree_util.keystr(path)}")
