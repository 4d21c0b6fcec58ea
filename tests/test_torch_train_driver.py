"""The port's training substrate on the CPU: the data pipeline, AdamW, the
int8 error-feedback compression, the checkpoints and the training driver
(`repro_torch.data`, `optim`, `checkpoint`, `launch/train.py`).  The
twelve tests of `tests/test_substrate.py`, ported, plus:
  * `synth_batch` bitwise the reference's (plain, enc-dec, patch);
  * AdamW and the compression against the JAX package on a random tree
    of f32 and bf16 leaves (the int8 payloads and scales equal);
  * a run preempted after 6 steps (SIGTERM, in a process of its own) and
    resumed to 8 == an uninterrupted 8-step run, bit for bit, in every
    loss and in every leaf of the final checkpoint (params, AdamW state,
    residual); the same after a SIGTERM at step 2;
  * `train` refuses to run without a GPU unless asked for the CPU.

Tolerances against JAX: AdamW's parameters, moments and master within
rtol 1e-5 and atol 1e-7 (the same f32 elementwise operations; XLA may
fuse a multiply and an add).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.data import pipeline as jpipe                      # noqa: E402
from repro.optim import adamw as jadamw                       # noqa: E402
from repro.optim import compression as jcomp                  # noqa: E402
from repro_torch import interop, tree                         # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_lib           # noqa: E402
from repro_torch.data.pipeline import (DataConfig, make_pipeline,  # noqa
                                       synth_batch)
from repro_torch.launch import train as train_mod             # noqa: E402
from repro_torch.launch.train import train                    # noqa: E402
from repro_torch.optim import adamw, compression              # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
RUN = dict(smoke=True, batch=2, seq_len=16, ckpt_every=3, log_every=100,
           device=CPU)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the preempted run's own process has: the
    same reductions, so the same bits.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ data

def test_pipeline_deterministic_and_resumable():
    cfg = DataConfig(vocab=128, batch=4, seq_len=16, seed=3)
    a = [synth_batch(cfg, s)["tokens"] for s in range(5)]
    b = [synth_batch(cfg, s)["tokens"] for s in range(5)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # an iterator from step 3 yields exactly batch 3, 4, ...
    it = make_pipeline(cfg, start_step=3, device=CPU)
    step, batch = next(it)
    assert step == 3
    np.testing.assert_array_equal(batch["tokens"].numpy(), a[3])


def test_pipeline_prefetch_depth_and_labels():
    cfg = DataConfig(vocab=64, batch=2, seq_len=8)
    it = make_pipeline(cfg, depth=3, device=CPU)
    step, batch = next(it)
    assert len(it.ring) == 3                       # the producer ran ahead
    toks, labs = batch["tokens"].numpy(), batch["labels"].numpy()
    np.testing.assert_array_equal(labs[:, :-1], toks[:, 1:])
    assert (labs[:, -1] == 0).all()
    assert it.ring[0][0] == 1 and it.ring[-1][0] == 3


@pytest.mark.parametrize("kind", ["plain", "enc_dec", "patch"])
def test_synth_batch_is_the_reference_bitwise(kind):
    kw = dict(vocab=515, batch=3, seq_len=24, seed=5, d_model=16)
    if kind == "enc_dec":
        kw.update(enc_dec=True, enc_len=12)
    elif kind == "patch":
        kw.update(frontend="patch")
    for step in (0, 7, 1_000_003):
        got = synth_batch(DataConfig(**kw), step)
        want = jpipe.synth_batch(jpipe.DataConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_pipeline_refuses_cuda_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_pipeline(DataConfig(vocab=8, batch=1, seq_len=4))


# ------------------------------------------------------------------ optim

def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                            weight_decay=0.0)
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    for _ in range(200):
        grads = {"w": params["w"] - target}
        params, state, _ = adamw.apply(cfg, params, grads, state)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_adamw_clips_global_norm():
    cfg = adamw.AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    _, _, metrics = adamw.apply(cfg, params, {"w": torch.full((4,), 100.0)},
                                state)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_adamw_master_is_a_copy_of_f32_leaves():
    """An f32 leaf's master is its own tensor: the in-place master update
    leaves the parameter alone."""
    params = {"f": torch.ones(3), "h": torch.ones(3, dtype=torch.bfloat16)}
    state = adamw.init(params)
    assert state.master["f"].data_ptr() != params["f"].data_ptr()
    new, state, _ = adamw.apply(adamw.AdamWConfig(lr=0.5), params,
                                {"f": torch.ones(3),
                                 "h": torch.ones(3, dtype=torch.bfloat16)},
                                state)
    assert torch.equal(params["f"], torch.ones(3))
    assert new["h"].dtype == torch.bfloat16 and new["f"].dtype == \
        torch.float32
    assert new["f"].data_ptr() != state.master["f"].data_ptr()


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32) * 3,
                  "d": rng.standard_normal((2, 6)).astype(np.float32)}}


def test_adamw_matches_jax_on_a_random_tree():
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=6, weight_decay=0.1,
               clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, _random_tree(0))
    jp["b"]["d"] = jp["b"]["d"].astype(jnp.bfloat16)
    tp = interop.tree_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    js, ts = jadamw.init(jp), adamw.init(tp)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for step in range(6):
        g = _random_tree(100 + step)
        jg = jax.tree.map(jnp.asarray, g)
        tg = interop.tree_from_numpy(g, CPU)
        jp, js, jm = jax.jit(jadamw.apply, static_argnums=0)(jcfg, jp, jg,
                                                               js)
        tp, ts, tm = adamw.apply(tcfg, tp, tg, ts)
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-6), (step, key)
    assert int(ts.step) == int(js.step) == 6
    for jt, tt in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu),
                   (js.master, ts.master)):
        for j, t in zip(jax.tree.leaves(jt),
                        tree.leaves(interop.tree_to_numpy(tt))):
            np.testing.assert_allclose(t, np.asarray(j, np.float32),
                                       rtol=1e-5, atol=1e-7)


def test_compression_matches_jax_on_a_random_tree():
    """The int8 payloads and scales are the reference's bit for bit; the
    dequantized gradients and residuals over three steps too."""
    for seed in range(3):
        x = _random_tree(seed)["a"] * 10 ** seed
        q, scale = compression.quantize(torch.from_numpy(x))
        jq, jscale = jcomp._quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
    params = interop.tree_from_numpy(_random_tree(0), CPU)
    ts, js = compression.init(params), jcomp.init(
        jax.tree.map(jnp.asarray, _random_tree(0)))
    for step in range(3):
        g = _random_tree(200 + step)
        tdeq, ts = compression.compress_grads(
            interop.tree_from_numpy(g, CPU), ts)
        jdeq, js = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), js)
        for jt, tt in ((jdeq, tdeq), (js.residual, ts.residual)):
            for j, t in zip(jax.tree.leaves(jt),
                            tree.leaves(interop.tree_to_numpy(tt))):
                np.testing.assert_array_equal(t, np.asarray(j))


def test_compression_error_feedback_telescopes():
    """The dequantized gradients sum to the true ones (bias-free)."""
    gen = torch.Generator().manual_seed(0)
    state = compression.init({"w": torch.zeros(256)})
    true_sum, deq_sum = torch.zeros(256), torch.zeros(256)
    for _ in range(30):
        g = {"w": torch.randn(256, generator=gen)}
        deq, state = compression.compress_grads(g, state)
        true_sum += g["w"]
        deq_sum += deq["w"]
    # the residual carries the outstanding error: the totals match within
    # one quantization step's worth of noise a coordinate
    err = float((deq_sum - true_sum).abs().max())
    scale = float(true_sum.abs().max()) / 127
    assert err <= 5 * scale + 0.05


def test_compression_wire_bytes():
    grads = {"a": torch.zeros(100), "b": torch.zeros(50)}
    assert compression.compressed_bytes(grads) == 150 + 8


# ------------------------------------------------------------------ ckpt

def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_bf16(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 10, _tree())
    got = ckpt_lib.restore(d, _tree())
    assert got is not None
    step, restored = got
    assert step == 10
    assert restored["b"].dtype == torch.bfloat16
    for key, leaf in _tree().items():
        assert torch.equal(restored[key], leaf), key
    assert (tmp_path / "latest").read_text() == "step_00000010.ckpt"


def test_checkpoint_latest_and_gc(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt_lib.save(d, s, _tree(), keep=2)
    assert ckpt_lib.available_steps(d) == [4, 5]
    step, _ = ckpt_lib.restore(d, _tree())
    assert step == 5
    assert ckpt_lib.restore(d, _tree(), step=4)[0] == 4
    assert ckpt_lib.restore(str(tmp_path / "none"), _tree()) is None


def test_checkpoint_falls_back_on_corruption(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 1, _tree())
    ckpt_lib.save(d, 2, _tree())
    # truncate the newest file (a crash mid-write on a non-atomic remote
    # filesystem)
    with open(os.path.join(d, "step_00000002.ckpt"), "wb") as f:
        f.write(b"garbage")
    step, _ = ckpt_lib.restore(d, _tree())
    assert step == 1


def test_checkpoint_restores_onto_a_device_and_checks_leaves(tmp_path):
    """The leaves land on the device asked for (the reference's
    shardings); a tree of another leaf count is refused."""
    d = str(tmp_path)
    ckpt_lib.save(d, 3, _tree())
    step, restored = ckpt_lib.restore(d, _tree(), device=torch.device(CPU))
    assert step == 3
    assert all(leaf.device == torch.device(CPU)
               for leaf in tree.leaves(restored))
    with pytest.raises(ValueError):
        ckpt_lib.restore(d, {"w": torch.zeros(1)})


# ------------------------------------------------------------ train driver

def test_train_driver_checkpoint_restart(tmp_path):
    d = str(tmp_path / "ck")
    out1 = train("mamba2_370m", steps=6, ckpt_dir=d, **RUN)
    assert out1["steps_run"] == 6
    # resume: nothing left to do
    out2 = train("mamba2_370m", steps=6, ckpt_dir=d, **RUN)
    assert out2["steps_run"] == 0
    # extend the run: resumes from step 6, runs 2 more
    out3 = train("mamba2_370m", steps=8, ckpt_dir=d, **RUN)
    assert out3["steps_run"] == 2


def test_train_with_compression_decreases_loss():
    out = train("starcoder2_3b", smoke=True, steps=25, batch=4, seq_len=32,
                compress=True, lr=3e-3, log_every=100, device=CPU)
    assert out["last_loss"] < out["first_loss"]


def test_train_refuses_without_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train("mamba2_370m", steps=1, batch=1, seq_len=8)
    with pytest.raises(RuntimeError):
        train("mamba2_370m", steps=1, batch=1, seq_len=8, device="cuda")
    assert train("mamba2_370m", steps=1, batch=1, seq_len=8,
                 device=CPU)["steps_run"] == 1


# A training run in a process of its own that raises SIGTERM on itself
# when the pipeline hands out batch `stop` (the step then finishes, its
# checkpoint is written and the loop ends, as on a preempted host).
PREEMPTED = """
import json, signal, sys, torch
from repro_torch.launch import train as tr
torch.set_num_threads(1)
stop, ckpt_dir, steps = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
pipeline = tr.make_pipeline

def make_pipeline(*args, **kw):
    it = pipeline(*args, **kw)

    def gen():
        for step, batch in it:
            if step == stop:
                signal.raise_signal(signal.SIGTERM)
            yield step, batch
    return gen()

tr.make_pipeline = make_pipeline
out = tr.train("mamba2_370m", steps=steps, ckpt_dir=ckpt_dir, smoke=True,
               batch=2, seq_len=16, ckpt_every=3, log_every=100,
               device="cpu")
print(json.dumps(out))
"""


def _preempted(stop, ckpt_dir, steps=8):
    proc = subprocess.run(
        [sys.executable, "-c", PREEMPTED, str(stop), ckpt_dir, str(steps)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "preempted" in proc.stdout
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _final_leaves(ckpt_dir, step=8):
    return ckpt_lib._load_file(
        os.path.join(ckpt_dir, f"step_{step:08d}.ckpt"))[1]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("whole"))
    out = train("mamba2_370m", steps=8, ckpt_dir=d, **RUN)
    return out, _final_leaves(d)


def _assert_same_run(losses, leaves, uninterrupted):
    out, want = uninterrupted
    assert losses == out["losses"]                 # floats, bit for bit
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_resumed_equals_uninterrupted_bitwise(tmp_path, uninterrupted):
    """Preempted after its 6th step (the reference's schedule spans the
    `steps` asked for, so the 8-step run is the one stopped), resumed with
    steps=6 (nothing to do) and then to 8: steps run 6 / 0 / 2, and the
    losses and the final checkpoint equal the uninterrupted run's."""
    d = str(tmp_path / "ck")
    first = _preempted(5, d)
    assert first["steps_run"] == 6
    assert ckpt_lib.available_steps(d) == [3, 6]
    assert train("mamba2_370m", steps=6, ckpt_dir=d, **RUN)["steps_run"] \
        == 0
    rest = train("mamba2_370m", steps=8, ckpt_dir=d, **RUN)
    assert rest["steps_run"] == 2
    _assert_same_run(first["losses"] + rest["losses"], _final_leaves(d),
                     uninterrupted)


def test_sigterm_mid_run_checkpoints_and_resumes(tmp_path, uninterrupted):
    d = str(tmp_path / "ck")
    first = _preempted(1, d)
    assert first["steps_run"] == 2
    assert ckpt_lib.available_steps(d) == [2]
    rest = train("mamba2_370m", steps=8, ckpt_dir=d, **RUN)
    assert rest["steps_run"] == 6
    _assert_same_run(first["losses"] + rest["losses"], _final_leaves(d),
                     uninterrupted)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    assert train_mod.main(["--device", "cpu", "--arch", "mamba2_370m",
                           "--steps", "2", "--batch", "2", "--seq-len", "16",
                           "--ckpt-dir", d]) == 0
    assert "[train] done: 2 steps" in capsys.readouterr().out
    assert ckpt_lib.available_steps(d) == [2]
