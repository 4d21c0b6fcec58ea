"""Fault-tolerant training driver, the port of `repro/launch/train.py`, on
one device or on a DATAxMODEL mesh of ranks.

  * checkpoint / restart: atomic checkpoints every --ckpt-every steps and
    at the end, resume from the latest on start (the data pipeline
    resumes bit-exactly from the step index).
  * preemption safety: SIGTERM / SIGINT set a flag; the step running
    finishes, a checkpoint is written and the loop exits (the handlers
    are installed only when `train` runs in the main thread).
  * straggler watchdog: a thread flags steps longer than `factor` x the
    trailing median step time, and counts them.
  * int8 error-feedback gradient compression (--compress), bf16 params
    with an f32 AdamW master, per-block recomputation in the backward.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch mamba2_370m --smoke --steps 6 --ckpt-dir /tmp/ck

It runs on the GPU unless `--device cpu` is given, and raises when no GPU
is present and none was asked for.

On a mesh (`train(..., mesh=)`, `--mesh DATAxMODEL` under torchrun, one
process a rank, gloo) every rank draws the weights from seed 0 and keeps
its shards (`partition.param_specs` under `make_plan(train=True)`; the
rules `ShardingRules(mesh, seq_shard_acts=True)`), takes its rows of each
global batch (`partition.batch_specs`) and steps on them
(`steps.make_train_step(layout=)`): the loss, gradients and updated state
are the single device's within f32 rounding, except where the
reference's expert-parallel MoE (`layers.moe_ffn_dist`) changes them.
The checkpoint holds whole leaves (a mesh-agnostic file, written by rank
0), and every rank restores its shards from it.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --mesh 2x2 --steps 6 --batch 4 --seq-len 32
"""
from __future__ import annotations

import argparse
import signal
import statistics
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.backstream import WIRE
from repro_torch.data.pipeline import DataConfig, make_pipeline, synth_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import partition
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import rank_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw, compression
from repro_torch.sharding import ShardingRules, TrainLayout


class StragglerWatchdog:
    """Flags steps running longer than factor x the trailing median."""

    def __init__(self, factor: float = 3.0, window: int = 20,
                 min_steps: int = 5):
        self.factor = factor
        self.window = window
        self.min_steps = min_steps
        self.durations: List[float] = []
        self.flagged = 0
        self._deadline: Optional[float] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def step_started(self) -> None:
        if len(self.durations) >= self.min_steps:
            med = statistics.median(self.durations[-self.window:])
            self._deadline = time.monotonic() + self.factor * med
        else:
            self._deadline = None

    def step_finished(self, dt: float) -> None:
        self.durations.append(dt)
        self._deadline = None

    def _watch(self) -> None:
        while not self._stop.wait(0.05):
            d = self._deadline
            if d is not None and time.monotonic() > d:
                self.flagged += 1
                print(f"[straggler] step exceeded {self.factor}x median; "
                      "re-dispatch hook fired", flush=True)
                self._deadline = None

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)


class TrainState:
    def __init__(self, params, opt_state, comp_state):
        self.params = params
        self.opt_state = opt_state
        self.comp_state = comp_state

    def tree(self) -> Dict[str, Any]:
        t = {"params": self.params, "opt": self.opt_state}
        if self.comp_state is not None:
            t["comp"] = self.comp_state
        return t


def train(arch_id: str, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq_len: int = 128, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, compress: bool = False, mesh: Any = None,
          lr: float = 1e-3, log_every: int = 10,
          device: Optional[Union[str, torch.device]] = None,
          cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """Train `arch_id` (its smoke or full config, or `cfg` when given:
    the example's ~100M config) for `steps` steps from the latest
    checkpoint in `ckpt_dir`, weights drawn from seed 0, on one device or
    as this rank of `mesh` (a ("data", "model") DeviceMesh).  Returns the
    summary {"arch", "steps_run", "first_loss", "last_loss",
    "stragglers_flagged", "losses"}."""
    dev = resolve_device(device) if mesh is None else rank_device(device)
    if cfg is None:
        cfg = get_smoke_config(arch_id) if smoke else get_config(arch_id)
    model = get_model(cfg)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                                total_steps=steps)
    dcfg = DataConfig(vocab=cfg.vocab, batch=batch, seq_len=seq_len,
                      frontend=cfg.frontend, d_model=cfg.d_model,
                      enc_dec=cfg.enc_dec,
                      enc_len=min(cfg.enc_len, seq_len) if cfg.enc_dec else 0)

    params = model.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    layout = state_specs = b_specs = None
    if mesh is not None:
        layout = mesh_layout(cfg, mesh, params, synth_batch(dcfg, 0))
        b_specs = layout.batch
        params = partition.shard_tree(params, layout.params, mesh)
        state_specs = {"params": layout.params,
                       "opt": partition.opt_state_specs(None, layout.params),
                       "comp": compression.CompressionState(layout.params)}
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, compress_grads=compress,
                                        layout=layout)
    state = TrainState(params, adamw.init(params),
                       compression.init(params) if compress else None)
    say = mesh is None or dist.get_rank() == 0

    def tree_specs():
        if state_specs is None:
            return None
        return {k: state_specs[k] for k in state.tree()}

    start_step = 0
    if ckpt_dir:
        got = ckpt_lib.restore(ckpt_dir, state.tree(), device=dev,
                               shardings=tree_specs(), mesh=mesh)
        if got is not None:
            start_step, restored = got
            state.params, state.opt_state = (restored["params"],
                                             restored["opt"])
            if compress:
                state.comp_state = restored.get("comp", state.comp_state)
            if say:
                print(f"[train] resumed from step {start_step}", flush=True)

    # preemption safety: checkpoint on SIGTERM / SIGINT, then stop
    preempted = threading.Event()

    def _on_signal(signum, frame):
        preempted.set()

    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _on_signal)

    watchdog = StragglerWatchdog()
    pipe = make_pipeline(dcfg, start_step=start_step, device=dev,
                         specs=b_specs, mesh=mesh)
    losses: List[float] = []
    try:
        for _ in range(start_step, steps):
            step_i, batch_data = next(pipe)
            watchdog.step_started()
            t0 = time.monotonic()
            state.params, state.opt_state, state.comp_state, metrics = \
                step_fn(state.params, state.opt_state, state.comp_state,
                        batch_data)
            loss = float(metrics["loss"])         # the step's one sync
            watchdog.step_finished(time.monotonic() - t0)
            losses.append(loss)
            if step_i % log_every == 0 and say:
                print(f"[train] step {step_i} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            done = step_i + 1
            stop = preempted.is_set()
            if mesh is not None:           # every rank stops at one step
                flag = torch.tensor([int(stop)])
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop = bool(flag.item())
            if ckpt_dir and (done % ckpt_every == 0 or done == steps
                             or stop):
                ckpt_lib.save(ckpt_dir, done, state.tree(),
                              shardings=tree_specs(), mesh=mesh)
            if stop:
                if say:
                    print(f"[train] preempted at step {done}; "
                          "checkpoint written", flush=True)
                break
    finally:
        watchdog.close()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    return {"arch": arch_id, "steps_run": len(losses),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "stragglers_flagged": watchdog.flagged,
            "losses": losses}


def mesh_layout(cfg: ArchConfig, mesh: Any, params: Any,
                batch: Dict[str, Any], fsdp: Optional[bool] = None
                ) -> TrainLayout:
    """The training layout of `cfg` on `mesh`: the reference's dry-run
    rules (`seq_shard_acts`), `make_plan(train=True)`'s FSDP choice
    (`fsdp` forces it), the parameters' and the batch's specs."""
    rules = ShardingRules(mesh, seq_shard_acts=True)
    plan = partition.make_plan(cfg, rules, train=True)
    if fsdp is not None:
        plan = partition.PartitionPlan(rules=rules, fsdp=fsdp)
    return TrainLayout(rules, partition.param_specs(params, cfg, plan),
                       partition.batch_specs(batch, plan))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train SPMD over a DATAxMODEL mesh of ranks, one "
                         "process a rank: run under torchrun "
                         "--nproc-per-node DATA*MODEL (e.g. 2x2)")
    args = ap.parse_args(argv)
    mesh, rank = None, 0
    if args.mesh is not None:
        mesh = mesh_lib.init_from_env(*mesh_lib.parse_mesh(args.mesh))
        rank = dist.get_rank()
    try:
        out = train(args.arch, smoke=args.smoke, steps=args.steps,
                    batch=args.batch, seq_len=args.seq_len,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    compress=args.compress, mesh=mesh, lr=args.lr,
                    device=args.device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if rank != 0:
        return 0
    if mesh is not None:
        print(f"[train] mesh={args.mesh} ranks={mesh.size()} "
              f"wire_bytes={WIRE.bytes_sent}")
    if out["steps_run"]:
        print(f"[train] done: {out['steps_run']} steps, "
              f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")
    else:
        print("[train] done: 0 steps (the checkpoint is at the last step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
