"""End-to-end training example, the port of `examples/train_pipeline.py`:
a ~100M decoder of the starcoder2 family (10 layers, d 640, 10 heads on
2 KV heads of 64, d_ff 2560, vocab 32,768) trained for a few hundred
steps on the whole production path: the prefetching data pipeline,
AdamW with clipping and an f32 master, int8 error-feedback gradient
compression, a checkpoint every 50 steps, restart from the latest, the
straggler watchdog and preemption-safe shutdown.

    PYTHONPATH=src python -m repro_torch.examples.train_pipeline \\
        [--steps 300] [--ckpt-dir DIR] [--device cpu]

Rerun it with the same --ckpt-dir to resume from the latest checkpoint.
It runs on the GPU unless `--device cpu` is given, and raises when no GPU
is present and none was asked for.  The config is a width and depth
reduction of the starcoder2 smoke config, as the reference's; `train`
takes it as `cfg` where the reference registers a config module.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train

CONFIG = dataclasses.replace(
    get_smoke_config("starcoder2_3b"), arch_id="starcoder2_100m",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=2, d_ff=2560,
    vocab=32768, head_dim=64)
# the reference example's run: batch 8 x 256 tokens, compression on,
# lr 3e-3, a checkpoint every 50 steps
RUN = dict(batch=8, seq_len=256, compress=True, lr=3e-3)


def run(steps: int, ckpt_dir: Optional[str], *, device=None,
        ckpt_every: int = 50, log_every: int = 25) -> Dict[str, Any]:
    """`launch.train.train` of CONFIG with the example's settings."""
    return train(CONFIG.arch_id, cfg=CONFIG, steps=steps, ckpt_dir=ckpt_dir,
                 ckpt_every=ckpt_every, log_every=log_every, device=device,
                 **RUN)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_pipeline")
    print(f"training {CONFIG.arch_id}: ~{CONFIG.n_params() / 1e6:.0f}M "
          "params")
    out = run(args.steps, ckpt_dir, device=args.device)
    if not out["steps_run"]:
        print(f"nothing to run: the checkpoint in {ckpt_dir} is at step "
              f"{args.steps}")
        return
    print(f"\nloss {out['first_loss']:.3f} -> {out['last_loss']:.3f} over "
          f"{out['steps_run']} steps "
          f"(stragglers flagged: {out['stragglers_flagged']})")
    if out["last_loss"] >= out["first_loss"]:
        raise SystemExit("the loss did not decrease")
    print(f"checkpoints in {ckpt_dir}; rerun to resume from the latest.")


if __name__ == "__main__":
    main()
