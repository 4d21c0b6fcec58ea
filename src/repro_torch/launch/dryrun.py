"""The dry-run: every (arch x shape x mesh) cell's per-rank program run on
meta tensors and counted, the port of `repro/launch/dryrun.py`.

A cell is rank 0's program on a production mesh (`mesh.make_production_
mesh`: 16 x 16, or 2 x 16 x 16 over a fake process group): the port's own
step (`steps.make_prefill_step`, `steps.make_serve_step`) run on meta
tensors (shapes and dtypes, no storage; `launch/mesh.py` says why not
`FakeTensorMode`) of the LOCAL shapes the partition specs give rank 0,
inside a `roofline.cost.CostCounter`.  Nothing is allocated and no kernel
is built: the `kernels/ops.py` entries take their meta route and charge
their formulas.  Each row reports the memory the counter tracked
(argument, output, temp, peak bytes) and the roofline terms against one
H100 (`roofline/analysis.py`).

  decode  - `seq_shard_attn` rules and `partition.cache_specs`: the KV
            cache's sequence over the model axis (the AXLE ring of
            `core/backstream.py` over the rank's span), mamba states by
            head group, rows over the data axes.  The sequence-sharded
            schedules take each rank's span in logical order, so the
            cache has no page table (the reference's is the identity).
  prefill - rows over the data axes; `logits_fn`.
  train   - `steps.make_train_step` on the training layout: the
            reference's dry-run rules (`seq_shard_acts`: the residual
            stream's sequence over the model axis), `make_plan(train=True)`
            (FSDP above 5e9 params), the parameters and AdamW's state under
            `partition.param_specs` / `opt_state_specs`, the batch under
            `batch_specs`; each block's weights gathered inside its
            recomputation, MoE on the expert-parallel `moe_ffn_dist`.

Decode and prefill parameters follow `partition.serve_param_specs`:
replicated, since the port has no tensor-parallel products, so every
rank holds (and reads) all of them.  Every cell counts rank 0's program;
where ranks do unequal work (a causal span's attention grows with its
offset, and rank 0's span is the first) the other ranks' counts differ.
The fake group is one per process: run the CLI, or `run_cell` in a
process of its own.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs, \
    shape_supported
from repro_torch.launch import partition
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw, compression
from repro_torch.roofline import analysis
from repro_torch.roofline.cost import CostCounter
from repro_torch.sharding import (ShardingRules, TrainLayout, axis_sizes,
                                  use_rules)

META = torch.device("meta")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def local_shape(shape, spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of rank 0's slice of a tensor under `spec`."""
    out = list(shape)
    for dim, axes in enumerate(spec):
        if not axes:
            continue
        parts = math.prod(sizes[a] for a in
                          (axes if isinstance(axes, tuple) else (axes,)))
        if out[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {parts} parts over {axes}")
        out[dim] //= parts
    return tuple(out)


def local_tensors(abstract: Any, specs: Any, sizes: Dict[str, int],
                  device: torch.device) -> Any:
    """Empty tensors of rank 0's local shapes for a tree of abstract
    leaves and its tree of specs, made directly (a slice of a full
    tensor would be counted as the full storage)."""
    if isinstance(abstract, dict):
        return {k: local_tensors(v, specs[k], sizes, device)
                for k, v in abstract.items()}
    if isinstance(abstract, (list, tuple)):
        return type(abstract)(local_tensors(v, s, sizes, device)
                              for v, s in zip(abstract, specs))
    return torch.empty(local_shape(abstract.shape, specs, sizes),
                       dtype=abstract.dtype, device=device)


def _batch_spec(t: torch.Tensor, rules: ShardingRules) -> partition.Spec:
    """Rows over the data axes when they divide, the rest whole."""
    n = rules.data_size()
    rows = rules.batch_axes if n and t.shape[0] % n == 0 else None
    return partition.Spec(rows, *([None] * (t.dim() - 1)))


def count_step(step: Callable, args: tuple) -> Tuple[CostCounter, Any]:
    """Run `step(*args)` once inside a fresh `CostCounter`, its arguments
    declared; returns (the closed counter, the step's output)."""
    counter = CostCounter()
    with counter:
        counter.arguments(args)
        out = step(*args)
        counter.outputs(out)
    return counter, out


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             collect_roofline: bool = True) -> Dict[str, Any]:
    """Count one cell on meta tensors.  Returns a JSON-able report row."""
    cfg = get_config(arch_id)
    seq, batch, kind = SHAPES[shape_name]
    row: Dict[str, Any] = {"arch": arch_id, "shape": shape_name,
                           "mesh": _mesh_name(multi_pod), "kind": kind}
    skip = shape_supported(cfg, shape_name)
    if skip:
        row["status"] = "skipped"
        row["reason"] = skip
        return row

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    sizes = axis_sizes(mesh)
    model = get_model(cfg)
    rules = ShardingRules(mesh, seq_shard_attn=(kind == "decode"),
                          seq_shard_acts=(kind == "train"))
    plan = partition.make_plan(cfg, rules, train=(kind == "train"))
    t0 = time.time()
    grad = (contextlib.nullcontext() if kind == "train"
            else torch.no_grad())
    with use_rules(rules), grad:
        ab_params = model.abstract_params(cfg)
        specs_in = input_specs(cfg, shape_name)
        if kind == "train":
            p_specs = partition.param_specs(ab_params, cfg, plan)
            params = local_tensors(ab_params, p_specs, sizes, META)
            b_specs = partition.batch_specs(specs_in, plan)
            batch_in = {k: local_tensors(v, b_specs[k], sizes, META)
                        for k, v in specs_in.items()}
            step = steps_lib.make_train_step(
                cfg, adamw.AdamWConfig(),
                layout=TrainLayout(rules, p_specs, b_specs))
            args = (params, adamw.init(params), None, batch_in)
            row["fsdp"] = plan.fsdp
        else:
            params = local_tensors(
                ab_params, partition.serve_param_specs(ab_params, cfg, plan),
                sizes, META)
        if kind == "prefill":
            batch_in = {k: local_tensors(v, _batch_spec(v, rules), sizes,
                                         META) for k, v in specs_in.items()}
            step, args = steps_lib.make_prefill_step(cfg), (params, batch_in)
        elif kind == "decode":
            ab_cache = model.abstract_cache(cfg, batch, seq)
            ab_cache.pop("page_table", None)
            cache = local_tensors(
                ab_cache, partition.cache_specs(ab_cache, cfg, plan), sizes,
                META)
            tok = specs_in["tokens"]
            tokens = local_tensors(tok, _batch_spec(tok, rules), sizes, META)
            step, args = steps_lib.make_serve_step(cfg), (params, cache,
                                                          tokens)
        counter, _ = count_step(step, args)
    row["count_s"] = round(time.time() - t0, 1)
    row["memory"] = counter.memory()
    row["params_bytes_per_chip"] = sum(
        t.numel() * t.element_size() for t in tree.leaves(params))
    row["n_ops"] = counter.n_ops
    row["kernels"] = {k: {"calls": v[2], "flops": v[0], "bytes": v[1]}
                      for k, v in counter.kernels.items()}
    row["status"] = "ok"
    if collect_roofline:
        mflops = analysis.model_flops_estimate(cfg, shape_name, seq, batch,
                                               kind)
        row["roofline"] = analysis.analyze(
            counter, arch=arch_id, shape=shape_name, mesh_name=row["mesh"],
            chips=chips, model_flops=mflops).row()
    return row


# --------------------------------------------------------------------------
# One device: the same steps on meta or real tensors (the card's check)
# --------------------------------------------------------------------------

def device_cell(cfg: ArchConfig, kind: str, batch: int, seq: int, *,
                device: torch.device, real: bool, seed: int = 0
                ) -> Tuple[Callable, tuple]:
    """(step, args) of one single-device cell: `kind` "decode" (one greedy
    step over a `seq`-slot paged cache, every row at the last slot),
    "prefill" (`logits_fn` on `batch` x `seq` tokens) or "train" (the
    loss, its gradients and AdamW, `steps.make_train_step`).  With `real`
    the weights are drawn from `seed` and the inputs are random; without
    it every tensor is uninitialised (on the meta device: storage-less)."""
    model = get_model(cfg)
    gen = None
    if real:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = model.init_params(cfg, gen, device)
    else:
        params = model.abstract_params(cfg, device)

    def tokens(*shape):
        if not real:
            return torch.empty(shape, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device=device, dtype=torch.int32)

    if kind == "decode":
        cache = model.init_cache(cfg, batch, seq, device=device)
        if real:
            cache["pos"].fill_(seq - 1)
        return steps_lib.make_serve_step(cfg), (params, cache,
                                                tokens(batch, 1))
    batch_in = {"tokens": tokens(batch, seq)}
    if kind == "prefill":
        return steps_lib.make_prefill_step(cfg), (params, batch_in)
    batch_in["labels"] = tokens(batch, seq)
    step = steps_lib.make_train_step(cfg, adamw.AdamWConfig())
    return step, (params, adamw.init(params), None, batch_in)


def meta_device_cell(cfg: ArchConfig, kind: str, batch: int, seq: int
                     ) -> CostCounter:
    """The counter of one single-device cell on meta tensors: what the
    card's run of `device_cell` counts, allocating nothing."""
    step, args = device_cell(cfg, kind, batch, seq, device=META, real=False)
    with torch.no_grad() if kind != "train" else contextlib.nullcontext():
        counter, _ = count_step(step, args)
    return counter


def meta_train_parts(cfg: ArchConfig, batch: int, seq: int, *,
                     compress: bool = True) -> Tuple[CostCounter,
                                                     CostCounter]:
    """The counters of a train step's two phases on meta tensors: the
    loss and its gradients (`steps.loss_and_grads`), then the update (the
    int8 error-feedback compression when `compress`, then AdamW)."""
    params = get_model(cfg).abstract_params(cfg, META)
    toks = torch.empty((batch, seq), dtype=torch.int32, device=META)
    grad_counter, (_, _, grads) = count_step(
        lambda p, b: steps_lib.loss_and_grads(cfg, p, b),
        (params, {"tokens": toks, "labels": toks}))
    opt_cfg = adamw.AdamWConfig()
    comp = compression.init(params) if compress else None

    def update(params, grads, opt_state, comp):
        if comp is not None:
            grads, comp = compression.compress_grads(grads, comp)
        return adamw.apply(opt_cfg, params, grads, opt_state)

    opt_counter, _ = count_step(update, (params, grads, adamw.init(params),
                                         comp))
    return grad_counter, opt_counter


def counts(counter: CostCounter) -> Dict[str, Any]:
    """A counter's totals and breakdowns, JSON-able: what the meta run
    and the card's run of one cell are held equal on."""
    return {"flops": counter.flops, "bytes": counter.bytes,
            "n_ops": counter.n_ops, "flops_by_dtype": counter.flops_by_dtype,
            "memory": counter.memory(),
            "by_op": {k: list(v) for k, v in counter.by_op.items()},
            "kernels": {k: list(v) for k, v in counter.kernels.items()}}


def card_cell(cfg: ArchConfig, kind: str, batch: int, seq: int, *,
              device: torch.device, iters: int = 3) -> Dict[str, Any]:
    """One single-device cell on the card: the step once inside a
    `CostCounter` on real tensors (weights from seed 0), the growth of
    `torch.cuda.max_memory_allocated` from before its arguments were
    made, and `iters` timed runs without the counter (CUDA events; the
    first, a warm-up, dropped; the median).  Returns the counts, the
    measured peak, the times and the roofline terms of the counted run
    against one card's published peaks.  Raises without a card."""
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("card_cell measures on a CUDA device")
    grad = torch.no_grad() if kind != "train" else contextlib.nullcontext()
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    step, args = device_cell(cfg, kind, batch, seq, device=device, real=True)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    with grad:
        counter, out = count_step(step, args)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    # the logits (decode: with the next tokens), or the train metrics
    result = {"decode": lambda o: o[:2], "prefill": lambda o: o,
              "train": lambda o: o[3]}[kind](out)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in tree.leaves(result)
                 if isinstance(t, torch.Tensor) and t.is_floating_point())
    del out
    times = []
    for _ in range(iters + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with grad:
            step(*args)
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    del args, step
    ms = sorted(times[1:])[len(times[1:]) // 2]
    terms = analysis.analyze(
        counter, arch=cfg.arch_id, shape=kind, mesh_name="1", chips=1,
        model_flops=analysis.model_flops_estimate(cfg, kind, seq, batch,
                                                  kind))
    return {"counts": counts(counter), "peak_bytes_measured": peak,
            "finite": finite, "ms": ms, "times_ms": times,
            "roofline": terms.row(), "bound_ms": terms.bound_time * 1e3}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (default)")
    ap.add_argument("--shape", default="all", choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_report_torch.json")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing report file")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    rows = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in rows}

    n_fail = 0
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                key = (arch, shape, _mesh_name(multi_pod))
                if key in done:
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    row = run_cell(arch, shape, multi_pod=multi_pod)
                except Exception as e:          # a failure here is a bug
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape,
                           "mesh": _mesh_name(multi_pod),
                           "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}"}
                    n_fail += 1
                rows.append(row)
                line = f"[dryrun]   -> {row['status']}"
                if row["status"] == "ok":
                    rf = row["roofline"]
                    line += (f" ({row['count_s']}s; peak "
                             f"{row['memory']['peak_bytes'] / 1e9:.2f} GB, "
                             f"{rf['dominant']}-bound "
                             f"{max(rf['t_compute_s'], rf['t_memory_s'], rf['t_collective_s']) * 1e3:.3f} ms)")
                print(line, flush=True)
                with open(args.out, "w") as f:
                    json.dump(rows, f, indent=1, default=str)
    print(f"[dryrun] wrote {args.out}: {len(rows)} rows, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
