"""Training on a mesh of this host's ranks, held to the single device.

    PYTHONPATH=src python -m repro_torch.examples.mesh_train \\
        [--full] [--device cpu] [--json out.json]

Each case is an arch cut to its first layers, a batch and a DATAxMODEL
mesh; f32, 3 steps of `steps.make_train_step` (AdamW lr 1e-3, one warmup
step) on batches 0, 1, 2 of `synth_batch`, the weights from seed 0:

  starcoder2_3b, its first 2 layers, B 4 x S 1024: 2x1 with FSDP forced
      (every d_model weight dim split over the data axis), and 1x2 with
      the int8 error-feedback compression;
  granite_moe_3b, its first 2 layers, B 4 x S 256 at 1x2: 1,024 tokens a
      data shard, the expert-parallel branch of `layers.moe_ffn_dist`
      (20 of the 40 experts a rank).

`--full` takes the full widths; without it the smoke widths at B 2 x S
32 (the CPU rehearsal; granite's 64 tokens then take `moe_ffn_dist`'s
fallback, and its small expert count fills queues, where the reference's
expert-parallel drop slot would part from the single device).  A gloo
group of 2 fresh processes (`launch/mesh.spawn`; on a one-card host both
ranks share the card)
runs every case.  Rank 0 first runs each case's single-device steps on
its device while rank 1 waits, then both run the mesh steps on their
shards (`launch/train.mesh_layout`, `partition.shard_tree`), and rank 0
gathers the mesh's gradients and state leaf by leaf and holds them to the
single device's (where
the mesh takes the expert-parallel MoE branch, the single device runs its
twin, `layers.expert_parallel_twin`: the reference's branch parts from
`moe_ffn` where its per-shard drop slot (0, cap - 1) holds a kept token,
as at granite's second layer here, where expert 0 fills its queue), by
the
gates of `tests/test_torch_train_mesh.py`: the metrics within rtol 1e-4,
the step-0 gradients within 1e-5 of a leaf's max, the state after the
first step within rtol 2e-4 plus atol 1e-5 of a leaf's max (5e-2 for the
residual; against at least 1 for the parameters that start at zero as
an offset of 1: the norms' scales, A_log and dt_bias), at most 0.1% of a
leaf off (0.5% compressed; at least one element) and every element
within 3 lr (moments 5%, the residual one quantum).  After the third
step only the bound holds at full width: two f32 trajectories whose
gradients part by a few 1e-6 of a leaf's max flip Adam's near-sign
updates of small-gradient elements past the allowance.  The elements off
the gates are counted at both steps, for the mesh and, on a dense arch,
for a control: the single device on the same batches with their rows in
reverse order (the same sums in another order).  Each rank reports the bytes it
stores (parameters, AdamW state, residual) beside the single device's,
the wire bytes of a step by collective, and a step's wall ms: gloo
stages every collective through host memory, so the wall is not a
performance number of the mesh.

It runs on the GPU unless `--device cpu` is given, and raises when no GPU
is present and none was asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device, tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import collectives as C
from repro_torch.core.backstream import WIRE
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import partition
from repro_torch.launch import steps
from repro_torch.launch.train import mesh_layout
from repro_torch.models import layers as layers_lib
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw, compression

LR, N_STEPS = 1e-3, 3
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)
# name, arch, layers, (B, S) at full width, at smoke width, mesh, FSDP
# forced, compression
CASES = (("starcoder2_3b 2x1 fsdp", "starcoder2_3b", 2, (4, 1024), (2, 32),
          "2x1", True, False),
         ("starcoder2_3b 1x2 compressed", "starcoder2_3b", 2, (4, 1024),
          (2, 32), "1x2", None, True),
         ("granite_moe_3b 1x2 expert-parallel", "granite_moe_3b", 2,
          (4, 256), (2, 32), "1x2", None, False))
KEEP = (0, N_STEPS - 1)            # the steps whose states are held
# the largest |mesh - single| where an element was sent another way, by
# kind of leaf: (a multiple of LR, a multiple of the leaf's max)
BOUND = {"params": (3, 0), "master": (3, 0), "mu": (0, 0.05),
         "nu": (0, 0.05), "residual": (0, 2.01)}
ATOL = {"residual": 5e-2}
# a routing parting is a near tie where the single device's k-th and
# (k+1)-th router logits of every parted token lie this close (f32)
ROUTER_NEAR_TIE = 1e-3
# leaves the model uses as an offset of 1 (the norms' 1 + s), inside an
# exponent (A = -exp(A_log)) or beside an O(1) input (dt_bias): they start
# at zero, and their atol is taken against 1 when their max is below it
UNIT_LEAVES = ("ln", "final_ln", "enc_final_ln", "A_log", "dt_bias")


def leaf_names(params: Any) -> List[str]:
    """The innermost dict key of every leaf, in `tree` order."""
    out: List[str] = []

    def walk(t, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], k)
        elif isinstance(t, (list, tuple)) and not getattr(t, "tree_leaf",
                                                          False):
            for v in t:
                walk(v, name)
        else:
            out.append(name)
    walk(params, "")
    return out


def case_config(arch: str, layers: int, full: bool):
    base = get_config(arch) if full else get_smoke_config(arch)
    return dataclasses.replace(base, arch_id=f"{arch}_first{layers}",
                               n_layers=layers, dtype="float32")


def _batches(cfg, b: int, s: int) -> List[Dict[str, np.ndarray]]:
    """Batches 0 .. N_STEPS - 1 of `synth_batch`."""
    d = DataConfig(vocab=cfg.vocab, batch=b, seq_len=s,
                   frontend=cfg.frontend, d_model=cfg.d_model)
    return [synth_batch(d, i) for i in range(N_STEPS)]


def _on(batch: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _nbytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tr in trees
               for t in tree.leaves(tr) if isinstance(t, torch.Tensor))


def _state(p, opt, comp) -> Dict[str, List[torch.Tensor]]:
    out = {"params": p, "mu": opt.mu, "nu": opt.nu, "master": opt.master}
    if comp is not None:
        out["residual"] = comp.residual
    return {k: tree.leaves(v) for k, v in out.items()}


def leaf_gate(got: torch.Tensor, want: torch.Tensor, name: str,
              compress: bool, unit: bool = False) -> Dict[str, Any]:
    """The state gate of one whole leaf: off elements against their
    allowance, the largest difference against the bound (`unit`: a
    UNIT_LEAVES parameter or master, its atol against at least 1)."""
    got, want = got.float(), want.float()
    top = max(float(want.abs().max()), float(got.abs().max()))
    off, worst = _off(got, want, name, top, unit)
    return _verdict(float(off), float(worst), name, compress, top,
                    got.numel())


def _off(got, want, name, top, unit):
    diff = (got.float() - want.float()).abs()
    scale = max(top, 1.0) if unit else top
    off = (diff > 2e-4 * want.float().abs()
           + ATOL.get(name, 1e-5) * scale).sum()
    return off, diff.max()


def _verdict(off: float, worst: float, name: str, compress: bool,
             top: float, numel: int) -> Dict[str, Any]:
    allowed = max((5e-3 if compress else 1e-3) * numel, 1)
    lr_x, max_x = BOUND[name]
    bound = lr_x * LR + max_x * top
    off = int(round(off))
    return {"ok": off <= allowed and worst <= bound, "off": off,
            "allowed": allowed, "worst": worst, "bound": bound}


class Tally:
    """The gates of one comparison, step by step: the metrics' and the
    step-0 gradients' largest relative gaps, and each kept step's
    elements off the state gates by kind of leaf, whether every leaf was
    within its allowance (the gates) and within its bound."""

    def __init__(self):
        self.metrics_rel = self.grads_rel = 0.0
        self.off: Dict[str, float] = {}
        self.gates_ok: List[bool] = []
        self.bound_ok = True

    def metrics(self, got: Dict[str, float], want: Dict[str, float]):
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            rel = abs(got[key] - want[key]) / max(abs(want[key]), 1e-7)
            self.metrics_rel = max(self.metrics_rel, rel)

    def state(self, step_i: int, verdicts: List[Any]) -> None:
        ok = True
        for name, v in verdicts:
            key = f"step {step_i + 1} {name}"
            self.off[key] = self.off.get(key, 0) + v["off"]
            self.bound_ok &= v["worst"] <= v["bound"]
            ok &= v["ok"]
        self.gates_ok.append(ok)

    def report(self) -> Dict[str, Any]:
        return {"metrics_rel": self.metrics_rel, "grads_rel": self.grads_rel,
                "off": self.off, "gates_ok": self.gates_ok,
                "bound_ok": self.bound_ok,
                "ok": (self.metrics_rel <= 1e-4 and self.grads_rel <= 1e-5
                       and all(self.gates_ok[:1]) and self.bound_ok)}


def _route_parting(single_log, mesh_log, rules) -> Tuple[int, float]:
    """(tokens routed apart, the largest single-device k-th minus
    (k+1)-th router logit among them), summed and maximised over the
    mesh: each rank's traced routings against the twin's of the same
    data shard, call by call."""
    by_shard: Dict[int, list] = {}
    for d, ids, gap in single_log:
        by_shard.setdefault(d, []).append((ids, gap))
    n, worst = 0, 0.0
    seen: Dict[int, int] = {}
    for d, ids, _ in mesh_log:
        c = seen.get(d, 0)
        seen[d] = c + 1
        want_ids, gap = by_shard[d][c]
        apart = (ids.sort(-1).values != want_ids.sort(-1).values).any(-1)
        if apart.any():
            n += int(apart.sum())
            worst = max(worst, float(gap[apart].max()))
    out = C.all_reduce_sum(torch.tensor([float(n)]), rules=rules)
    top = C.all_reduce_max(torch.tensor([worst]), rules=rules)
    return int(out[0]), float(top[0])


def _grads_rel(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.abs().max()), 1e-30) for g, w in zip(got, want))


def _mesh_verdicts(state, want, layout, names, compress) -> List[Any]:
    """The state gates of the mesh's shards against the single device's
    whole leaves, without moving a leaf: each rank counts on its shard
    (a replicated shard's count divided among its replicas) and the
    counts, the largest differences and the leaves' maxima cross the mesh
    as three small all-reduces."""
    rules, mesh = layout.rules, layout.rules.mesh
    specs = tree.leaves(layout.params)
    rows = [(name, j, t) for name, leaves in state.items()
            for j, t in enumerate(leaves)]
    got_max = C.all_reduce_max(torch.stack(
        [t.abs().max().float() for _, _, t in rows]), rules=rules).tolist()
    offs, worsts, tops = [], [], []
    for (name, j, t), gm in zip(rows, got_max):
        w = want[name][j]
        top = max(float(w.abs().max()), gm)
        unit = name in ("params", "master") and names[j] in UNIT_LEAVES
        off, worst = _off(t, partition.local_shard(w, specs[j], mesh), name,
                          top, unit)
        offs.append(off.float() / C.replicas(specs[j], rules))
        worsts.append(worst.float())
        tops.append(top)
    offs = C.all_reduce_sum(torch.stack(offs), rules=rules).tolist()
    worsts = C.all_reduce_max(torch.stack(worsts), rules=rules).tolist()
    return [(name, _verdict(off, worst, name, compress, top,
                            want[name][j].numel()))
            for (name, j, _), off, worst, top in zip(rows, offs, worsts,
                                                      tops)]


def run_case(mesh, dev, cfg, batches, fsdp, compress, control: bool
             ) -> Dict[str, Any]:
    """One case in lockstep on every rank: the single-device steps (on
    the expert-parallel MoE's twin), the mesh's on this rank's shards,
    and (`control`) the single device on the rows reversed, each step's
    gates taken as the states go (nothing kept, nothing gathered)."""
    n_data, n_model = tuple(mesh.shape)
    gen = torch.Generator(device=dev)
    full = get_model(cfg).init_params(cfg, gen.manual_seed(0), dev)
    layout = mesh_layout(cfg, mesh, full, batches[0], fsdp)
    names = leaf_names(layout.params)
    local = [_on(partition.shard_tree(_on(b, torch.device("cpu")),
                                      layout.batch, mesh), dev)
             for b in batches]
    flipped = [{k: v[::-1].copy() for k, v in b.items()} for b in batches]
    opt = adamw.AdamWConfig(**OPT)

    def start(params):
        return [params, adamw.init(params),
                compression.init(params) if compress else None]

    single = start(full)
    shards = start(partition.shard_tree(full, layout.params, mesh))
    ctl = start(get_model(cfg).init_params(cfg, gen.manual_seed(0), dev)) \
        if control else None

    def step(state, batch, lay=None):
        """`steps.make_train_step`'s step, its gradients kept."""
        loss, metrics, grads = steps.loss_and_grads(cfg, state[0], batch,
                                                    lay)
        *state, m = steps.apply_update(opt, state[0], grads, state[1],
                                       state[2], lay)
        return state, {**metrics, **m, "loss": loss}, tree.leaves(grads)

    mesh_t, ctl_t = Tally(), Tally() if control else None
    twin = functools.partial(layers_lib.expert_parallel_twin, n_data,
                             n_model)
    specs = tree.leaves(layout.params)
    out = {"wall_ms": [], "wire": [], "parted": None, "after": []}
    for i in range(N_STEPS):
        with twin(), layers_lib.trace_routes() as s_log:
            single, sm, want = step(single, _on(batches[i], dev))
        _sync(dev)
        WIRE.reset()
        t0 = time.perf_counter()
        with layers_lib.trace_routes() as m_log:
            shards, mm, got = step(shards, local[i], layout)
        _sync(dev)
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["wire"].append(dict(WIRE.bytes_by_op))
        floats = {k: float(v) for k, v in sm.items()}
        got_m = {k: float(v) for k, v in mm.items()}
        n_apart, gap = _route_parting(s_log, m_log, layout.rules)
        if n_apart and out["parted"] is None:
            out["parted"] = {"step": i + 1, "tokens": n_apart,
                             "logit_gap": gap}
        if out["parted"] is not None:
            # past a routing parting the runs are two trajectories: the
            # metrics are printed, finite, not held to each other
            out["after"].append({"step": i + 1, "mesh": got_m,
                                 "single": floats})
            continue
        mesh_t.metrics(got_m, floats)
        if control:
            ctl, cm, cg = step(ctl, _on(flipped[i], dev))
            ctl_t.metrics({k: float(v) for k, v in cm.items()}, floats)
        if i == 0:                       # the step-0 gradients
            rel = max(float((g - partition.local_shard(w, sp, mesh)).abs()
                            .max()) / max(float(w.abs().max()), 1e-30)
                      for g, w, sp in zip(got, want, specs))
            mesh_t.grads_rel = float(C.all_reduce_max(
                torch.tensor([rel]), rules=layout.rules)[0])
            if control:
                ctl_t.grads_rel = _grads_rel(cg, want)
        del want, got
        if i in KEEP:
            want = _state(*single)
            mesh_t.state(i, _mesh_verdicts(_state(*shards), want, layout,
                                           names, compress))
            if control:
                got = _state(*ctl)
                ctl_t.state(i, [(name, leaf_gate(
                    g, want[name][j], name, compress,
                    name in ("params", "master")
                    and names[j] in UNIT_LEAVES))
                    for name in want for j, g in enumerate(got[name])])
    out["gates"] = mesh_t.report()
    out["control"] = ctl_t.report() if control else None
    parted = out["parted"]
    out["gates"]["ok"] &= (parted is None
                           or parted["logit_gap"] < ROUTER_NEAR_TIE) and all(
        math.isfinite(v) for row in out["after"] for v in row["mesh"].values())
    out["single_stored_bytes"] = _nbytes(*single)
    out["stored_bytes"] = _nbytes(*shards)
    out["fsdp"] = any("data" in C.spec_axes(sp) for sp in specs)
    return out


def rank_main(mesh, device: str, opts: Dict[str, Any]) -> Dict[str, Any]:
    """Every case on this rank; rank 0's report of each."""
    dev = mesh_lib.rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank()
    reports = {}
    for name, arch, layers, full_bs, smoke_bs, shape, fsdp, compress \
            in CASES:
        t0 = time.perf_counter()
        cfg = case_config(arch, layers, opts["full"])
        b, s = full_bs if opts["full"] else smoke_bs
        n_data, n_model = mesh_lib.parse_mesh(shape)
        sub = mesh_lib.make_debug_mesh(n_data, n_model)
        # the control on rank 0 alone; a MoE routes by the row order
        res = run_case(sub, dev, cfg, _batches(cfg, b, s), fsdp, compress,
                       control=rank == 0 and not cfg.is_moe)
        branch = experts = None
        if cfg.is_moe:
            ep = b * s // n_data >= max(layers_lib.EP_MIN_TOKENS, cfg.top_k)
            branch = "expert-parallel" if ep else "fallback"
            experts = (-(-cfg.n_experts // n_model) if ep
                       else cfg.n_experts)
        stored = [None] * dist.get_world_size()
        dist.all_gather_object(stored, res.pop("stored_bytes"))
        reports[name] = dict(
            res, arch=arch, layers=layers, B=b, S=s, mesh=shape,
            compress=compress, moe_branch=branch, experts_a_rank=experts,
            n_params=cfg.n_params(), rank_stored_bytes=stored,
            s=time.perf_counter() - t0)
        del res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return reports


def run(opts: Dict[str, Any]) -> Dict[str, Any]:
    """The cases on a 2-rank group; raises if a gate fails."""
    device = resolve_device(opts["device"])
    t0 = time.perf_counter()
    reports = mesh_lib.spawn(rank_main, 2, 1, device=str(device.type),
                             args=(opts,))
    for name, rep in reports.items():
        if not rep["gates"]["ok"]:
            raise AssertionError(f"[mesh_train] {name}: {rep['gates']}")
    return {"cases": reports, "group_s": time.perf_counter() - t0}


def _offs(counts: Dict[str, Any], step: int) -> str:
    return ", ".join(f"{k.split()[-1]} {v}" for k, v in counts["off"].items()
                     if k.startswith(f"step {step} "))


def report_lines(res: Dict[str, Any], opts: Dict[str, Any]) -> List[str]:
    lines = []
    for name, rep in res["cases"].items():
        g, ctl = rep["gates"], rep["control"]
        wire = rep["wire"][-1]
        walls = rep["wall_ms"]
        lines.append(
            f"[mesh_train] {name} ({'full width' if opts['full'] else 'smoke'}"
            f", first {rep['layers']} layers, {rep['n_params'] / 1e6:.1f}M "
            f"params, f32, B {rep['B']} x S {rep['S']}, {N_STEPS} steps, "
            f"{'FSDP' if rep['fsdp'] else 'no FSDP'}"
            + (f", MoE {rep['moe_branch']}, {rep['experts_a_rank']} experts "
               f"a rank" if rep["moe_branch"] else "")
            + f"): metrics within {g['metrics_rel']:.2e} rel (gate 1e-4), "
            f"step-0 gradients {g['grads_rel']:.2e} of a leaf's max (gate "
            f"1e-5), "
            + (f"the step-1 state within the gates ({_offs(g, 1)} elements "
               f"off), " if g["gates_ok"] else "")
            + (f"the step-{N_STEPS} state within the bound "
               f"({_offs(g, N_STEPS)} elements off the gates"
               if len(g["gates_ok"]) > 1 else "(")
            + (f"; routing parted from the twin at step "
               f"{rep['parted']['step']} in {rep['parted']['tokens']} "
               f"tokens, the largest router logit gap among them "
               f"{rep['parted']['logit_gap']:.2e} (near-tie gate "
               f"{ROUTER_NEAR_TIE}), later steps printed, not held: "
               + ", ".join(f"step {a['step']} loss {a['mesh']['loss']:.6f} / "
                           f"{a['single']['loss']:.6f}" for a in rep["after"])
               if rep["parted"] else "")
            + (f"; the reordered-rows control: gradients "
               f"{ctl['grads_rel']:.2e}, step 1 {_offs(ctl, 1)}, step "
               f"{N_STEPS} {_offs(ctl, N_STEPS)}" if ctl else "")
            + f"); stored bytes a rank "
            f"{' / '.join(str(x) for x in rep['rank_stored_bytes'])} against "
            f"the single device's {rep['single_stored_bytes']}; wire a "
            f"step (rank 0) {sum(wire.values())} B "
            f"{json.dumps(wire, sort_keys=True)}; step wall (gloo-staged, "
            f"not a performance number) "
            f"{' / '.join(f'{w:.1f}' for w in walls)} ms; case "
            f"{rep['s']:.1f} s")
    lines.append(f"[mesh_train] group {res['group_s']:.1f} s")
    return lines


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="the full widths (default: the smoke ones)")
    ap.add_argument("--device", default=None,
                    help="torch device type (default cuda; 'cpu' to run "
                         "here)")
    ap.add_argument("--json", default=None, help="write the report here")
    args = ap.parse_args(argv)
    opts = {k.replace("-", "_"): v for k, v in vars(args).items()}
    res = run(opts)
    for line in report_lines(res, opts):
        print(line, flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh)
    return res


if __name__ == "__main__":
    main()
