"""The split decode of two builds of the kernel library, side by side on
the card.

    PYTHONPATH=src python -m repro_torch.kernels.decode_ab OLD.so NEW.so \
        [--json PATH]

Calls the decode entry points (`rt_decode_fused`, `rt_decode_partial`,
whose C interface both builds share) of each library at chip_smoke.py's
decode shapes: starcoder2_3b (hd 128, 24 heads on 2, paged S 1024),
gemma3_12b (hd 256, 16 on 8, paged S 2048, window 1023), opt_2_7b (hd
80, MHA 32, the same), granite_moe_3b (hd 64, 24 on 8, paged S 2048, page
128) and whisper_large_v3's cross read (hd 64, MHA 20, dense S 1500 in
chunks of 125), the fused decode on bf16 pools (and int8 pools at hd 64
and 128) and the partial, B 4, the same inputs for both builds.  OLD runs
the plan it was built for (splits of at most 64 rows: the largest divisor
of the chunk not above 64, the partial's 64), NEW runs
`flash_attention.decode_split`'s, and, where the two plans differ, NEW
also runs OLD's plan ("new@old plan").  For each it prints the largest
|kernel - plain| in f32, whether NEW equals OLD bit for bit, and the
device time of one call: torch.profiler over 50 back-to-back calls (every
kernel and memset, warm L2; a window is taken again, up to 5 times, until
every kernel in it ran a whole multiple of 50 times), split into the
split kernel and the merge kernel, and CUDA events around the calls,
median of 5, taken in the order OLD, NEW, NEW, OLD (new@old plan twice
after them) and averaged, with the card's name and power limit.  Needs
a GPU; nothing runs when it is imported.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

CALLS = 50
# name: (B, H, KH, hd, S, page (0: dense, chunk 128), pos, window, extra)
SHAPES = {
    "hd128": (4, 24, 2, 128, 1024, 128, [0, 130, 400, 1023], 0, True),
    "hd256": (4, 16, 8, 256, 2048, 128, [300, 1023, 1024, 2047], 1023, True),
    "hd80": (4, 32, 32, 80, 2048, 128, [300, 1023, 1024, 2047], 1023, True),
    "hd64": (4, 24, 8, 64, 2048, 128, [300, 1023, 1024, 2047], 0, True),
    "enc1500": (4, 20, 20, 64, 1500, 0, [0, 599, 1498, 1499], 0, False),
}


def old_split(blk_c: int) -> int:
    """The plan the earlier builds ran: the largest divisor of the chunk
    not above 64."""
    rows = min(64, blk_c)
    while blk_c % rows:
        rows -= 1
    return rows


def _lib(path: str) -> Dict[str, Callable[..., int]]:
    lib = ctypes.CDLL(path)
    out = {}
    for name in ("rt_decode_fused", "rt_decode_partial"):
        fn = getattr(lib, name)
        fn.argtypes = fa._SIGNATURES[name]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _case(shape: str, gen: torch.Generator, dev: torch.device) -> dict:
    """The inputs of one shape, made on the card from `gen`."""
    b, h, kh, hd, s, page, pos, window, with_extra = SHAPES[shape]

    def randn(*sh):
        return torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)

    q = randn(b, 1, h, hd)
    k, v = randn(b, kh, s, hd), randn(b, kh, s, hd)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    c = dict(q=q, k=k, v=v, pos=pos_t, window=window, table=None,
             blk_c=fa.dense_chunk(s, 128), extra=None)
    if page:
        n = s // page
        table = torch.stack([torch.randperm(n, generator=gen, device=dev)
                             for _ in range(b)]).to(torch.int32)
        pool = [torch.empty_like(k), torch.empty_like(v)]
        for r in range(b):
            for j in range(n):
                p = int(table[r, j])
                for t, lt in zip(pool, (k, v)):
                    t[r, :, p * page:(p + 1) * page] = \
                        lt[r, :, j * page:(j + 1) * page]
        c.update(k=pool[0], v=pool[1], table=table, blk_c=page,
                 k_log=k, v_log=v)
    else:
        c.update(k_log=k, v_log=v)
    if with_extra:
        c["extra"] = (torch.randn(b, h, hd, generator=gen, device=dev),
                      torch.randn(b, h, generator=gen, device=dev),
                      torch.rand(b, h, generator=gen, device=dev) + 0.5)
    valid = ref.decode_valid_mask(pos_t, s, window)
    valid[1] = False
    c["valid"] = valid
    return c


def _calls(fns, c: dict, fn: str, split: int, kv_scales=None):
    """A zero-argument call of one library's entry point on the case `c`
    with splits of `split` rows, and its output tensors."""
    q, k, v = c["q"], c["k"], c["v"]
    b, _, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    group = h // kh
    dev = q.device
    scale = float(hd ** -0.5)
    stream = torch.cuda.current_stream().cuda_stream
    if fn == "partial":
        k, v = c["k_log"], c["v_log"]
        n_split = -(-s // split)
        ws = torch.empty(b * kh * n_split * group * (hd + 2), device=dev)
        outs = (torch.empty(b, h, hd, device=dev),
                torch.empty(b, h, device=dev), torch.empty(b, h, device=dev))
        args = (1, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                c["valid"].data_ptr(), *(t.data_ptr() for t in outs),
                ws.data_ptr(), b, h, kh, s, hd, split, n_split, scale,
                stream)
        return (lambda: fns["rt_decode_partial"](*args)), outs, ws
    if kv_scales is not None:
        k, v = kv_scales[0], kv_scales[1]
        sc = kv_scales[2:]
    table, blk_c = c["table"], c["blk_c"]
    n_log = 0 if table is None else table.shape[1]
    n_split = -(-(n_log * blk_c if n_log else s) // split)
    ws = torch.empty(b * kh * n_split * group * (hd + 2), device=dev)
    out = torch.empty_like(q)
    ex = c["extra"]
    args = (1, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            c["pos"].data_ptr(), None if table is None else table.data_ptr(),
            n_log, *((None,) * 3 if ex is None else
                     (t.data_ptr() for t in ex)),
            *((None, None, 0) if kv_scales is None else
              (sc[0].data_ptr(), sc[1].data_ptr(), sc[0].shape[-1])),
            out.data_ptr(), ws.data_ptr(), b, h, kh, s, hd, blk_c, split,
            n_split, c["window"], scale, stream)
    return (lambda: fns["rt_decode_fused"](*args)), (out,), ws


def _plain(c: dict, fn: str, kv_scales=None):
    """The plain version's outputs in f32 on the same inputs."""
    if fn == "partial":
        return ref.decode_partial_reference(c["q"], c["k_log"], c["v_log"],
                                            c["valid"])
    k, v = c["k"], c["v"]
    kw = {}
    if kv_scales is not None:
        k, v = kv_scales[0], kv_scales[1]
        kw["kv_scales"] = kv_scales[2:]
    if c["table"] is not None:
        kw.update(pages=c["table"], page_size=c["blk_c"])
    q32 = c["q"].float()
    return (ref.decode_fused_reference(q32, k if kv_scales else k.float(),
                                       v if kv_scales else v.float(),
                                       c["pos"], c["extra"],
                                       window=c["window"], **kw),)


PARTS = (("split", "decode_split"), ("merge", "decode_merge"))


def _device_us(call, attempts: int = 5) -> tuple:
    """(all device time, {part: time}) of one call in microseconds:
    torch.profiler over CALLS back-to-back calls, divided by CALLS; the
    parts are the split kernel and the merge kernel.  A window in which a
    kernel ran other than a whole multiple of CALLS times lost events and
    is taken again; (nan, {}) if none was whole."""
    call()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev and all(e.count % CALLS == 0 for e in ev):
            total = sum(e.self_device_time_total for e in ev) / CALLS
            return total, {part: sum(e.self_device_time_total for e in ev
                                     if key in e.key.lower()) / CALLS
                           for part, key in PARTS}
    return float("nan"), {part: float("nan") for part, _ in PARTS}


def _events_us(call, reps: int = 5) -> float:
    """Median over `reps` of the mean time of CALLS back-to-back calls."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / CALLS)
    return statistics.median(times)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    libs = {"old": _lib(args.old), "new": _lib(args.new)}
    card = _card()
    print(f"[decode_ab] {card}; {CALLS} back-to-back calls a reading",
          flush=True)
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, spec in SHAPES.items():
        c = _case(shape, gen, dev)
        hd, page = spec[3], spec[5]
        pools = [None]
        if shape in ("hd128", "hd64"):
            (k8, ks), (v8, vs) = (ref.quantize_kv_pages(t, page)
                                  for t in (c["k"], c["v"]))
            pools.append((k8, v8, ks, vs))
        for fn, kv in [("fused", p) for p in pools] + [("partial", None)]:
            label = f"{shape} {fn}" + ("[int8]" if kv is not None else "")
            s = c["k"].shape[2]
            if fn == "partial":
                plans = {"old": old_split(64),
                         "new": fa.decode_split(s, fa.PARTIAL_CHUNK, hd)[0]}
            else:
                plans = {"old": old_split(c["blk_c"]),
                         "new": fa.decode_split(s, c["blk_c"], hd)[0]}
            # (label, library, plan)
            runs = [("old", "old", "old"), ("new", "new", "new")]
            if plans["new"] != plans["old"]:
                runs.append(("new@old plan", "new", "old"))
            want = [t.float() for t in _plain(c, fn, kv)]
            got, err, calls = {}, {}, {}
            for key, lib, plan in runs:
                call, outs, _ = _calls(libs[lib], c, fn, plans[plan], kv)
                rc = call()
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"{label} {key}: cudaError_t {rc}")
                got[key] = [t.clone() for t in outs]
                err[key] = max(
                    ((g.float() - w).abs()[torch.isfinite(w)].max().item()
                     if g.numel() else 0.0) for g, w in zip(outs, want))
                calls[key] = call
            same = all(torch.equal(a, b)
                       for a, b in zip(got["old"], got["new"]))
            times = {key: [] for key in calls}
            order = ["old", "new", "new", "old"] + [
                key for key in calls if key not in ("old", "new")
                for _ in range(2)]
            for key in order:
                total, parts = _device_us(calls[key])
                times[key].append((total, parts, _events_us(calls[key])))
            row = dict(case=label, card=card, plan_rows=plans, equal=same)
            for key, ts in times.items():
                row[key] = dict(
                    max_abs_err=err[key],
                    device_us=statistics.mean(t[0] for t in ts),
                    parts_us={part: statistics.mean(t[1][part] for t in ts)
                              for part, _ in PARTS},
                    events_us=statistics.mean(t[2] for t in ts))
            rows.append(row)
            plan_of = {key: plans[plan] for key, _, plan in runs}
            parts = "; ".join(
                f"{key} (split {plan_of[key]}): device "
                f"{row[key]['device_us']:.2f} us ("
                + ", ".join(f"{part} {t:.2f}"
                            for part, t in row[key]['parts_us'].items())
                + f"), events {row[key]['events_us']:.2f} us, err "
                f"{row[key]['max_abs_err']:.3g}" for key in times)
            print(f"[decode_ab] {label}: {parts}; new == old bitwise: "
                  f"{same}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
