"""Where `quant_tc_kernel`'s time goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.quant_tc_parts

Compiles `csrc/quant.cu` four times with nvcc, with `-DQUANT_TC_PARTS=`
0 (the copies alone), 1 (and the mmas), 2 (and the widening of the quants)
and 3 (the whole kernel, as `build.py` compiles it), and times each on the
prefill products of full-width starcoder2_3b (m = 512 and 300) with CUDA
events over 20 back-to-back calls, median of 5.  The builds with fewer
parts compute wrong values: they time the parts, and only the whole
kernel's output is held against the plain version.  Prints one line per
product with the four times and the cuBLAS bf16 matmul on the weight
dequantized to bf16 (the yardstick of chip_smoke.py), and the card's
name.  Needs a GPU and nvcc; nothing is built when it is imported.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.kernels import build, quant, ref

PARTS = {0: "copies", 1: "+ mmas", 2: "+ widening", 3: "whole kernel"}
# (m, d, n): w_gate at the longest prompt and a mid-length one, w_down
SHAPES = ((512, 3072, 12288), (300, 3072, 12288), (512, 12288, 3072))


def _libraries() -> Dict[int, Callable[..., int]]:
    """One library per QUANT_TC_PARTS value, the entry point typed."""
    out_dir = build.BUILD_DIR / "quant_tc_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "quant.cu"

    def compile_one(parts: int) -> str:
        lib = out_dir / f"libquant_parts{parts}.so"
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", f"-DQUANT_TC_PARTS={parts}",
               "-o", str(lib), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({parts}):\n{proc.stderr}")
        return str(lib)

    with ThreadPoolExecutor(max_workers=len(PARTS)) as pool:
        paths = dict(zip(PARTS, pool.map(compile_one, PARTS)))
    fns = {}
    for parts, path in paths.items():
        fn = ctypes.CDLL(path).rt_quant_matmul
        fn.argtypes = quant._SIGNATURE
        fn.restype = ctypes.c_int
        fns[parts] = fn
    return fns


def _events_ms(call: Callable[[], None], reps: int = 5,
               calls: int = 20) -> float:
    """Median over `reps` of the mean time of `calls` back-to-back calls."""
    call()
    torch.cuda.synchronize()
    times: List[float] = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main(argv: Optional[List[str]] = None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("quant_tc_parts: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    fns = _libraries()
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for fmt in quant.WEIGHT_FORMATS:
        for m, d, n in SHAPES:
            qt = quant.quantize_tensor(
                torch.randn(d, n, generator=gen, device=dev) * d ** -0.5, fmt)
            x = torch.randn(m, d, generator=gen, device=dev).to(
                torch.bfloat16)
            nb = qt.scales.shape[0]
            route = quant.quant_route(x.dtype, m, d, n)
            assert route == "tensor_core", route
            splits, per = quant.quant_plan(m, n, nb, route)
            out = torch.empty((m, n), dtype=x.dtype, device=dev)
            ws = (torch.empty((splits, m, n), dtype=torch.float32,
                              device=dev) if splits > 1 else None)
            times = {}
            for parts, fn in fns.items():
                def call(fn=fn):
                    err = fn(1, quant.FMT_CODE[fmt], x.data_ptr(),
                             qt.quants.data_ptr(), qt.scales.data_ptr(),
                             None if qt.mins is None
                             else qt.mins.data_ptr(), out.data_ptr(),
                             None if ws is None else ws.data_ptr(), m, d,
                             n, nb, splits, per,
                             quant.ROUTE_CODE[route], 1, build.stream())
                    build.raise_on(err, f"quant_tc_parts {parts}")
                times[parts] = _events_ms(call)
            # the whole kernel's output (the last build timed) against the
            # plain version, at chip_smoke.py's tolerance
            want = ref.quant_matmul_reference(x, qt).float()
            tol = 1e-5 * (x.float().abs() @ quant.dequantize_tensor(qt).abs())
            _, e = torch.frexp(want)
            tol += torch.ldexp(torch.ones_like(want), e - 8)
            ok = bool(((out.float() - want).abs() <= tol).all())
            w = quant.dequantize_tensor(qt).to(torch.bfloat16)
            yard = _events_ms(lambda: torch.matmul(x, w))
            flops = 2 * m * d * n
            print(f"{fmt} ({m}x{d})@({d}x{n}), {splits} split(s): "
                  + "; ".join(f"{PARTS[p]} {t:.4f} ms" for p, t in
                              times.items())
                  + f" (= {flops / times[3] / 1e9:.1f} TFLOP/s); cuBLAS "
                  f"bf16 matmul {yard:.4f} ms; whole kernel within "
                  f"tolerance: {ok}", flush=True)
            if not ok:
                raise SystemExit("quant_tc_parts: the whole kernel is off "
                                 "its plain version")


if __name__ == "__main__":
    main()
