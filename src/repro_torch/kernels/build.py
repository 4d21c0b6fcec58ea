"""The build of the port's CUDA kernels, shared by every wrapper module.

Each source `csrc/*.cu` is compiled by its own `nvcc` for `sm_90a`, all
at once, and the objects are linked into ONE shared library with a plain
C interface, at first use, under `build/repro_torch_kernels/` at the
repository root, and loaded with `ctypes`.  Nothing is built or loaded
when a module is imported.

`LAUNCHES` counts the launches of every kernel, one per wrapper call that
reaches its kernel and nowhere else; the wrappers add to it and
`reset_launch_counts()` sets every count to 0.  A function with several
kernels counts every launch under its own name and, in `VARIANTS`, the
launches that took one of its routes (its tensor-core kernel, the skinny
decode kernel) or also ran a split-K reduction pass.  Inside
`launch_site(site)`, a decode launch also counts under "<name>@<site>",
so that one model's call sites of the same kernel are told apart (an
enc-dec decoder's cross reads from its self reads).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# the build log beside the library
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"decode_attention_fused": 0,
                            "decode_attention_fused[int8]": 0,
                            "decode_attention_fused_partial": 0,
                            "decode_attention_fused_partial[int8]": 0,
                            "flash_attention": 0,
                            "decode_attention_partial": 0,
                            "ssd_scan": 0,
                            "quant_matmul[q8_0]": 0,
                            "quant_matmul[q4_k]": 0,
                            "knn_distances": 0,
                            "sls": 0,
                            "flash_attention_tc": 0,
                            "knn_distances_wgmma": 0,
                            "decode_attention_fused_tc": 0,
                            "decode_attention_fused[int8]_tc": 0,
                            "decode_attention_fused_partial_tc": 0,
                            "decode_attention_fused_partial[int8]_tc": 0,
                            "decode_attention_partial_tc": 0,
                            "quant_matmul[q8_0]_tc": 0,
                            "quant_matmul[q4_k]_tc": 0,
                            "quant_matmul[q8_0]_skinny": 0,
                            "quant_matmul[q4_k]_skinny": 0,
                            "quant_matmul[q8_0]_splitk": 0,
                            "quant_matmul[q4_k]_splitk": 0,
                            "ssd_scan_tc": 0, "ssd_scan_init": 0}
# the counters of a function's routes (its tensor-core kernel, the skinny
# decode kernel), of its split-K reduction pass and of the scans started
# from a given state (`ssd_scan_init`, a resume prefill's): parts of the
# counts of the function they name, not kernels of their own
VARIANTS = ("flash_attention_tc", "knn_distances_wgmma",
            "decode_attention_fused_tc", "decode_attention_fused[int8]_tc",
            "decode_attention_fused_partial_tc",
            "decode_attention_fused_partial[int8]_tc",
            "decode_attention_partial_tc", "quant_matmul[q8_0]_tc",
            "quant_matmul[q4_k]_tc", "quant_matmul[q8_0]_skinny",
            "quant_matmul[q4_k]_skinny", "quant_matmul[q8_0]_splitk",
            "quant_matmul[q4_k]_splitk", "ssd_scan_tc", "ssd_scan_init",
            "decode_attention_fused@cross", "decode_attention_partial@cross")
# the call sites counted apart: "cross", an enc-dec decoder's cross read
# over the encoder output
SITES = ("cross",)
for _name in VARIANTS[-2:]:
    LAUNCHES[_name] = 0
_site: List[Optional[str]] = [None]

_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, Callable[..., int]] = {}
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def launch_site(site: str):
    """Count the decode launches made inside it under "<name>@<site>" as
    well (a CUDA graph captured inside it replays those counts too)."""
    if site not in SITES:
        raise ValueError(f"no call site {site!r}: the sites are {SITES}")
    outer, _site[0] = _site[0], site
    try:
        yield
    finally:
        _site[0] = outer


def count_site(name: str) -> None:
    """One launch of `name` more at the current call site, if one is
    named; the wrappers call it where they count the launch."""
    if _site[0] is not None:
        LAUNCHES[f"{name}@{_site[0]}"] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or CUDA_HOME)")
    return str(path)


def library_path() -> Path:
    """Where the build of the current sources goes: keyed by the hash of
    every source and header, so an edited one is never served by a stale
    library."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.read_bytes())
    digest.update(" ".join(COMPILE_FLAGS).encode())
    return BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"


def _run(cmd: List[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile `csrc/*.cu` with nvcc unless the library for these sources
    exists already: one nvcc per source, all at once, then one link.
    The compilers' output goes to `<library>.log`.  Returns the
    library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(
            lambda so: _run([nvcc_path(), *COMPILE_FLAGS, "-c", str(so[0]),
                             "-o", str(so[1])], so[0].name),
            zip(sources, objects)))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    logs.append(_run([nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objects)], "the link"))
    for obj in objects:
        obj.unlink()
    out.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, out)
    return out


def function(name: str, argtypes: List) -> Callable[..., int]:
    """The library's C entry point `name`, typed: `argtypes` as given, an
    int (the launch's cudaError_t) returned.  Builds and loads the
    library on the first call."""
    global _lib
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lib_lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
        return fn


# --------------------------------------------------------------------------
# What every wrapper checks before it launches
# --------------------------------------------------------------------------

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """CUDA, contiguous, one device, and one dtype the kernels take."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors; "
                             f"got one on {t.device} (ops.{name} sends CPU "
                             "tensors to the plain version)")
        check(t.is_contiguous(), f"{name}: inputs must be contiguous")
    dt = tensors[0].dtype
    check(dt in DTYPE_CODE,
          f"{name}: dtype {dt} not supported (float32 or bfloat16)")
    check(all(t.dtype == dt for t in tensors),
          f"{name}: inputs must share one dtype")
    dev = tensors[0].device
    check(all(t.device == dev for t in tensors),
          f"{name}: inputs must be on one device")


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream() -> int:
    """The current PyTorch stream of the current device, as the kernels' C
    interface takes it: its raw cudaStream_t, from PyTorch's own accessor
    (the one its Triton launcher uses), which costs a launch far less host
    time than building a `torch.cuda.Stream` with
    `torch.cuda.current_stream()`."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
