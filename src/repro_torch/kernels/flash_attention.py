"""Hopper CUDA attention kernels and their wrappers.

The kernels live in `csrc/attention.cu` (each one's source note names the
Pallas kernel of `repro/kernels/flash_attention.py` it replaces and what
bounds it on an H100).  They are compiled with `nvcc` for `sm_90a` into a
shared library with a plain C interface at first use, under
`build/repro_torch_kernels/` at the repository root, and bound with
`ctypes`.  Nothing here is built or imported when the module is imported.

Every wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with `torch.empty`, launches on
`torch.cuda.current_stream()` and raises if the launch fails.  It never
falls back to the plain PyTorch version: `ops.py` dispatches CPU tensors
there before a wrapper is reached.  `LAUNCHES` counts the launches of each
kernel (one per call that reaches the kernel, and nowhere else).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {"decode_attention_fused": 0,
                            "flash_attention": 0,
                            "decode_attention_partial": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rt_decode_fused": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "rt_decode_partial": [_I, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _F, _P],
    "rt_flash_attention": [_I, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _F, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    """Where the build of the current sources goes: keyed by their hash, so
    an edited source is never served by a stale library."""
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libattention_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/*.cu` with nvcc unless the library for these sources
    exists already.  Returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_inputs(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors; "
                             f"got one on {t.device} (ops.{name} sends CPU "
                             "tensors to the plain version)")
        _check(t.is_contiguous(), f"{name}: inputs must be contiguous")
    dt = tensors[0].dtype
    _check(dt in _DTYPE_CODE,
           f"{name}: dtype {dt} not supported (float32 or bfloat16)")
    _check(all(t.dtype == dt for t in tensors),
           f"{name}: q, k and v must share one dtype")
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors),
           f"{name}: inputs must be on one device")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def decode_tile(blk_c: int) -> int:
    """KV rows per tile of the decode kernels: the largest divisor of the
    chunk not above 64, so that a tile never straddles a page."""
    tile = min(64, blk_c)
    while blk_c % tile:
        tile -= 1
    return tile


def dense_chunk(s: int, blk_c: int) -> int:
    """The dense decode chunk: the largest divisor of s not above blk_c
    (the Pallas kernel's rule, and `default_page_size`'s)."""
    blk_c = max(1, min(blk_c, s))
    while s % blk_c:
        blk_c -= 1
    return blk_c


def decode_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor,
                           extra: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]] = None,
                           *, window: int = 0, blk_c: int = 128,
                           pages: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-shot flash decode on the card: q (B,1,H,hd) against the whole
    cache k/v (B,KH,S,hd), per-row last valid slot pos (B,) int32, slots
    `pos-window < slot <= pos` attended (window 0: no lower bound).
    `extra`: optional f32 (acc (B,H,hd), m (B,H), l (B,H)) merged in the
    epilogue.  `pages`: optional (B, n_log) int32 page table into each
    row's own panel; `blk_c` is then the exact page size.  Returns
    (B,1,H,hd) in q's dtype."""
    name = "decode_attention_fused"
    _check_inputs(name, q, k, v)
    b, one, h, hd = q.shape
    _check(one == 1 and k.dim() == 4 and k.shape == v.shape,
           f"{name}: q (B,1,H,hd), k/v (B,KH,S,hd) expected")
    kh, s = k.shape[1], k.shape[2]
    _check(k.shape[0] == b and k.shape[3] == hd and h % kh == 0,
           f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    _check(pos.is_cuda and pos.dtype == torch.int32 and pos.shape == (b,)
           and pos.is_contiguous(), f"{name}: pos must be (B,) int32 CUDA")
    if pages is None:
        blk_c = dense_chunk(s, blk_c)
        n_log = 0
        pages_ptr = None
    else:
        _check(pages.is_cuda and pages.dtype == torch.int32
               and pages.dim() == 2 and pages.shape[0] == b
               and pages.is_contiguous(),
               f"{name}: pages must be (B, n_log) int32 CUDA")
        _check(blk_c > 0 and s % blk_c == 0,
               f"{name}: page size {blk_c} must divide S={s}")
        n_log = pages.shape[1]
        pages_ptr = pages.data_ptr()
    acc_e = m_e = l_e = None
    if extra is not None:
        acc_e, m_e, l_e = extra
        for t, shape in ((acc_e, (b, h, hd)), (m_e, (b, h)), (l_e, (b, h))):
            _check(t.is_cuda and t.dtype == torch.float32
                   and tuple(t.shape) == shape and t.is_contiguous(),
                   f"{name}: extra must be contiguous f32 CUDA "
                   "(B,H,hd), (B,H), (B,H)")
    out = torch.empty_like(q)
    err = _library().rt_decode_fused(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), pages_ptr, n_log,
        None if acc_e is None else acc_e.data_ptr(),
        None if m_e is None else m_e.data_ptr(),
        None if l_e is None else l_e.data_ptr(),
        out.data_ptr(), b, h, kh, s, hd, blk_c, decode_tile(blk_c),
        int(window), float(hd ** -0.5), _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Raw partial-softmax statistics on the card: q (B,1,H,hd); k/v
    (B,KH,C,hd); valid (B,C) bool.  Returns f32 (acc (B,H,hd), m (B,H),
    l (B,H)) with m = -inf where a row has no valid slot."""
    name = "decode_attention_partial"
    _check_inputs(name, q, k, v)
    b, one, h, hd = q.shape
    _check(one == 1 and k.dim() == 4 and k.shape == v.shape,
           f"{name}: q (B,1,H,hd), k/v (B,KH,C,hd) expected")
    kh, c = k.shape[1], k.shape[2]
    _check(k.shape[0] == b and k.shape[3] == hd and h % kh == 0,
           f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    _check(valid.is_cuda and valid.dtype == torch.bool
           and tuple(valid.shape) == (b, c) and valid.is_contiguous(),
           f"{name}: valid must be (B, C) bool CUDA")
    acc = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    err = _library().rt_decode_partial(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, kh, c, hd, 64, float(hd ** -0.5), _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return acc, m, l


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill flash attention on the card: q (B,S,H,hd), k/v (B,S,KH,hd)
    -> (B,S,H,hd), causal and/or sliding window, GQA.  Any S: the kernel
    masks the ragged edge of its tiles itself."""
    name = "flash_attention"
    _check_inputs(name, q, k, v)
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"{name}: q (B,S,H,hd), k/v (B,S,KH,hd) expected")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    _check(k.shape[0] == b and k.shape[1] == s and k.shape[3] == hd
           and h % kh == 0,
           f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    out = torch.empty_like(q)
    err = _library().rt_flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, h, kh, hd, int(causal), int(window),
        float(hd ** -0.5), _stream())
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out
