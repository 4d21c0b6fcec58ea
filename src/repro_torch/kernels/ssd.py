"""Hopper CUDA Mamba2 SSD chunked scan and its wrapper.

The kernel lives in `csrc/ssd.cu` (its source note names the Pallas
kernel of `repro/kernels/ssd.py` it replaces and what bounds it on an
H100).  `build.py` compiles it with the port's other kernels at first use
and binds it with `ctypes`; nothing is built when this module is imported.

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs (and the tensor-core route's workspace)
with `torch.empty`, launches on `torch.cuda.current_stream()` and raises
if the launch fails.  It never falls back to the plain PyTorch version:
`ops.ssd_scan` dispatches CPU tensors there before the wrapper is
reached.  Each call adds one to `build.LAUNCHES["ssd_scan"]`, and one to
`"ssd_scan_tc"` when it took the tensor-core route (`ssd_route`: three
kernels, chunk states, the ordered pass and the outputs), and one to
`"ssd_scan_init"` when it started from a given `init_state` (a resume
prefill's scan).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LAUNCHES, check,
                                       check_inputs, function, raise_on,
                                       stream)

# the CUDA-core kernel keeps a chunk of B and C in shared memory: (2*64 +
# 16) rows of N+1 floats, plus ~24 KB, within the 227 KB a block may have
MAX_STATE = 256
CHUNK = 64                       # sequence rows of a chunk, both routes
TC_HEAD, TC_STATE = 64, 128      # the tensor-core route's P and N
ROUTES = ("cuda_core", "tensor_core")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _P]


def _check_f32(name: str, what: str, t: torch.Tensor, shape: tuple,
               device: torch.device) -> None:
    check(t.device == device and t.dtype == torch.float32
          and tuple(t.shape) == shape and t.is_contiguous(),
          f"{name}: {what} must be contiguous float32 {shape} on {device}")


def check_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[int, int, int, int, int]:
    """Everything the kernel asks of its inputs apart from the device:
    shapes, dtypes, contiguity, one device.  Returns (b, s, h, p, n)."""
    name = "ssd_scan"
    check(x.dim() == 4 and B.dim() == 3,
          f"{name}: x (b,s,h,p) and B, C (b,s,n) expected")
    b, s, h, p = x.shape
    n = B.shape[2]
    check(tuple(B.shape) == (b, s, n) and C.shape == B.shape,
          f"{name}: shapes x {tuple(x.shape)} B {tuple(B.shape)} "
          f"C {tuple(C.shape)}")
    check(s >= 1 and 1 <= n <= MAX_STATE,
          f"{name}: needs s >= 1 and a state of 1..{MAX_STATE}, got s={s} "
          f"n={n}")
    check(x.dtype in DTYPE_CODE,
          f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    check(B.dtype == x.dtype and C.dtype == x.dtype,
          f"{name}: x, B and C must share one dtype")
    check(all(t.is_contiguous() and t.device == x.device for t in (B, C))
          and x.is_contiguous(),
          f"{name}: x, B and C must be contiguous, on one device")
    _check_f32(name, "dt", dt, (b, s, h), x.device)
    _check_f32(name, "A", A, (h,), x.device)
    if init_state is not None:
        _check_f32(name, "init_state", init_state, (b, h, p, n), x.device)
    return b, s, h, p, n


def ssd_route(dtype: torch.dtype, p: int, n: int,
              aligned: bool = True) -> str:
    """The kernels that take these inputs: "tensor_core" for bf16 with P =
    64 and N = 128 (mamba2_370m's heads) and 16-byte-aligned x, B, C and
    init_state (`aligned`); else "cuda_core" (f32 and other widths)."""
    if (dtype == torch.bfloat16 and (p, n) == (TC_HEAD, TC_STATE)
            and aligned):
        return "tensor_core"
    return "cuda_core"


def ssd_workspace(b: int, s: int, h: int, p: int, n: int) -> int:
    """Floats of the tensor-core route's workspace: every chunk's (P, N)
    state, C B^T (CHUNK x CHUNK) and cumsum (H x CHUNK)."""
    chunks = b * -(-s // CHUNK)
    return chunks * (h * p * n + CHUNK * CHUNK + h * CHUNK)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence on the card, as `ref.ssd_reference` computes it.
    x: (b,s,h,p) bf16 or f32; dt: (b,s,h) f32; A: (h,) f32; B, C: (b,s,n)
    in x's dtype, one group shared by every head; init_state: optional
    (b,h,p,n) f32 (zeros when None).  Any s >= 1.  Returns (y (b,s,h,p) in
    x's dtype, final state (b,h,p,n) f32)."""
    name = "ssd_scan"
    check_inputs(name, x, B, C)
    b, s, h, p, n = check_args(x, dt, A, B, C, init_state)
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, B, C, init_state)
                  if t is not None)
    route = ssd_route(x.dtype, p, n, aligned)
    ws = (torch.empty(ssd_workspace(b, s, h, p, n), dtype=torch.float32,
                      device=x.device) if route == "tensor_core" else None)
    err = function("rt_ssd_scan", _SIGNATURE)(
        DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), None if ws is None else ws.data_ptr(),
        b, s, h, p, n, ROUTES.index(route), stream())
    raise_on(err, name)
    LAUNCHES[name] += 1
    if route == "tensor_core":
        LAUNCHES[name + "_tc"] += 1
    if init_state is not None:
        LAUNCHES[name + "_init"] += 1
    return y, final
