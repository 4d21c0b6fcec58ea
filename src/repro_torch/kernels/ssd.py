"""Hopper CUDA Mamba2 SSD chunked scan and its wrapper.

The kernel lives in `csrc/ssd.cu` (its source note names the Pallas
kernel of `repro/kernels/ssd.py` it replaces and what bounds it on an
H100).  `build.py` compiles it with the port's other kernels at first use
and binds it with `ctypes`; nothing is built when this module is imported.

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with `torch.empty`, launches on
`torch.cuda.current_stream()` and raises if the launch fails.  It never
falls back to the plain PyTorch version: `ops.ssd_scan` dispatches CPU
tensors there before the wrapper is reached.  Each launch adds one to
`build.LAUNCHES["ssd_scan"]`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LAUNCHES, check,
                                       check_inputs, function, raise_on,
                                       stream)

# the kernel keeps a chunk of B and C in shared memory: (2*64 + 16) rows
# of N+1 floats, plus ~24 KB, within the 227 KB a block may have
MAX_STATE = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


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
    err = function("rt_ssd_scan", _SIGNATURE)(
        DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), b, s, h, p, n, stream())
    raise_on(err, name)
    LAUNCHES[name] += 1
    return y, final
