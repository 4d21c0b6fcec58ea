"""Hopper CUDA SparseLengthsSum (embedding bags) and its wrapper.

The kernel lives in `csrc/sls.cu` (its source note names the Pallas
kernel of `repro/kernels/sls.py` it replaces and what bounds it on an
H100).  `build.py` compiles it with the port's other kernels at first use
and binds it with `ctypes`; nothing is built when this module is imported.

The wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its output with `torch.empty`, launches on
`torch.cuda.current_stream()` and raises if the launch fails.  It never
falls back to the plain PyTorch version: `ops.sls` dispatches CPU tensors
there before the wrapper is reached.  Each launch adds one to
`build.LAUNCHES["sls"]`.

An index outside [0, V) adds nothing to its bag, as the padding index -1
does: the kernel tests every index before it loads a row, so it never
reads outside the table.  The wrapper cannot look at the indices without
a host sync, and does not.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LAUNCHES, check,
                                       check_inputs, function, raise_on,
                                       stream)

# the kernel takes its sizes as C ints; its grid has 4 bags per block on
# the x axis and 256-column slices of D on the y axis (at most 65535)
MAX_INT = 2 ** 31 - 1
MAX_D = 65535 * 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def check_args(table: torch.Tensor, indices: torch.Tensor,
               weights: Optional[torch.Tensor] = None
               ) -> Tuple[int, int, int, int]:
    """Everything the kernel asks of its inputs apart from the device:
    shapes, dtypes, contiguity, one device.  Returns (B, L, V, D)."""
    name = "sls"
    check(table.dim() == 2 and indices.dim() == 2,
          f"{name}: table (V,D) and indices (B,L) expected, got "
          f"{tuple(table.shape)} and {tuple(indices.shape)}")
    (v, d), (b, l) = table.shape, indices.shape
    check(v >= 1 and d >= 1 and b >= 1 and l >= 1,
          f"{name}: empty input: V={v} D={d} B={b} L={l}")
    check(max(v, b, l) <= MAX_INT and d <= MAX_D,
          f"{name}: V={v} D={d} B={b} L={l} past the kernel's grid")
    check(table.dtype in DTYPE_CODE,
          f"{name}: table dtype {table.dtype} not supported (float32 or "
          "bfloat16)")
    check(indices.dtype == torch.int32,
          f"{name}: indices must be int32, got {indices.dtype}")
    tensors = [table, indices]
    if weights is not None:
        check(weights.dtype == torch.float32
              and tuple(weights.shape) == (b, l),
              f"{name}: weights must be float32 {(b, l)}, got "
              f"{weights.dtype} {tuple(weights.shape)}")
        tensors.append(weights)
    check(all(t.is_contiguous() for t in tensors),
          f"{name}: inputs must be contiguous")
    check(all(t.device == table.device for t in tensors),
          f"{name}: inputs must be on one device")
    return b, l, v, d


def sls(table: torch.Tensor, indices: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled embedding bags on the card, as `ref.sls_reference` computes
    them: table (V,D) f32 or bf16, indices (B,L) int32 (-1 pads), weights
    (B,L) f32 or None (all ones); any B, L, D.  Returns (B,D) float32."""
    name = "sls"
    check_inputs(name, table)
    b, l, v, d = check_args(table, indices, weights)
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    err = function("rt_sls", _SIGNATURE)(
        DTYPE_CODE[table.dtype], table.data_ptr(), indices.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        b, l, v, d, stream())
    raise_on(err, name)
    LAUNCHES[name] += 1
    return out
