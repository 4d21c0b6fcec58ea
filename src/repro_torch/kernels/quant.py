"""Block-quantized weights and the Hopper dequant-fused matmul, the port of
`repro/kernels/quant.py`.

Weights live on the card as packed per-block quants plus f32 scales (q8_0:
32 int8 and one scale per (block, column); q4_k: 32 nibbles, one scale and
one min) and are dequantized inside the matmul kernel (`csrc/quant.cu`),
so the fp weight never exists in device memory.  `build.py` compiles the
kernel with the port's others at first use; nothing is built when this
module is imported.

`QTensor` is a plain dataclass of tensors.  A stacked one (a leading
n_blocks axis) is sliced per layer with `layer(i)`, a view of each leaf.

The wrapper `quant_matmul` takes CUDA tensors only, checks device, dtype,
shape and contiguity, allocates its output and any split-K workspace with
`torch.empty`, launches on `torch.cuda.current_stream()`, raises if the
launch fails and adds one to `build.LAUNCHES["quant_matmul[<fmt>]"]`, and
one to the route's own counter: `"quant_matmul[<fmt>]_skinny"` or
`"quant_matmul[<fmt>]_tc"`; `"quant_matmul[<fmt>]_splitk"` counts the
calls that also ran the split-K reduction pass.
`quant_route` picks the kernel from the shape, dtype and alignment: for
decode (m <= 16) one launch of `skinny_tc_kernel` on the tensor cores or
`skinny_kernel` on the CUDA cores (`skinny_tensor_core`, `skinny_plan`),
`quant_tc_kernel` on the tensor cores for bf16 prefill, `tiled_kernel` on
the CUDA cores for the rest (f32).
`ops.quant_matmul` sends CPU tensors to `ref.quant_matmul_reference`
before the wrapper is reached.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import (DTYPE_CODE, LAUNCHES, check,
                                       check_inputs, function, raise_on,
                                       stream)

QUANT_BLOCK = _ref.QUANT_BLOCK
WEIGHT_FORMATS = ("q8_0", "q4_k")
FMT_CODE = {"q8_0": 0, "q4_k": 1}

# the kernels' tiles (csrc/quant.cu): a skinny block covers 4 rows of x and
# one of SKINNY_TILES columns (128 on the tensor cores), a tiled block 64
# rows and 128 columns, a tensor-core block 128 rows and 128 columns
SKINNY_MAX_M = 16
SKINNY_ROWS, TILED_ROWS, TC_ROWS, TILE_COLS = 4, 64, 128, 128
SMS = 132                    # streaming multiprocessors of an H100 SXM
ROUTES = ("skinny", "tiled", "tensor_core")
ROUTE_CODE = {r: i for i, r in enumerate(ROUTES)}
# skinny_kernel: 128 threads, 16 column groups by 8 row groups (each
# thread 4 rows of every quant block); column tiles of 128, 64 or 32;
# up to 8 blocks a cluster (the portable limit); three blocks a SM; stages
# of up to 8 KB of quants; x in windows of 64 quant blocks
SKINNY_TILES = (128, 64, 32)
SKINNY_COL_GROUPS, SKINNY_ROW_GROUPS = 16, 8
SKINNY_MAX_CLUSTER, SKINNY_BLOCKS_PER_SM = 8, 3
SKINNY_STAGE_BYTES, SKINNY_X_WINDOW = 8192, 64
SKINNY_TC_MIN_TILES = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _I, _I, _P]
_SKINNY_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]


@dataclasses.dataclass
class QTensor:
    """A block-quantized (..., d_in, n) weight, leading axes stacked.

    scales: (..., nB, n) f32        per (block, column) scale
    quants: (..., nB, 32, n) int8   (q8_0)
            (..., nB, 16, n) uint8  (q4_k, two nibbles a byte)
    mins:   (..., nB, n) f32        (q4_k; None for q8_0)
    fmt:    "q8_0" | "q4_k"
    d_in:   the input width before block padding"""
    scales: torch.Tensor
    quants: torch.Tensor
    mins: Optional[torch.Tensor]
    fmt: str
    d_in: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.scales.shape[:-2]) + (self.d_in,
                                                self.scales.shape[-1])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.scales, self.quants, self.mins)
                   if t is not None)

    def layer(self, i: int) -> "QTensor":
        """Layer i of a stacked weight: a view of each leaf."""
        return QTensor(self.scales[i], self.quants[i],
                       None if self.mins is None else self.mins[i],
                       self.fmt, self.d_in)


def quantize_tensor(w: torch.Tensor, fmt: str,
                    block: int = QUANT_BLOCK) -> QTensor:
    """Quantize a (..., d, n) weight into the given block format."""
    if fmt == "q8_0":
        scales, quants = _ref.quantize_q8_0(w, block)
        return QTensor(scales, quants, None, fmt, w.shape[-2])
    if fmt == "q4_k":
        scales, mins, quants = _ref.quantize_q4_k(w, block)
        return QTensor(scales, quants, mins, fmt, w.shape[-2])
    raise ValueError(f"unknown quant format: {fmt}")


def dequantize_tensor(qt: QTensor) -> torch.Tensor:
    """The f32 (..., d_in, n) weight (the plain path)."""
    return _ref.dequantize_weight(qt.fmt, qt.scales, qt.quants, qt.mins,
                                  qt.d_in)


def quant_route(dtype: torch.dtype, m: int, d: int, n: int,
                aligned: bool = True) -> str:
    """The kernel that takes these inputs: "skinny" for m <= 16 (decode);
    else "tensor_core" for bf16 x with d % 8 == 0, n % 16 == 0 and
    16-byte-aligned x and weight leaves (`aligned`), the whole-chunk
    copies of `quant_tc_kernel`; else "tiled" (the CUDA cores: f32 and
    the rest)."""
    if m <= SKINNY_MAX_M:
        return "skinny"
    if dtype == torch.bfloat16 and d % 8 == 0 and n % 16 == 0 and aligned:
        return "tensor_core"
    return "tiled"


def skinny_tensor_core(dtype: torch.dtype, d: int, n: int,
                       aligned: bool) -> bool:
    """Whether the skinny route runs on the tensor cores
    (`skinny_tc_kernel`): bf16 x with d % 8 == 0, 16-byte-aligned x and
    weight leaves (`aligned`) and at least SKINNY_TC_MIN_TILES column tiles
    of 128; f32 x, narrow n (wk / wv: 2 tiles, where the CUDA-core
    kernel's 32-column tiles give 4x the blocks) and the rest take
    `skinny_kernel` on the CUDA cores."""
    return (dtype == torch.bfloat16 and d % 8 == 0 and aligned
            and -(-n // SKINNY_TILES[0]) >= SKINNY_TC_MIN_TILES)


def skinny_plan(n: int, n_blocks: int,
                tensor_core: bool = False) -> Tuple[int, int, int, int]:
    """The skinny kernels' grid, a function of n, the number of quant
    blocks and the kernel only (never of m, so a row's bits do not depend
    on its batch): (tile_cols, splits, per_split, kb_per_stage).
    * tile_cols: 128 on the tensor cores (4 warps of 32 columns); on the
      CUDA cores the widest of SKINNY_TILES whose column tiles, split 8
      ways, give at least two blocks a SM, else the narrowest;
    * splits: the blocks of a cluster, each taking `per_split` consecutive
      quant blocks: the largest power of two up to 8 that leaves no split
      empty and, on the CUDA cores, keeps the grid within one wave of
      SKINNY_BLOCKS_PER_SM blocks a SM (the tensor-core kernel, lighter,
      runs best with the most splits: measured, PERF.md);
    * kb_per_stage: quant blocks a pipeline stage, a power of two, up to
      SKINNY_STAGE_BYTES of q8_0 quants and at most per_split; on the
      tensor cores 2 or 4, which its kernel unrolls.
    Every thread of a block works on every quant block of its split: on
    the CUDA cores 16 column groups of tile_cols / 16 columns by 8 row
    groups of 4 rows, on the tensor cores 4 warps of 32 columns."""
    slots = SKINNY_BLOCKS_PER_SM * SMS
    tile = SKINNY_TILES[0] if tensor_core else next(
        (t for t in SKINNY_TILES
         if -(-n // t) * SKINNY_MAX_CLUSTER >= 2 * SMS), SKINNY_TILES[-1])
    tiles = -(-n // tile)
    splits = 1
    while (2 * splits <= min(SKINNY_MAX_CLUSTER, n_blocks)
           and (tensor_core or 2 * splits * tiles <= slots)):
        splits *= 2
    while splits > 1 and (splits - 1) * -(-n_blocks // splits) >= n_blocks:
        splits //= 2
    per = -(-n_blocks // splits)
    if tensor_core:
        # 4 quant blocks a stage where the grid is under a wave of two
        # blocks a SM (the larger stage's residency), else 2
        return tile, splits, per, 4 if tiles * splits <= 2 * SMS else 2
    ks = 1
    while (2 * ks * QUANT_BLOCK * tile <= SKINNY_STAGE_BYTES
           and 2 * ks <= per):
        ks *= 2
    return tile, splits, per, ks


def quant_plan(m: int, n: int, n_blocks: int,
               route: str) -> Tuple[int, int]:
    """The kernel's split of d, a function of the problem's shape and route
    only: (splits, blocks per split).  The skinny kernel's comes from
    `skinny_plan` (its splits are the blocks of a cluster, reduced inside
    the launch); the tiled and tensor-core kernels walk their blocks of d
    in order, split across thread blocks only where the output tiles alone
    leave SMs idle, and a second pass sums the splits' f32 partials in
    split order, so the result does not depend on timing (no float
    atomics)."""
    if route == "skinny":
        _, splits, per, _ = skinny_plan(n, n_blocks)
        return splits, per
    col_tiles = -(-n // TILE_COLS)
    rows = {"tiled": TILED_ROWS, "tensor_core": TC_ROWS}[route]
    tiles = col_tiles * -(-m // rows)
    splits = 1
    if tiles < SMS:
        splits = max(1, min(-(-2 * SMS // tiles), n_blocks // 8))
    per_split = min(-(-n_blocks // splits), n_blocks)
    return -(-n_blocks // per_split), per_split


def check_args(x: torch.Tensor, qt: QTensor) -> Tuple[int, int, int]:
    """Everything the kernel asks of its inputs apart from the device:
    shapes, dtypes, contiguity, one device.  Returns (m, n, nB)."""
    name = f"quant_matmul[{qt.fmt}]"
    check(qt.fmt in FMT_CODE, f"unknown quant format: {qt.fmt}")
    check(x.dim() == 2 and x.shape[0] >= 1,
          f"{name}: x must be (m, d_in), m >= 1; got {tuple(x.shape)}")
    check(qt.scales.dim() == 2,
          f"{name}: an unstacked QTensor is expected (slice it per layer)")
    m, d = x.shape
    nb, n = qt.scales.shape
    check(d == qt.d_in and nb == -(-d // QUANT_BLOCK),
          f"{name}: x width {d} against a weight of d_in {qt.d_in}, "
          f"{nb} blocks")
    qdt, rows = ((torch.int8, QUANT_BLOCK) if qt.fmt == "q8_0"
                 else (torch.uint8, QUANT_BLOCK // 2))
    check(qt.quants.dtype == qdt and tuple(qt.quants.shape) == (nb, rows, n),
          f"{name}: quants must be {qdt} ({nb}, {rows}, {n})")
    per_column = [qt.scales]
    if qt.fmt == "q4_k":
        check(qt.mins is not None, f"{name}: q4_k needs mins")
        per_column.append(qt.mins)
    for t in per_column:
        check(t.dtype == torch.float32 and tuple(t.shape) == (nb, n),
              f"{name}: scales and mins must be f32 ({nb}, {n})")
    for t in per_column + [qt.quants]:
        check(t.device == x.device and t.is_contiguous(),
              f"{name}: weight leaves must be contiguous, on x's device")
    return m, n, nb


def quant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (m, d_in) @ dequantize(qt) (d_in, n) -> (m, n) in x's dtype (bf16
    or f32) on the card, with f32 accumulation.  The ragged edges of m, n
    and d are masked inside the kernel: lanes of x past d_in count as
    zero, so a q4_k padded lane (which dequantizes to its min) adds
    nothing."""
    name = f"quant_matmul[{qt.fmt}]"
    check_inputs(name, x)
    m, n, nb = check_args(x, qt)
    d = x.shape[1]
    leaves = [t for t in (qt.quants, qt.scales, qt.mins) if t is not None]
    vec = n % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in leaves)
    route = quant_route(x.dtype, m, d, n, vec and x.data_ptr() % 16 == 0)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    mins = None if qt.mins is None else qt.mins.data_ptr()
    if route == "skinny":
        tc = skinny_tensor_core(x.dtype, d, n,
                                vec and x.data_ptr() % 16 == 0)
        tile, splits, per_split, ks = skinny_plan(n, nb, tc)
        err = function("rt_quant_skinny", _SKINNY_SIGNATURE)(
            DTYPE_CODE[x.dtype], FMT_CODE[qt.fmt], x.data_ptr(),
            qt.quants.data_ptr(), qt.scales.data_ptr(), mins,
            out.data_ptr(), m, d, n, nb, tile, splits, per_split, ks,
            int(vec), int(tc), stream())
    else:
        splits, per_split = quant_plan(m, n, nb, route)
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        err = function("rt_quant_matmul", _SIGNATURE)(
            DTYPE_CODE[x.dtype], FMT_CODE[qt.fmt], x.data_ptr(),
            qt.quants.data_ptr(), qt.scales.data_ptr(), mins,
            out.data_ptr(), None if ws is None else ws.data_ptr(), m, d, n,
            nb, splits, per_split, ROUTE_CODE[route], int(vec), stream())
    raise_on(err, name)
    LAUNCHES[name] += 1
    if route != "tiled":
        LAUNCHES[name + ("_tc" if route == "tensor_core" else "_skinny")] += 1
    if route != "skinny" and splits > 1:
        LAUNCHES[name + "_splitk"] += 1
    return out
