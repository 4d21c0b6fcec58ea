"""Hopper CUDA attention kernels and their wrappers.

The kernels live in `csrc/attention.cu` (each one's source note names the
Pallas kernel of `repro/kernels/flash_attention.py` it replaces and what
bounds it on an H100).  `build.py` compiles them with the port's other
kernels at first use and binds them with `ctypes`; nothing is built when
this module is imported.

The fused decode has a sibling entry, `decode_attention_fused_partial`:
the same launch with a raw-statistics epilogue, the mesh decode's
producer.

Every wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs with `torch.empty`, launches on
`torch.cuda.current_stream()` and raises if the launch fails.  It never
falls back to the plain PyTorch version: `ops.py` dispatches CPU tensors
there before a wrapper is reached.  Each launch adds one to its kernel's
count in `build.LAUNCHES`, and an fp decode's inside a named
`build.launch_site` to its site's count too.

Prefill has two kernels: `flash_tc_kernel` on the tensor cores takes bf16
with a head dim of 64, 80, 128 or 256 and 16-byte-aligned bases,
`flash_kernel` on the CUDA cores takes the rest.  `flash_route` is that rule, a dispatch on
what each kernel takes: a refused launch of either still raises.  Decode
(fused and partial) splits the KV range as `decode_split` says, runs each
split on `decode_split_tc_kernel` (the tensor cores) where `decode_route`
says so and on `decode_split_kernel` (the CUDA cores, f32) otherwise, and
merges the splits in order with a second kernel; the wrapper allocates the
splits' workspace.  A launch on the tensor-core route also counts under
`<name>_tc` (`build.VARIANTS`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (DTYPE_CODE, LAUNCHES, check,
                                       check_inputs, count_site, function,
                                       raise_on, stream)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rt_decode_fused": [_I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                        _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                        _P],
    "rt_decode_fused_partial": [_I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                                _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "rt_decode_partial": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "rt_flash_attention": [_I, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "rt_flash_attention_tc": [_P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _F, _P],
}
# head dims the tensor-core prefill and decode kernels are compiled for
TC_HEAD_DIMS = (64, 80, 128, 256)
# query heads per KV head the tensor-core decode split takes (the mma's 16
# rows)
DECODE_TC_MAX_GROUP = 16
# KV rows of a tile of the tensor-core decode split, and the most a split
# holds at a head dim where it is not one tile: at hd 64 a whole chunk of
# up to 128 rows, walked in two tiles (csrc/attention.cu)
DECODE_TILE = 64
DECODE_SPLIT_ROWS = {64: 128}
# the chunk the partial's splits are cut from (its mask has no pages)
PARTIAL_CHUNK = 128


def _fn(name: str):
    return function(name, _SIGNATURES[name])


def decode_split_rows(blk_c: int, hd: int) -> int:
    """KV rows per split of the decode kernels: the largest divisor of the
    chunk not above DECODE_SPLIT_ROWS at this head dim (64 where it names
    none), so that a split never straddles a page."""
    rows = min(DECODE_SPLIT_ROWS.get(hd, DECODE_TILE), blk_c)
    while blk_c % rows:
        rows -= 1
    return rows


def decode_split(n_rows: int, blk_c: int, hd: int) -> Tuple[int, int]:
    """The decode kernels' split of the KV range, a function of the cache's
    logical length, its chunk (page) and the head dim alone: (rows per
    split, n_split).  Split j holds logical rows [j split, min((j + 1)
    split, n_rows)); the kernels put each on a block of its own and merge
    the splits in this order.  Neither B, the heads nor `pos` enter it,
    so a row alone, a head group of the mesh and a paged walk split as the
    whole batch, the whole head set and the dense walk of the same chunk
    do."""
    split = decode_split_rows(blk_c, hd)
    return split, -(-n_rows // split)


def decode_route(dtype: torch.dtype, hd: int, group: int,
                 aligned: bool = True) -> str:
    """The decode split kernel that takes these inputs: "tensor_core" for
    bf16 q with hd in TC_HEAD_DIMS, at most DECODE_TC_MAX_GROUP query heads
    per KV head and 16-byte-aligned q, k, v (`aligned`; bf16 or int8
    pools), else "cuda_core"."""
    if (dtype == torch.bfloat16 and hd in TC_HEAD_DIMS
            and group <= DECODE_TC_MAX_GROUP and aligned):
        return "tensor_core"
    return "cuda_core"


def _workspace(b: int, kh: int, n_split: int, group: int, hd: int,
               device: torch.device) -> torch.Tensor:
    """The splits' f32 (acc, m, l), one allocation: B KH n_split G rows of
    hd + 2 floats."""
    return torch.empty(b * kh * n_split * group * (hd + 2),
                       dtype=torch.float32, device=device)


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
                           pages: Optional[torch.Tensor] = None,
                           kv_scales: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None
                           ) -> torch.Tensor:
    """One-shot flash decode on the card: q (B,1,H,hd) against the whole
    cache k/v (B,KH,S,hd), per-row last valid slot pos (B,) int32, slots
    `pos-window < slot <= pos` attended (window 0: no lower bound).
    `extra`: optional f32 (acc (B,H,hd), m (B,H), l (B,H)) merged in the
    epilogue.  `pages`: optional (B, n_log) int32 page table into each
    row's own panel; `blk_c` is then the exact page size.  `kv_scales`:
    optional (k_scales, v_scales), each (B,KH,S/page) f32 per PHYSICAL
    page; k/v are then int8 pools, and the page (S / n_scales) is the
    chunk: it replaces `blk_c` when dense and must equal it when paged.
    Returns (B,1,H,hd) in q's dtype."""
    return _decode_fused(q, k, v, pos, extra, window, blk_c, pages,
                         kv_scales, raw=False)


def decode_attention_fused_partial(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
        extra: Optional[Tuple[torch.Tensor, torch.Tensor,
                              torch.Tensor]] = None,
        *, window: int = 0, blk_c: int = 128,
        pages: Optional[torch.Tensor] = None,
        kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`decode_attention_fused` without its normalisation: the same inputs,
    the same splits and the same merge (the current token's `extra`
    included), and the merged f32 statistics (acc (B,H,hd), m (B,H),
    l (B,H)) written raw, m = -inf where nothing was attended.
    `ref.normalize_fused_partial` then gives `decode_attention_fused`'s
    output bit for bit, also for head groups normalised after a gather:
    the mesh decode's producer."""
    return _decode_fused(q, k, v, pos, extra, window, blk_c, pages,
                         kv_scales, raw=True)


def _decode_fused(q, k, v, pos, extra, window, blk_c, pages, kv_scales, *,
                  raw: bool):
    """The fused decode's launch, with its normalised output (`raw`
    False) or its raw statistics (True)."""
    name = "decode_attention_fused_partial" if raw \
        else "decode_attention_fused"
    if kv_scales is not None:
        name += "[int8]"
    if kv_scales is None:
        check_inputs(name, q, k, v)
    else:
        check_inputs(name, q)
        check(all(t.is_cuda and t.dtype == torch.int8 and t.is_contiguous()
                  and t.device == q.device for t in (k, v)),
              f"{name}: k/v must be contiguous int8 pools on q's device")
    b, one, h, hd = q.shape
    check(one == 1 and k.dim() == 4 and k.shape == v.shape,
           f"{name}: q (B,1,H,hd), k/v (B,KH,S,hd) expected")
    kh, s = k.shape[1], k.shape[2]
    check(k.shape[0] == b and k.shape[3] == hd and h % kh == 0,
           f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    check(pos.is_cuda and pos.dtype == torch.int32 and pos.shape == (b,)
           and pos.is_contiguous(), f"{name}: pos must be (B,) int32 CUDA")
    n_sc = 0
    if kv_scales is not None:
        n_sc = kv_scales[0].shape[-1]
        for t in kv_scales:
            check(t.device == q.device and t.dtype == torch.float32
                  and tuple(t.shape) == (b, kh, n_sc) and t.is_contiguous(),
                  f"{name}: kv_scales must be contiguous f32 (B,KH,n_pages)")
        check(n_sc > 0 and s % n_sc == 0,
              f"{name}: {n_sc} scale pages must divide S={s}")
        if pages is None:
            blk_c = s // n_sc         # the scale page IS the kernel chunk
        check(blk_c == s // n_sc,
              f"{name}: page size {blk_c} != S / n_scales = {s // n_sc}")
    if pages is None:
        blk_c = dense_chunk(s, blk_c)
        n_log = 0
        pages_ptr = None
    else:
        check(pages.is_cuda and pages.dtype == torch.int32
               and pages.dim() == 2 and pages.shape[0] == b
               and pages.is_contiguous(),
               f"{name}: pages must be (B, n_log) int32 CUDA")
        check(blk_c > 0 and s % blk_c == 0,
               f"{name}: page size {blk_c} must divide S={s}")
        n_log = pages.shape[1]
        pages_ptr = pages.data_ptr()
    acc_e = m_e = l_e = None
    if extra is not None:
        acc_e, m_e, l_e = extra
        for t, shape in ((acc_e, (b, h, hd)), (m_e, (b, h)), (l_e, (b, h))):
            check(t.is_cuda and t.dtype == torch.float32
                   and tuple(t.shape) == shape and t.is_contiguous(),
                   f"{name}: extra must be contiguous f32 CUDA "
                   "(B,H,hd), (B,H), (B,H)")
    split, n_split = decode_split(n_log * blk_c if n_log else s, blk_c, hd)
    ws = _workspace(b, kh, n_split, h // kh, hd, q.device)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    tc = decode_route(q.dtype, hd, h // kh,
                      (qp | kp | vp) % 16 == 0) == "tensor_core"
    if raw:
        f32 = dict(dtype=torch.float32, device=q.device)
        res = (torch.empty((b, h, hd), **f32), torch.empty((b, h), **f32),
               torch.empty((b, h), **f32))
        outs = tuple(t.data_ptr() for t in res)
    else:
        res = torch.empty_like(q)
        outs = (res.data_ptr(),)
    err = _fn("rt_decode_fused_partial" if raw else "rt_decode_fused")(
        DTYPE_CODE[q.dtype], int(tc), qp, kp, vp, pos.data_ptr(), pages_ptr,
        n_log, None if acc_e is None else acc_e.data_ptr(),
        None if m_e is None else m_e.data_ptr(),
        None if l_e is None else l_e.data_ptr(),
        None if kv_scales is None else kv_scales[0].data_ptr(),
        None if kv_scales is None else kv_scales[1].data_ptr(), n_sc,
        *outs, ws.data_ptr(), b, h, kh, s, hd, blk_c, split,
        n_split, int(window), float(hd ** -0.5), stream())
    raise_on(err, name)
    LAUNCHES[name] += 1
    if tc:
        LAUNCHES[name + "_tc"] += 1
    if kv_scales is None:
        count_site(name)
    return res


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Raw partial-softmax statistics on the card: q (B,1,H,hd); k/v
    (B,KH,C,hd); valid (B,C) bool.  Returns f32 (acc (B,H,hd), m (B,H),
    l (B,H)) with m = -inf where a row has no valid slot."""
    name = "decode_attention_partial"
    check_inputs(name, q, k, v)
    b, one, h, hd = q.shape
    check(one == 1 and k.dim() == 4 and k.shape == v.shape,
           f"{name}: q (B,1,H,hd), k/v (B,KH,C,hd) expected")
    kh, c = k.shape[1], k.shape[2]
    check(k.shape[0] == b and k.shape[3] == hd and h % kh == 0,
           f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    check(valid.is_cuda and valid.dtype == torch.bool
           and tuple(valid.shape) == (b, c) and valid.is_contiguous(),
           f"{name}: valid must be (B, C) bool CUDA")
    acc = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    split, n_split = decode_split(c, PARTIAL_CHUNK, hd)
    ws = _workspace(b, kh, n_split, h // kh, hd, q.device)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    tc = decode_route(q.dtype, hd, h // kh,
                      (qp | kp | vp) % 16 == 0) == "tensor_core"
    err = _fn("rt_decode_partial")(
        DTYPE_CODE[q.dtype], int(tc), qp, kp, vp, valid.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), ws.data_ptr(),
        b, h, kh, c, hd, split, n_split, float(hd ** -0.5), stream())
    raise_on(err, name)
    LAUNCHES[name] += 1
    if tc:
        LAUNCHES[name + "_tc"] += 1
    count_site(name)
    return acc, m, l


def flash_route(dtype: torch.dtype, hd: int, aligned: bool = True) -> str:
    """The prefill kernel that takes these inputs: "tensor_core" for bf16
    with hd in TC_HEAD_DIMS and 16-byte-aligned q, k, v (`aligned`), else
    "cuda_core"."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and aligned:
        return "tensor_core"
    return "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill flash attention on the card: q (B,S,H,hd), k/v (B,S,KH,hd)
    -> (B,S,H,hd), causal and/or sliding window, GQA.  Any S: the kernels
    mask the ragged edge of their tiles themselves.  The kernel is the one
    `flash_route` names."""
    name = "flash_attention"
    check_inputs(name, q, k, v)
    # every prefill layer calls this: the messages are formatted only on
    # failure
    if not (q.dim() == 4 and k.dim() == 4 and k.shape == v.shape):
        raise ValueError(f"{name}: q (B,S,H,hd), k/v (B,S,KH,hd) expected")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if not (k.shape[0] == b and k.shape[1] == s and k.shape[3] == hd
            and h % kh == 0):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    out = torch.empty_like(q)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    args = (qp, kp, vp, out.data_ptr(), b, s, h, kh, hd, int(causal),
            int(window), float(hd ** -0.5), stream())
    tc = flash_route(q.dtype, hd, (qp | kp | vp) % 16 == 0) == "tensor_core"
    if tc:
        err = _fn("rt_flash_attention_tc")(*args)
    else:
        err = _fn("rt_flash_attention")(DTYPE_CODE[q.dtype], *args)
    raise_on(err, name)
    LAUNCHES[name] += 1
    if tc:
        LAUNCHES["flash_attention_tc"] += 1
    return out
