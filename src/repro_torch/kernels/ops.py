"""Dispatch for the port's kernels, with the signatures of
`repro/kernels/ops.py`.

A CUDA tensor goes to the hand-written CUDA kernel (`flash_attention.py`,
`ssd.py`, `quant.py`, `knn.py`, `sls.py`); a CPU tensor goes to the plain
PyTorch version (`ref.py`).  The Pallas kernels' tile arguments (`blk_*`,
`interpret`) have no counterpart: the CUDA kernels take any shape.
Inside `reference_mode()` CUDA tensors take the plain versions too: that
is how `chip_smoke.py` and the tests hold the kernel path against the
plain path on the card.  The server never enters it.

Every entry that wraps a kernel charges the active cost counter
(`roofline/cost.py`) with the kernel's formula, from shapes alone, on
every route, and the counter ignores the ops beneath it.  On meta tensors
(the dry-run) the entry returns empty outputs of the kernel's shapes and
dtypes and never loads the library.

Per-slot sampling (`BatchedSampling`, `sample_tokens`) and speculative
verification (`verify_tokens`) have no kernel: they are plain XLA in the
reference and plain torch here, on every device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import knn as _knn
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sls as _sls
from repro_torch.kernels import ssd as _ssd
from repro_torch.roofline import cost as _cost

_state = threading.local()


@contextlib.contextmanager
def reference_mode() -> Iterator[None]:
    """Route CUDA tensors to the plain PyTorch versions while active."""
    prev = getattr(_state, "reference", False)
    _state.reference = True
    try:
        yield
    finally:
        _state.reference = prev


def _use_kernel(t: torch.Tensor) -> bool:
    return t.is_cuda and not getattr(_state, "reference", False)


@contextlib.contextmanager
def _charged(name: str, *args, **kwargs) -> Iterator[Optional[object]]:
    """One kernel entry's call: charge the active cost counter with the
    kernel's formula and keep the ops beneath it out of the count; yields
    the meta route's outputs (empty tensors of the kernel's shapes and
    dtypes; a tuple when it has several) when the first argument is a
    meta tensor, else None."""
    counter = _cost.active()
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if counter is not None:
        counter.kernel(name, _cost.kernel_cost(name, *args, **kwargs),
                       tensors)
    with counter.quiet() if counter is not None else contextlib.nullcontext():
        meta = None
        if tensors[0].is_meta:
            outs = [torch.empty(shape, dtype=dtype, device=tensors[0].device)
                    for shape, dtype in _cost.kernel_outputs(name, *args,
                                                             **kwargs)]
            meta = outs[0] if len(outs) == 1 else tuple(outs)
        yield meta


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,S,KH,hd) -> (B,S,H,hd)."""
    with _charged("flash_attention", q, k, v, causal=causal,
                  window=window) as meta:
        if meta is not None:
            return meta
        if _use_kernel(q):
            return _fa.flash_attention(q, k, v, causal=causal,
                                       window=window)
        return _ref.mha_reference(q, k, v, causal=causal, window=window)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """q: (B,1,H,hd); k,v: (B,KH,C,hd); valid (B,C) bool -> f32 (acc, m, l)."""
    with _charged("decode_attention_partial", q, k, v, valid) as meta:
        if meta is not None:
            return meta
        if _use_kernel(q):
            return _fa.decode_attention_partial(q, k, v, valid)
        return _ref.decode_partial_reference(q, k, v, valid)


def decode_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor,
                           extra: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]] = None,
                           pages: Optional[torch.Tensor] = None,
                           kv_scales: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None,
                           *, window: int = 0, blk_c: int = 128
                           ) -> torch.Tensor:
    """Fused one-shot flash decode.  q: (B,1,H,hd); k,v: (B,KH,S,hd); pos:
    (B,) per-row last valid slot; extra: optional (acc, m, l) partial of the
    current token.  `pages`: optional (B, n_log) int32 page table — k/v are
    then physical page pools, `blk_c` is the exact page size, and `pos`
    keeps its logical meaning.  `kv_scales`: optional (k_scales,
    v_scales), each (B,KH,S/page) f32 — k/v are then int8 pools
    dequantized per page; the scale page replaces `blk_c` when dense and
    must equal it when paged.  Returns (B,1,H,hd)."""
    with _charged("decode_attention_fused", q, k, v, pos, extra, pages,
                  kv_scales, window=window, blk_c=blk_c) as meta:
        if meta is not None:
            return meta
        if _use_kernel(q):
            return _fa.decode_attention_fused(
                q, k, v, pos, extra, window=window, blk_c=blk_c,
                pages=pages, kv_scales=kv_scales)
        page_size = blk_c if pages is not None else 0
        if page_size and kv_scales is not None \
                and page_size != k.shape[2] // kv_scales[0].shape[-1]:
            raise ValueError(f"page size {page_size} != S / n_scales "
                             f"({k.shape[2]} / {kv_scales[0].shape[-1]})")
        return _ref.decode_fused_reference(
            q, k, v, pos, extra, window=window, pages=pages,
            page_size=page_size, kv_scales=kv_scales)


def decode_attention_fused_partial(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
        extra: Optional[Tuple[torch.Tensor, torch.Tensor,
                              torch.Tensor]] = None,
        pages: Optional[torch.Tensor] = None,
        kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        *, window: int = 0, blk_c: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`decode_attention_fused` without the normalisation: the same
    arguments, and the merged f32 (acc (B,H,hd), m (B,H), l (B,H)),
    `extra` included.  `ref.normalize_fused_partial(acc, l, q.dtype)`
    gives `decode_attention_fused`'s output, and for a head group's
    statistics gathered with the other groups' the whole output: the mesh
    decode's producer (`core/backstream.py`)."""
    with _charged("decode_attention_fused_partial", q, k, v, pos, extra,
                  pages, kv_scales, window=window, blk_c=blk_c) as meta:
        if meta is not None:
            return meta
        if _use_kernel(q):
            return _fa.decode_attention_fused_partial(
                q, k, v, pos, extra, window=window, blk_c=blk_c,
                pages=pages, kv_scales=kv_scales)
        page_size = blk_c if pages is not None else 0
        if page_size and kv_scales is not None \
                and page_size != k.shape[2] // kv_scales[0].shape[-1]:
            raise ValueError(f"page size {page_size} != S / n_scales "
                             f"({k.shape[2]} / {kv_scales[0].shape[-1]})")
        return _ref.decode_fused_partial_reference(
            q, k, v, pos, extra, window=window, pages=pages,
            page_size=page_size, kv_scales=kv_scales)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan.  x: (b,s,h,p); dt: (b,s,h) f32; A: (h,) f32;
    B, C: (b,s,n); init_state: optional (b,h,p,n) f32.  Returns
    (y (b,s,h,p) in x's dtype, final_state (b,h,p,n) f32)."""
    with _charged("ssd_scan", x, dt, A, B, C, init_state) as meta:
        if meta is not None:
            return meta
        if _use_kernel(x):
            return _ssd.ssd_scan(x, dt, A, B, C, init_state)
        return _ref.ssd_reference(x, dt, A, B, C, init_state)


def quant_matmul(x: torch.Tensor, qt: "_quant.QTensor") -> torch.Tensor:
    """x (..., d_in) @ dequantize(qt) -> (..., n) in x's dtype, `qt`
    unstacked.  On the card the dequantization is fused into the matmul
    kernel; the plain version multiplies against the dequantized weight
    in f32."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    with _charged("quant_matmul", x2, qt) as meta:
        if meta is not None:
            out = meta
        elif _use_kernel(x2):
            out = _quant.quant_matmul(x2.contiguous(), qt)
        else:
            out = _ref.quant_matmul_reference(x2, qt)
    return out.reshape(shape[:-1] + (out.shape[-1],))


def knn_distances(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances.  queries (Q,D), db (N,D) -> (Q,N) f32."""
    with _charged("knn_distances", queries, db) as meta:
        if meta is not None:
            return meta
        if _use_kernel(queries):
            return _knn.knn_distances(queries, db)
        return _ref.knn_distances_reference(queries, db)


def knn_topk(queries: torch.Tensor, db: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest db rows of each query: the distances of
    `knn_distances`, then the k smallest of each row on the same device,
    ties lowest id first as `jax.lax.top_k` breaks them (`knn.knn_topk`
    on the card, `ref.knn_topk_reference` on the CPU).  Returns (dists
    (Q,k) f32, ids (Q,k) int64)."""
    with _charged("knn_topk", queries, db, k) as meta:
        if meta is not None:
            return meta
        if _use_kernel(queries):
            return _knn.knn_topk(queries, db, k)
        return _ref.knn_topk_reference(queries, db, k)


def sls(table: torch.Tensor, indices: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled embedding bags.  table (V,D); indices (B,L) int32, -1 pads;
    weights (B,L) f32 or None -> (B,D) f32."""
    with _charged("sls", table, indices, weights) as meta:
        if meta is not None:
            return meta
        if _use_kernel(table):
            return _sls.sls(table, indices, weights)
        return _ref.sls_reference(table, indices, weights)


@dataclasses.dataclass(frozen=True)
class BatchedSampling:
    """Per-slot sampling parameters over the decode batch, each (B,): the
    device-side image of one `SamplingParams` per serving slot.
    temperature <= 0 (or top_k == 1) marks a slot greedy; top_k == 0,
    top_p == 1 and min_p == 0 turn the respective filter off."""
    temperature: torch.Tensor     # (B,) f32
    top_k: torch.Tensor           # (B,) i32
    top_p: torch.Tensor           # (B,) f32
    min_p: torch.Tensor           # (B,) f32


def greedy_sampling(batch: int, device: torch.device) -> BatchedSampling:
    """All slots greedy."""
    f32 = dict(dtype=torch.float32, device=device)
    return BatchedSampling(
        temperature=torch.zeros((batch,), **f32),
        top_k=torch.zeros((batch,), dtype=torch.int32, device=device),
        top_p=torch.ones((batch,), **f32),
        min_p=torch.zeros((batch,), **f32))


def sample_tokens(logits: torch.Tensor, params: BatchedSampling,
                  keys: torch.Tensor, *, vocab: int = 0) -> torch.Tensor:
    """Per-slot token selection.  logits (B, V); keys (B, 2) int64, one
    PRNG key per slot; `vocab`: the true vocabulary width when V is padded
    (a sampled row never emits an id >= vocab; 0: no bound).  Returns (B,)
    int32: argmax for greedy rows, bitwise; a Gumbel-argmax draw over the
    filtered distribution for the others (`ref.sample_tokens_reference`).

    The reference serves through `ref.sample_tokens_capped`, which picks
    its partial-sort path or the full one with `lax.cond`.  On the card
    that choice could not be made without reading `all(closed)` back to
    the host, which a CUDA graph of the decode segment cannot do; taking
    both and selecting on the device costs more than the full path alone.
    So this runs the full reference, which `sample_tokens_capped` equals
    bit for bit."""
    return _ref.sample_tokens_reference(
        logits, params.temperature, params.top_k, params.top_p,
        params.min_p, keys, vocab)


def verify_tokens(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                  draft_tokens: torch.Tensor, params: BatchedSampling,
                  keys: torch.Tensor, *, vocab: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot speculative verification.  target_logits (B, K+1, V);
    draft_logits (B, K, V), the logits the draft tokens (B, K) were drawn
    from; keys (B, 2) int64, one per slot; `vocab` the true vocabulary
    width when V is padded.  Returns (out_tokens (B, K+1) int32,
    accept_len (B,) int32): a round emits out_tokens[:accept_len + 1].
    Greedy rows accept while the draft matches the target argmax and
    emit the target argmax stream; sampled rows run rejection sampling
    against `ref.filtered_log_probs` (`ref.verify_tokens_reference`).
    Plain XLA in the reference, plain torch here, on every device."""
    return _ref.verify_tokens_reference(
        target_logits, draft_logits, draft_tokens, params.temperature,
        params.top_k, params.top_p, params.min_p, keys, vocab)
