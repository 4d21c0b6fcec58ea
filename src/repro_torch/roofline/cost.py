"""The port's count of operations and bytes: the counterpart of
`repro/roofline/hlo_cost.py`, over the aten ops one eager step runs.

`CostCounter` is a `TorchDispatchMode`.  Eager PyTorch runs every loop
iteration, so it sees each layer, chunk and tile as it runs: the
trip-count machinery of the HLO model has no counterpart.

  FLOPs   - 2·M·N·K for each product (`mm`, `bmm`, `addmm`, `baddbmm`,
            `mv`, `dot`: what `matmul`, `einsum` and `linear` decompose
            to).  Elementwise ops count zero, as in the reference.
  bytes   - the reference's ideal-fusion model.  Views, pointwise ops,
            converts and factories fuse into their consumers: their
            results are never written, and an op that reads one reads its
            "fusion frontier", the materialized tensors it was computed
            from.  Products, reductions, copies, `cat`, indexing, sorts,
            RNG and in-place writes materialize: each writes its result
            and reads its inputs' frontiers.  An indexed read (`index`,
            `gather`, `embedding`) counts 2x its result, an in-place write
            into a slice (`index_put_`, `copy_` into a view) the slice
            written plus what it reads, not the whole tensor (the
            dynamic-update-slice rule).  Eager code has no loop carry to
            materialize the residual stream, so a fused result whose
            frontier has grown past twice its own bytes is written once
            and read from then on.
  kernels - each `kernels/ops.py` entry that wraps a hand-written kernel
            charges `kernel_cost`'s formula, from shapes alone, and the
            counter ignores the ops beneath it (the plain version's or
            the CUDA wrapper's).  Its fused inputs are written first: the
            kernel reads them from memory.
  collectives - per-rank bytes sent, read from `core/backstream.py`'s
            `WIRE` counters (a gather sends its payload to each of the
            n - 1 peers, a ring hop or a broadcast its buffer once per
            peer), by op.
  memory  - the bytes of every storage the step allocates, tracked until
            it is freed: `temp_bytes` is the peak of those, `peak_bytes`
            the arguments' bytes plus it, as the reference's
            `memory_analysis` reports them.

The same counter runs on meta tensors (the dry-run) and on the card's
real ones; the model code takes no branch on the device and the kernel
formulas read no tensor values, so both count the same ops.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

aten = torch.ops.aten

# products: (op -> FLOPs from its tensor args)
_PRODUCTS: Dict[Any, Callable[..., float]] = {
    aten.mm.default: lambda a, b: 2.0 * a.shape[0] * a.shape[1] * b.shape[1],
    aten.bmm.default: lambda a, b: (2.0 * a.shape[0] * a.shape[1]
                                    * a.shape[2] * b.shape[2]),
    aten.addmm.default: lambda c, a, b: (2.0 * a.shape[0] * a.shape[1]
                                         * b.shape[1]),
    aten.baddbmm.default: lambda c, a, b: (2.0 * a.shape[0] * a.shape[1]
                                           * a.shape[2] * b.shape[2]),
    aten.mv.default: lambda a, b: 2.0 * a.shape[0] * a.shape[1],
    aten.dot.default: lambda a, b: 2.0 * a.shape[0],
}
# factories: a fused source with nothing to read
_FACTORIES = {aten.empty.memory_format, aten.empty_strided.default,
              aten.zeros.default, aten.ones.default, aten.full.default,
              aten.arange.default, aten.arange.start,
              aten.arange.start_step, aten.scalar_tensor.default,
              aten.empty_like.default, aten.zeros_like.default,
              aten.ones_like.default, aten.full_like.default,
              aten.new_empty.default, aten.new_zeros.default,
              aten.new_ones.default, aten.new_full.default,
              aten.new_empty_strided.default}
# no memory traffic and no result of their own
_FREE = {aten.lift_fresh.default, aten.detach.default,
         aten._local_scalar_dense.default, aten.alias.default}
# fills of a fresh tensor keep it a fused source
_FILLS = {aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}
# indexed reads: 2x the result (read the touched rows, write them)
_INDEXED_READS = {aten.index.Tensor, aten.gather.default,
                  aten.index_select.default, aten.embedding.default}
# indexed writes: the slice written, 2x
_INDEXED_WRITES = {aten.index_put_.default, aten.index_put.default,
                   aten._index_put_impl_.default}
# fusible without the pointwise tag
_FUSIBLE = {aten._to_copy.default, aten.where.self,
            aten.where.ScalarSelf, aten.where.ScalarOther,
            aten.lift_fresh_copy.default}
# views without the view tag (the result shares its input's storage)
_VIEWLIKE = {aten._unsafe_view.default}

# a fused result is written once its frontier exceeds this many times its
# own bytes
FRONTIER_LIMIT = 2.0

Region = Tuple[int, int, tuple]


def nbytes(t: torch.Tensor) -> int:
    """A tensor's distinct bytes: its elements, a broadcast (stride 0)
    dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class KernelCost:
    """One kernel call's work from its shapes: product FLOPs over the
    (query, key) pairs its masks keep, every input byte read once and
    every output byte written once."""
    flops: float
    bytes: float


_active = threading.local()


def active() -> Optional["CostCounter"]:
    """The counter of the innermost `CostCounter` context, if any."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collective bytes and live memory of what runs
    inside it (module docstring).  `arguments(tree)` declares the step's
    inputs (their bytes are `argument_bytes`, and they are read as
    materialized tensors); `outputs(tree)` closes the step, writing any
    output still fused."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes = 0.0
        self.n_ops = 0
        self.by_op: Dict[str, List[float]] = {}
        self.kernels: Dict[str, List[float]] = {}
        self.argument_bytes = 0
        self.output_bytes = 0
        self.temp_bytes = 0
        self._live = 0
        self._storages: Dict[int, int] = {}
        self._sids: Dict[int, int] = {}
        self._next_sid = 0
        self._args: set = set()
        self._front: WeakIdKeyDictionary = WeakIdKeyDictionary()
        self._fresh: WeakIdKeyDictionary = WeakIdKeyDictionary()
        # tensors updated in place whose write is still to be charged
        self._pending: WeakIdKeyDictionary = WeakIdKeyDictionary()
        self._quiet = 0
        self._wire0: Dict[str, int] = {}
        self.coll_bytes = 0.0
        self.coll_by_op: Dict[str, float] = {}

    # -- the context -------------------------------------------------------
    def __enter__(self):
        from repro_torch.core.backstream import WIRE
        self._wire0 = dict(WIRE.bytes_by_op)
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.core.backstream import WIRE
        _active.stack.remove(self)
        for op, n in WIRE.bytes_by_op.items():
            d = n - self._wire0.get(op, 0)
            if d:
                self.coll_by_op[op] = self.coll_by_op.get(op, 0.0) + d
        self.coll_bytes = float(sum(self.coll_by_op.values()))
        return super().__exit__(*exc)

    # -- the step's boundary -----------------------------------------------
    def arguments(self, tree: Any) -> None:
        """Declare the step's inputs: bytes counted once per storage."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._args:
                self._args.add(key)
                self.argument_bytes += st.nbytes()

    def outputs(self, tree: Any) -> None:
        """Close the step: an output still fused is written now; the
        outputs' storages allocated in the step are `output_bytes`."""
        for t in list(self._pending.keys()):
            self._materialize(t, "update")
        seen = set()
        for t in _tensors(tree):
            if t in self._front and self._front[t] != frozenset(
                    [self._region(t)]):
                self._materialize(t, "output")
            key = t.untyped_storage()._cdata
            if key in self._storages and key not in seen:
                seen.add(key)
                self.output_bytes += self._storages[key]

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes

    def memory(self) -> Dict[str, int]:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_bytes": self.peak_bytes}

    # -- kernels -----------------------------------------------------------
    def kernel(self, name: str, cost: KernelCost,
               inputs: List[torch.Tensor]) -> None:
        """Charge one kernel call; its fused inputs are written first.
        Its FLOPs go under its first floating-point input's dtype."""
        for t in inputs:
            if t in self._front \
                    and self._front[t] != frozenset([self._region(t)]):
                self._materialize(t, "kernel input")
        dtype = next((t.dtype for t in inputs if t.is_floating_point()),
                     torch.float32)
        self._charge(name, cost.flops, cost.bytes, dtype)
        entry = self.kernels.setdefault(name, [0.0, 0.0, 0])
        entry[0] += cost.flops
        entry[1] += cost.bytes
        entry[2] += 1

    @contextlib.contextmanager
    def quiet(self) -> Iterator[None]:
        """Ops inside run, and their storages are tracked, but they are
        not counted: the ops beneath a kernel entry."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- bookkeeping -------------------------------------------------------
    def _charge(self, name: str, flops: float, nbytes_: float,
                dtype: Optional[torch.dtype] = None) -> None:
        if flops:
            key = str(dtype).replace("torch.", "")
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) \
                + flops
        self.flops += flops
        self.bytes += nbytes_
        self.n_ops += 1
        entry = self.by_op.setdefault(name, [0.0, 0.0, 0])
        entry[0] += flops
        entry[1] += nbytes_
        entry[2] += 1

    def _region(self, t: torch.Tensor) -> Tuple[Region, int]:
        """The storage region t reads (its storage, offset, and the sizes
        and strides of its dims longer than 1), and its distinct bytes.
        A storage is named by a serial number of its own, not by its
        address: a freed storage's address comes back for a later one, as
        the allocator pleases, and must not alias it."""
        st = t.untyped_storage()
        key = st._cdata
        sid = self._sids.get(key)
        if sid is None:
            sid = self._sids[key] = self._next_sid
            self._next_sid += 1
            weakref.finalize(st, self._sids.pop, key, None)
        # unit dims dropped: their strides are arbitrary (a meta kernel
        # and a CUDA one may give one tensor different ones)
        dims = tuple((n, st) for n, st in zip(t.shape, t.stride()) if n != 1)
        return (sid, t.storage_offset(), dims), nbytes(t)

    def _frontier(self, t: torch.Tensor, fused: bool = False) -> frozenset:
        """What reading t reads.  A materializing reader (`fused` False)
        of a tensor with a pending in-place update writes the update
        first; an elementwise one fuses with it."""
        if not fused and t in self._pending:
            self._materialize(t, "update")
        f = self._front.get(t)
        if f is None:                 # an argument or a kernel's output
            f = frozenset([self._region(t)])
        return f

    def _reads(self, tensors: Iterable[torch.Tensor],
               fused: bool = False) -> frozenset:
        out: frozenset = frozenset()
        for t in tensors:
            out = out | self._frontier(t, fused)
        return out

    def _materialize(self, t: torch.Tensor, name: str) -> None:
        self._pending.pop(t, None)
        reads = self._reads([t], fused=True)
        self._charge(name, 0.0, nbytes(t) + sum(n for _, n in reads))
        self._front[t] = frozenset([self._region(t)])
        self._fresh.pop(t, None)

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in self._args:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self._live += n
            self.temp_bytes = max(self.temp_bytes, self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._storages.pop(key, 0)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(outs)
        if self._quiet or func.namespace != "aten":
            return out
        ins = _tensors((args, kwargs))
        name = func.overloadpacket.__name__
        if func in _FACTORIES:
            for t in outs:
                self._front[t] = frozenset()
                self._fresh[t] = True
            return out
        if func in _FREE:
            for t in outs:
                if ins and ins[0] in self._front:
                    self._front[t] = self._front[ins[0]]
            return out
        mutated = self._mutated(func, args, kwargs)
        if mutated is not None:
            self._inplace(func, name, mutated, args, kwargs, ins)
            return out
        if func.is_view or func in _VIEWLIKE:
            base = ins[0] if ins else None
            if base is None or base not in self._front:
                return out                # a view of a materialized tensor
            if base in self._fresh:
                for t in outs:
                    self._front[t] = frozenset()
                    self._fresh[t] = True
                return out
            if self._front[base] == frozenset([self._region(base)]):
                return out
            if any(nbytes(t) < nbytes(base) for t in outs):
                # a slice of a fused result: it is written once, and each
                # slice reads its own part
                self._materialize(base, name)
                return out
            for t in outs:
                self._front[t] = self._front[base]
            return out
        if func in _FUSIBLE or torch.Tag.pointwise in func.tags:
            reads = self._reads(ins, fused=True)
            for t in outs:
                self._front[t] = reads
                own = nbytes(t)
                if own and sum(n for _, n in reads) > FRONTIER_LIMIT * own:
                    self._materialize(t, name)
            return out
        flops = 0.0
        if func in _PRODUCTS:
            flops = _PRODUCTS[func](*[a for a in args
                                      if isinstance(a, torch.Tensor)])
        if func in _INDEXED_READS:
            moved = 2.0 * sum(nbytes(t) for t in outs)
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            moved += sum(n for _, n in self._reads(idx))
        else:
            moved = (sum(nbytes(t) for t in outs)
                     + sum(n for _, n in self._reads(ins)))
        self._charge(name, flops, moved, ins[0].dtype if flops else None)
        for t in outs:
            self._front[t] = frozenset([self._region(t)])
        return out

    @staticmethod
    def _mutated(func, args, kwargs) -> Optional[torch.Tensor]:
        """The tensor an in-place op writes, or None."""
        for i, arg in enumerate(func._schema.arguments):
            info = arg.alias_info
            if info is not None and info.is_write:
                val = args[i] if i < len(args) else kwargs.get(arg.name)
                if isinstance(val, torch.Tensor):
                    return val
        return None

    def _inplace(self, func, name, dst, args, kwargs, ins) -> None:
        others = [t for t in ins if t is not dst]
        if func in _FILLS and dst in self._fresh:
            return                      # still a fused source
        if torch.Tag.pointwise in func.tags and func not in _FILLS \
                and func is not aten.copy_.default:
            # an in-place elementwise update fuses with the next ones on
            # the same tensor: its write is pending until something reads
            # the tensor through a materializing op or the step ends
            reads = self._reads(others, fused=True) \
                | self._frontier(dst, fused=True)
            self._front[dst] = reads
            self._pending[dst] = True
            self._fresh.pop(dst, None)
            if sum(n for _, n in reads) > FRONTIER_LIMIT * nbytes(dst):
                self._materialize(dst, name)
            return
        if func in _INDEXED_WRITES:
            written = _index_written(args[0], args[1]) * dst.element_size()
            reads = self._reads(others)
            self._charge(name, 0.0, written + sum(n for _, n in reads))
        else:
            reads = self._reads(others)
            if func not in (aten.copy_.default,) and func not in _FILLS:
                reads = reads | self._frontier(dst)
            flops = 0.0
            if func in _PRODUCTS:
                flops = _PRODUCTS[func](*[a for a in args
                                          if isinstance(a, torch.Tensor)])
            self._charge(name, flops, nbytes(dst)
                         + sum(n for _, n in reads),
                         dst.dtype if flops else None)
        self._fresh.pop(dst, None)
        if dst in self._front:
            self._front[dst] = frozenset([self._region(dst)])


def _index_written(dst: torch.Tensor, indices) -> int:
    """Elements an `index_put_` writes: the indices' broadcast shape times
    the dims they leave whole."""
    idx_shapes = [tuple(i.shape) for i in indices if i is not None]
    n = math.prod(torch.broadcast_shapes(*idx_shapes)) if idx_shapes else 1
    for d, size in enumerate(dst.shape):
        if d >= len(indices) or indices[d] is None:
            n *= size
    return n


# --------------------------------------------------------------------------
# The kernels' formulas, from shapes alone
# --------------------------------------------------------------------------

def _bytes_of(*tensors) -> float:
    total = 0.0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, (tuple, list)):
            total += _bytes_of(*t)
        elif hasattr(t, "quants"):          # a QTensor
            total += _bytes_of(t.scales, t.quants, t.mins)
        else:
            total += nbytes(t)
    return total


def _out_bytes(shapes) -> float:
    return float(sum(math.prod(s) * torch.empty((), dtype=d).element_size()
                     for s, d in shapes))


def attention_pairs(sq: int, sk: int, causal: bool, window: int = 0,
                    q_offset: int = 0) -> int:
    """(query, key) pairs a causal / windowed mask keeps: the query at
    position p = q_offset + i sees keys j <= p of the sk, and with a
    window W > 0 only those with j > p - W."""
    if not causal:
        return sq * sk
    total = 0
    for p in range(q_offset, q_offset + sq):
        lo = max(0, p - window + 1) if window > 0 else 0
        total += max(0, min(p, sk - 1) - lo + 1)
    return total


def flash_attention_cost(q, k, v, *, causal=True, window=0) -> KernelCost:
    b, sq, h, hd = q.shape
    pairs = attention_pairs(sq, k.shape[1], causal, window)
    return KernelCost(4.0 * b * h * hd * pairs,
                      _bytes_of(q, k, v) + nbytes(q))


def flash_attention_out(q, k, v, **kw):
    return [(tuple(q.shape), q.dtype)]


def decode_partial_out(q, k, v, valid):
    b, _, h, hd = q.shape
    f32 = torch.float32
    return [((b, h, hd), f32), ((b, h), f32), ((b, h), f32)]


def _kv_read(q, k, n_keys: int) -> Tuple[float, float]:
    """(FLOPs, K/V bytes) of attending q's heads over n_keys (row, key)
    pairs: q.k and p.v, 2 hd FLOPs each a head; each key's K and V row
    read once."""
    h, hd = q.shape[2], q.shape[3]
    kh = k.shape[1]
    return (4.0 * n_keys * h * hd, 2.0 * n_keys * kh * hd * k.element_size())


def decode_partial_cost(q, k, v, valid, *, n_valid: Optional[int] = None
                        ) -> KernelCost:
    """The chunk's keys of every row (`n_valid` of them when the caller
    counts the mask's valid ones: the data's work)."""
    n = q.shape[0] * k.shape[2] if n_valid is None else n_valid
    flops, kv = _kv_read(q, k, n)
    return KernelCost(flops, kv + _bytes_of(q, valid)
                      + _out_bytes(decode_partial_out(q, k, v, valid)))


def _decode_span(k, pages, blk_c) -> int:
    if pages is not None:
        return pages.shape[1] * blk_c
    return k.shape[2]


def decode_fused_out(q, k, v, pos, extra=None, pages=None, kv_scales=None,
                     **kw):
    return [(tuple(q.shape), q.dtype)]


def _fused_cost(q, k, pos, extra, pages, kv_scales, blk_c, n_valid,
                n_pages, outs) -> KernelCost:
    """From shapes a decode counts its cache's whole span (its rows'
    positions are data); `n_valid` (row, key) pairs and `n_pages` (row,
    page) pairs of int8 scales when the caller counts them."""
    span = _decode_span(k, pages, blk_c)
    n = q.shape[0] * span if n_valid is None else n_valid
    flops, kv = _kv_read(q, k, n)
    scales = 0.0
    if kv_scales is not None:
        scales = (_bytes_of(kv_scales) if n_pages is None
                  else 2.0 * n_pages * k.shape[1] * 4)
    return KernelCost(flops, kv + scales + _bytes_of(q, pos, extra, pages)
                      + _out_bytes(outs))


def decode_fused_cost(q, k, v, pos, extra=None, pages=None, kv_scales=None,
                      *, window=0, blk_c=128, n_valid: Optional[int] = None,
                      n_pages: Optional[int] = None) -> KernelCost:
    return _fused_cost(q, k, pos, extra, pages, kv_scales, blk_c, n_valid,
                       n_pages, decode_fused_out(q, k, v, pos))


def decode_fused_partial_out(q, k, v, pos, extra=None, pages=None,
                             kv_scales=None, **kw):
    b, _, h, hd = q.shape
    f32 = torch.float32
    return [((b, h, hd), f32), ((b, h), f32), ((b, h), f32)]


def decode_fused_partial_cost(q, k, v, pos, extra=None, pages=None,
                              kv_scales=None, *, window=0, blk_c=128,
                              n_valid: Optional[int] = None,
                              n_pages: Optional[int] = None) -> KernelCost:
    return _fused_cost(q, k, pos, extra, pages, kv_scales, blk_c, n_valid,
                       n_pages, decode_fused_partial_out(q, k, v, pos))


def ssd_out(x, dt, A, B, C, init_state=None):
    b, s, h, p = x.shape
    return [(tuple(x.shape), x.dtype), ((b, h, p, B.shape[-1]),
                                        torch.float32)]


def ssd_cost(x, dt, A, B, C, init_state=None) -> KernelCost:
    """The scan's products: each step's output y_t = state_t C_t, 2 P N
    FLOPs a (row, head); the state update's outer product (dt x) B^T is
    elementwise, as the recurrence computes it.  The chunked form the
    tensor-core kernels run adds the intra-chunk scores, which are work
    of the schedule, not of the function."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    return KernelCost(2.0 * b * s * h * p * n,
                      _bytes_of(x, dt, A, B, C, init_state)
                      + _out_bytes(ssd_out(x, dt, A, B, C)))


def quant_matmul_out(x2, qt):
    return [((x2.shape[0], qt.scales.shape[-1]), x2.dtype)]


def quant_matmul_cost(x2, qt) -> KernelCost:
    m, n = x2.shape[0], qt.scales.shape[-1]
    return KernelCost(2.0 * m * n * qt.d_in,
                      _bytes_of(x2, qt) + m * n * x2.element_size())


def knn_out(queries, db):
    return [((queries.shape[0], db.shape[0]), torch.float32)]


def knn_cost(queries, db) -> KernelCost:
    qn, d = queries.shape
    n = db.shape[0]
    return KernelCost(2.0 * qn * n * d,
                      _bytes_of(queries, db) + qn * n * 4.0)


def knn_topk_out(queries, db, k):
    return [((queries.shape[0], k), torch.float32),
            ((queries.shape[0], k), torch.int64)]


def knn_topk_cost(queries, db, k) -> KernelCost:
    """The distance kernel's work, then the top-k: the (Q, N) distances
    read once more and the (Q, k) distances and ids written."""
    d = knn_cost(queries, db)
    qn, n = queries.shape[0], db.shape[0]
    return KernelCost(d.flops, d.bytes + qn * n * 4.0
                      + _out_bytes(knn_topk_out(queries, db, k)))


def sls_out(table, indices, weights=None):
    return [((indices.shape[0], table.shape[1]), torch.float32)]


def sls_cost(table, indices, weights=None, *, rows: Optional[int] = None,
             n_valid: Optional[int] = None) -> KernelCost:
    """Gathered sums, no products (the multiply-adds are elementwise):
    each table row the bags draw read once, the indices, the weights and
    the (B, D) f32 result.  From shapes every slot draws its own row and
    has a weight; a caller that counts the distinct rows drawn (`rows`)
    and the valid slots (`n_valid`) gives the data's work."""
    b, l = indices.shape
    rows = b * l if rows is None else rows
    w_bytes = 0.0
    if weights is not None:
        w_bytes = (_bytes_of(weights) if n_valid is None
                   else n_valid * weights.element_size())
    return KernelCost(0.0, rows * table.shape[1] * table.element_size()
                      + _bytes_of(indices) + w_bytes
                      + _out_bytes(sls_out(table, indices, weights)))


# name -> (cost formula, output shapes): the `kernels/ops.py` entries
KERNELS: Dict[str, Tuple[Callable[..., KernelCost], Callable]] = {
    "flash_attention": (flash_attention_cost, flash_attention_out),
    "decode_attention_partial": (decode_partial_cost, decode_partial_out),
    "decode_attention_fused": (decode_fused_cost, decode_fused_out),
    "decode_attention_fused_partial": (decode_fused_partial_cost,
                                       decode_fused_partial_out),
    "ssd_scan": (ssd_cost, ssd_out),
    "quant_matmul": (quant_matmul_cost, quant_matmul_out),
    "knn_distances": (knn_cost, knn_out),
    "knn_topk": (knn_topk_cost, knn_topk_out),
    "sls": (sls_cost, sls_out),
}


def kernel_cost(name: str, *args, **kwargs) -> KernelCost:
    """The formula of one kernel entry on its arguments."""
    return KERNELS[name][0](*args, **kwargs)


def kernel_outputs(name: str, *args, **kwargs) -> List[Tuple[tuple,
                                                            torch.dtype]]:
    """(shape, dtype) of each output of a kernel entry."""
    return KERNELS[name][1](*args, **kwargs)
