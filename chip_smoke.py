"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each against its plain PyTorch version at the full-width shapes of the
paths that run it and times it, then drives the ported serve paths with
random weights from seed 0, each with continuous batching and streamed
decode:
  * full-width starcoder2_3b, under `axle` (the fused decode kernel, with
    the flash prefill kernel) and under `rp` (the partial kernel);
  * full-width starcoder2_3b quantized: q8_0 weights and an int8 KV cache
    under `axle` (the dequant-fused matmul kernel in every projection,
    the int8 fused decode kernel), and short runs under q4_k weights and
    under `rp` (int8 pools dequantized up front);
  * full-width mamba2_370m on its first 24 of 48 layers (the SSD scan
    kernel in every prefill; its decode is plain torch, as the
    reference's is plain XLA; the [tier] and [chunked] phases serve all
    48).
On the card the server runs every decode segment as one CUDA graph
replay (`launch/graphs.py`, captured when the server is built): every
serve checks that each segment was a replay, and the `[graph]` lines
hold each graphed serve (fp `axle` and `rp`, q8_0 + int8 KV, mamba2_370m)
to an eager twin (`EagerServer`, the same server with its segments run
launch by launch) on the same requests and weights: tokens, the cache's
bytes at drain, the page ledger and the launch counts bitwise equal, and
print tok/s of both and, per captured segment, its kernels, device ms
and wall ms a replay.  The `[sampling]` line serves the 8 starcoder2_3b
requests again, half sampled (T 0.8, top_k 50, top_p 0.95, seed 1000 +
id), half greedy, one of those with stop tokens: seg_len 8 == per-token
== each request alone, the greedy rows == the greedy serve's, and the
sampling epilogue's device time at B = 4 over the padded vocabulary.
The `[spec]` lines serve by speculative draft-and-verify (spec_k 3, a
segment of 8 rounds), starcoder2_3b on its first 8 of 30 layers (views
of the `[serve]` weights): the 8 `[serve]` requests with the self:2
draft (tokens == the non-spec serve's at the verify's row count
bitwise, graph == eager with the draft cache too, fused decode launches
== rounds x 4 x (2 + 8)), the whole-target self:8 draft (accept rate
exactly 1, more tokens a sync), the `[sampling]` requests (budgets and
stops, 8 rounds == 1 round a segment == alone, greedy rows == the greedy
spec serve's); then at full depth q8_0 + int8 KV (every draft and verify
product on the skinny route) and mamba2_370m with the self:12 draft
(tokens == its `[serve]` tokens).
The `[archs]` lines serve the other dense attention archs at full width,
each model freed before the next: gemma3_12b (five sliding-window layers
of 1024 to one full layer, head dim 256 on the tensor-core kernels) on 8
requests of 600-1500 tokens over 2048-slot rows, two prompts past the
window and two decoding across position 1024, with a request alone ==
its row in the batch, graph == eager on 2 requests, the logits against
the plain path and, on the same weights and tokens with every layer
"full", the same bits inside the window and other logits past it;
mistral_nemo_12b through the ported `serve_offload` example (bs == axle
bitwise, rp equal or parting only at near ties); opt_2_7b (MHA, head
dim 80 on the tensor-core kernels; 2 requests with its self:8 draft ==
the padded non-spec twin, and the same 2 under rp, equal to axle up to
near ties, and with an int8 KV cache), minitron_4b and qwen2_vl_2b
(M-RoPE). Each prints tok/s, the decode step's device ms and kernels
(one replay under the profiler), peak memory and the step's weight-read
bound.  Their `[kernel]` rows hold the attention kernels at head dims
256 and 80 (flash at S 2048 with a window of 1024; the fused decode over
2048 slots with a window of 1023, bf16 and int8 pools; the partial)
and 64 (granite_moe_3b's 24 heads on 8 KV heads, no window) against the
plain versions, beside SDPA with an explicit boolean mask, in bf16 on
the tensor cores and on f32 copies on the CUDA cores.
The `[moe]` lines serve the Mixture-of-Experts archs at full width, each
model freed before the next: granite_moe_3b at all 32 layers (40
experts, top-8, head dim 64) on 8 requests of 64-400 tokens x 32 (graph
== eager and request 1 alone == its row in the batch, bitwise), 2
requests with its self:8 draft (held to the non-spec twin at the
verify's row count by the near-tie gate: the verify routes 16 rows
together, so its capacity can drop pairs the decode step keeps), and the
same 2 under rp (to axle, by the near-tie gate) and with an int8 KV
cache (the hd 64 partial and int8 decode on a serve); then the CARD
configs of phi3_5_moe_42b (the first 24 of 32 layers) and
jamba_1_5_large (its first 5 of 72 layers: four mamba layers on the
tensor-core scan, one attention layer, MoE at 0, 2 and 4) on 4 requests
x 16.  Each prints tok/s, the decode step's device ms and kernels, its
weight-read bound (every expert's bytes: the dispatch multiplies all of
them) and peak memory.
The `[encdec]` lines serve the encoder-decoder whisper_large_v3 at full
width (32 encoder and 32 decoder layers, 20 heads of 64, enc_len 1500),
each request bringing random frames for the stubbed audio frontend: 8
requests of 4-32 prompt tokens x 64, 4 on clips of 1500 frames and 4 on
600-1400, over 448-slot rows (one encoder pass an admission, every
decode step one dense cross read a layer over the slot's clip),
request 1 alone == its row in the batch, graph == eager over two
admissions in one slot, the logits against the plain path, its self:8
spec serve == the padded non-spec twin (one encoder pass an admission),
the same 2 requests under rp (near-tie gate) and with an int8 KV cache;
with tok/s, the decode step's device ms and kernels, its bound (decoder
weights, cross-K/V and self-K/V bytes), one admission's ms and device
busy share, and peak memory.  Its `[kernel]` rows hold the cross read at
whisper's shapes (dense S 1500, clips of 1, 600, 1499 and 1500 frames:
12 splits of 125 rows) fused and partial, and the MHA hd 64 prefill, each
against its plain version, beside SDPA.
The `[tier]` lines serve through the host tier and the prefix cache at
full width, each run against a non-evicting (or no-cache) twin of the
same requests and weights, under axle, seg_len 8, streamed, evict_after
1, 2 chunks a leaf: whisper_large_v3 (4 x 16 over 2 slots, clips of
600-1500 frames), starcoder2_3b fp (12 requests of 64-400 tokens x 64,
half sampled, over 4 slots; and per-token), q8_0 + int8 KV and self:7
spec (6 x 32 over 2 slots, the draft's row in the same snapshot) and
mamba2_370m (8 x 32 over 2): tokens == the twin's bitwise, every
eviction restored or found dead, the tier drained, one decode sync a
segment and one more an admission or a restore; with bytes a slot, host
ms an evict and a restore (by call), ms from an eviction's start to its
snapshot's landing and GB/s beside the link's 64 GB/s data sheet, a
slot's copy each way alone, the graphed decode step's device ms with and
without a slot's copy beside it, and peak pinned bytes.  The prefix
cache on starcoder2_3b and mamba2_370m (a 384-token head alone, 8 x head
+ a 16-64-token tail, repeats of the head and of the 8th; 4 slots):
(full, partial, miss) = (2, 8, 1), the miss and the head's full hit ==
the no-cache twin bitwise, the 8th's full hit == the 8th, the streams
through a resume at near ties (mamba: printed in bf16, gated in f32),
mamba's resume on the `ssd_scan` kernel from `init_state`
(`LAUNCHES["ssd_scan_init"]`), and admission ms with a full hit, a
partial hit and without.
The `[chunked]` lines admit a long prompt in chunks, one between two
decode segments (`prefill_chunk`), under axle, seg_len 8, streamed, each
run against a twin without the long request and one that admits it in
one shot, on the same weights from seed 0: starcoder2_3b fp (5 slots of
5,120 rows, 4 greedy requests of 64-400 tokens x 64 in flight, then a
5,000-token prompt x 32 in 10 chunks of 512), q8_0 + int8 KV (3 slots
of 2,304, 2 requests in flight, a 2,000-token prompt in 11 chunks of 192,
starting mid-page) and mamba2_370m (the fp shape; in f32 the long
request alone, chunked == one-shot bitwise): the in-flight tokens ==
the no-admission twin's bitwise and retired at the same decode syncs,
the chunks counted, every segment while a slot is reserved the
write-masked graph, the long request == its one-shot twin up to near
ties (printed for q8_0 and bf16 mamba); with a chunk's host ms, its span
on the stream and its device ms, the in-flight rows' longest gap between
segments and their tok/s in all three runs, and peak memory.  Inside
`[archs]`, gemma3_12b admits two 1,500-token prompts in chunks of 512
across its window, held to its one-shot serve by the near-tie gate, and
serves 4 of its requests x 48 through the routes no other serve runs at
head dim 256: an int8 KV cache (every decode step 48 tensor-core int8
fused decodes; graph == eager, streamed == per-token, logits across the
window's edge within LOGIT_ATOL of the plain path, each int8 decode
within ATOL_BF16 of its plain version, pools and scales at most 0.55 of
the bf16 pools), `rp` over the fp cache (tensor-core partials; tokens
== the axle serve's bitwise) and, on 2 requests x 16, over the int8
cache (the f32 CUDA-core partial; the near-tie gate), then 2 slots of
4,096 positions with prompts of 2,040 and 3,500 tokens (graph == eager,
request 0 alone == its row, logits within LOGIT_ATOL of the plain path);
the int8 and rp serves print `[archs]` lines like the others.  Section
3a's `rp vs bs` rows hold the chunked schedule with one chunk to the
fused one bitwise (gemma3_12b's local and global layers, starcoder2_3b,
mistral_nemo_12b) and print how far 4 chunks part.  The
`[quickstart]` line runs the ported quickstart on the card: the
simulator's AXLE runtime reduction on workload (e), and BS vs AXLE decode
attention within 1e-5.
The `[mesh]` lines serve on a 1x2 gloo group on the one card, through
the ported `examples/mesh_serve.py` in a process of its own, after this
process has freed what it held: full-width starcoder2_3b, 4 requests (2
greedy, 2 sampled) x 32 tokens, the tokens, decode syncs and ledger of
both ranks bitwise the graphed single-device server's, the wire bytes
beside the ledger's formula (24,960 B a merge, 30 merges a step), each
rank's fused-partial launches and eager decode step device ms; then in
the same group BS, AXLE and RP over a sequence-sharded cache of 8192
slots in bf16 and f32, each held to the fused decode, with each AXLE
hop's ms.  The `[mesh] tier` lines then run the example again at 2x1 (2
slot rows a rank), on starcoder2_3b's first 8 layers: a churn serve (6 requests on 4 slots, evicted after a
segment), a prefix serve (a prompt served, repeated and extended) and a
chunked serve (a 900-token prompt in chunks of 256 beside 3 streams),
each bitwise the graphed single-device server (tokens, decode syncs,
ledger, evictions, restores, prefix hits, chunks) on both ranks, the
churn and prefix serves moving snapshots between the data groups
(`tier_moves` > 0), with each rank's bytes moved, a restore's host ms
moved and local beside the single device's, and its cache bytes.  The
`[kernel] decode_attention_fused_partial` row holds the mesh decode's
producer: normalised, and as head groups concatenated, the fused
decode's bits.
The `[train]` lines train on the one card (`launch/steps.make_train_step`:
autograd over the plain-torch forward, as the reference's training path
reaches no Pallas kernel, so they launch none of ours): the smoke
starcoder2_3b, mamba2_370m and granite_moe_3b in f32 on the card against
the CPU (the loss within 1e-5 relative, every gradient leaf within 1e-5 of
its max: TF32 would part them by ~1e-3); 8 steps each, bf16, B 4 x S 2048,
compression and remat on, of starcoder2_3b's first 8 of 30 layers at full
width (its state at full depth, 83 GB, exceeds the card), mamba2_370m's
first 24 of 48 layers (on its first batch every step: over fresh batches
its loss stays in their noise) and granite_moe_3b's first 4 of 32 layers,
every loss and grad norm finite and the last loss below the first, with each
step's wall ms and tokens/s, one step's device ms and forward / backward /
optimizer split, peak memory and the step's bound from the dry-run's
counter (`roofline/cost.py` on meta tensors, counted in a child process
that starts after the build);
starcoder2_3b's first 2 layers in bf16 against an f32 twin (loss within
1%, every gradient's cosine >= 0.99); and the ported
`examples/train_pipeline.py` config (its first 2 layers) through
`launch/train.py` in processes
of their own, restarted (steps 6 / 0 / 2) and preempted by a SIGTERM, each
ending at the uninterrupted run's losses and final checkpoint bit for bit.
The `[mesh_train]` lines train on a mesh of two gloo ranks on the one card,
through the ported `examples/mesh_train.py` in a process of its own, f32,
3 steps a case: starcoder2_3b's first 2 layers at full width, B 4 x S
1024, at 2x1 with FSDP forced and at 1x2 compressed, and granite_moe_3b's
first 2 layers, B 4 x S 256 at 1x2 (the expert-parallel MoE, 20 of 40
experts a rank), each held to the single-device step on the card (the
CPU tests' gates at step 1; at step 3 the bound, the elements off counted
beside a reordered-rows control's), with each rank's stored bytes, a
step's wire bytes and its (gloo-staged) wall.
The `[dryrun]` lines hold the dry-run (`launch/dryrun.py`) to the card:
three starcoder2_3b cells (a decode of all 30 layers, 8 rows over
32,768 slots; a prefill of the first 2 layers over 32,768 tokens; a train
step of the first 8 layers, B 4 x S 2048) run once inside the cost
counter and three times without it: the card's FLOPs, bytes and op count
== the child's count of the same cells on meta tensors, the predicted
peak within 10% of the growth of max_memory_allocated, the device time
(CUDA events) beside the roofline bound and fraction; then three 2 x 16
x 16 rows the child counted, the train row on the training mesh's specs
(sharded parameters and AdamW state, the sequence over the model axis).  The `[knn_topk]` line holds `knn_topk` (the
distance kernel, then the k smallest) to its plain version bitwise on
integer-valued inputs full of ties.
Before serving, it drives the paper's two offload workloads through
`stream_offload` under BS, RP and AXLE, data from seed 0 on the card:
  * KNN (VectorDB): 256 queries against a 1,000,000 x 1024 bf16 database
    in 8 chunks (the distance kernel per chunk, the top-8 merge on the
    consumer side), and the port's `knn_offload` example;
  * SLS (DLRM): 4096 bags of up to 100 slots over a 1,000,000 x 256 f32
    table in 8 chunks of 512 bags (the SLS kernel per chunk).
Every phase prints one line; any failure exits non-zero.  The last three
lines are the kernels' JSON record, the card's name and power limit, and
`{"ok": true, "device": {...}}`.

Five functions have a tensor-core kernel beside their CUDA-core one:
bf16 flash_attention at hd 64, 80, 128 or 256 (`flash_tc_kernel`,
mma.sync), bf16 knn_distances with D % 8 == 0 (`knn_wgmma_kernel`, TMA
and wgmma), the bf16 decode (fused, int8 pools and partial at hd 64, 80,
128 or 256: `decode_split_tc_kernel`, a split of the KV range merged in
order by `decode_merge_kernel`), bf16 prefill quant_matmul
(`quant_tc_kernel`, mma.sync) and the bf16 SSD scan at P = 64, N = 128
(`ssd_chunk_tc_kernel`, `ssd_pass_kernel`, `ssd_out_tc_kernel`: chunk
states, an ordered pass, outputs).  The `[build]` line fails unless
their SASS holds HMMA or HGMMA (and the attention kernels are compiled
at each of those head dims); the kernel
phases, the serves and the KNN offload fail unless every launch of those
functions that should take the tensor-core kernel did (the
`LAUNCHES["<name>_tc"]` and `LAUNCHES["knn_distances_wgmma"]` counters).
Decode quant_matmul (m <= 16) runs in one launch, its splits reduced
inside a thread-block cluster: bf16 x with at least 8 column tiles of 128
on the tensor cores (`skinny_tc_kernel`, mma.sync), the rest (f32 x, wk /
wv) on the CUDA cores (`skinny_kernel`): the kernel phase and the
quantized serves fail unless every decode product took it
(`LAUNCHES["quant_matmul[<fmt>]_skinny"]`) and no split-K pass ran
outside the prefills (`LAUNCHES["quant_matmul[<fmt>]_splitk"]`); its
records' `device_ms` is taken cold (calls rotating over copies of the
weight larger than the L2 together), the warm reading printed beside it.  Their records in the JSON
line describe the tensor-core kernels; quant_matmul has two records per
format, the decode product (`skinny_kernel`) and the prefill product
(`quant_matmul[<fmt>]_tc`).  The CUDA-core kernels, which take f32, are
held against the plain versions on f32 copies of the same inputs: flash
at S = 512 and the decode within 1e-5, the partial at its tolerance
below, each attention function again at head dims 256 and 80, knn on
the offload's chunk at the knn bound, quant_matmul on the prefill shape
within 1e-5 (|x| @ |W|).  Every `[kernel]` row also prints
its device time (`device_ms`, torch.profiler, kernels only) beside the
library call's or the yardstick's, and the JSON records carry both.

Tolerances (bf16 inputs, f32 accumulation in both versions):
  * attention outputs in bf16: |kernel - plain| <= 2e-2 — both round an
    f32 result that differs in summation order only (the tensor-core
    prefill keeps P to ~16 bits as a bf16 hi and lo pair), so they differ
    by at most one bf16 unit in the last place of values below 4 (0.0156);
  * partial statistics in f32: |kernel - plain| <= 1e-3 + 1e-4 |plain|;
  * paged == dense: bitwise, for fp and for int8 pools; a decode row run
    alone == that row in the batch, bitwise (the split is per row);
  * quant_matmul against x @ dequantize(W) in f32: |kernel - plain| <=
    1e-5 (|x| @ |W|) + one bf16 unit of the plain value — the same
    products summed in another order, then rounded to bf16;
  * the SSD scan against the sequential recurrence: |kernel - plain| <=
    1e-3 + 1e-3 |plain| on the f32 state and on an f32 y, and one bf16
    unit more (rtol 1e-2) on a bf16 y — the chunked form sums in another
    order and forms its decays as exponentials of cumsum differences;
  * KNN distances in f32: |kernel - plain| <= 1e-5 (|q| + |x|)^2 — the
    same f32 products summed in another order, and (|q| + |x|)^2 bounds
    every term of |q|^2 - 2 q.x + |x|^2; over the whole database the
    bound of a query's row, 1e-5 (|q| + max |x|)^2, holds the top-8
    distances, and the ids equal the plain path's except at near ties
    (the plain distance of the streamed id within that bound of the
    plain top-8 distance at its place); BS, RP and AXLE bitwise equal,
    and equal to one kernel call over the whole database;
  * SLS in f32: |kernel - plain| <= 1e-5 sum |w row| — both walk a bag in
    slot order with the same roundings, so they are expected bitwise
    equal (the line says whether they are); BS, RP and AXLE bitwise
    equal, and equal to one kernel call over all bags;
  * starcoder2_3b logits, kernel path vs plain path, prefill and 4
    decode steps on the same tokens (both paths decode the plain path's
    greedy tokens): <= 0.25 absolute after 30 bf16 layers, and each
    step's greedy tokens equal except where the two best logits lie
    within 0.1 of each other (a near tie);
  * quantized starcoder2_3b (q8_0 weights, int8 KV): in bf16, each of the
    served model's quant_matmul and int8 fused-decode launches is held to
    its plain version on that launch's own inputs, with the kernel
    tolerances above; the logits are held in f32 arithmetic (the same
    quantized weights, fp leaves cast): <= 1e-2 absolute with fp and with
    int8 KV, and the near-tie gate.  Not in bf16: every one of the 210
    products then differs from the plain path by a bf16 unit here and
    there, and the random-weight stack amplifies that past 0.25 (the line
    prints by how much, and does not gate it);
  * mamba2_370m: in bf16, every layer's scan of the served model is held
    to the plain version on that layer's own inputs, with the scan
    tolerance above.  Its logits are held in f32 arithmetic (the same
    weights, cast): <= 1e-2 absolute after its 24 layers, and the
    near-tie gate on greedy tokens.  Not in bf16: the two paths differ
    only in the scan's y, by one bf16 unit here and there, and the
    random-weight 24-layer stack amplifies such a difference until the bf16 logits of
    the two paths part by units (the line prints by how much, and does
    not gate it).  In f32 the scans differ in the last bits of an f32
    sum instead of a bf16 unit (2^-8), so the same stack stays within
    1e-2;
  * the MoE archs' logits, kernel path vs plain path: <= 0.25 and the
    near-tie gate, as starcoder2_3b's, with both paths routed to the
    kernel path's experts: a router turns a one-unit difference into
    another expert wherever two router logits nearly tie (a prefill makes
    thousands of such choices), and one swapped expert moves a whole
    logit row.  Each row the plain router would send elsewhere must be at
    a router near tie (its own k-th best router logit within 0.1 of the
    forced experts').  Two MoE serves (rp vs axle, spec vs its twin) may
    part only at a near tie of the logits in a replay of the stream as
    the server computed it, or after their replays' routes first part at
    router near ties.
  * whisper_large_v3 logits, kernel path vs plain path (the encoder is
    plain torch on both): <= 0.25 and the near-tie gate, as
    starcoder2_3b's; rp vs axle by the near-tie gate.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet (as
BF16_FLOPS_PER_S = 989e12        # src/repro_torch/roofline/analysis.py)
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
ATOL_BF16 = 2e-2
LOGIT_ATOL = 0.25
LOGIT_ATOL_F32 = 1e-2
NEAR_TIE = 0.1


PHASE_T = []                      # (section, its start)


def phase(section: str) -> None:
    """Section `section` starts here; the seconds of each are printed at
    the end."""
    PHASE_T.append((section, time.perf_counter()))


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


if not torch.cuda.is_available():
    fail("torch.cuda.is_available() is False: this script needs a GPU")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:
    from repro_torch import tree as ptree
    from repro_torch.configs import (get_card_config, get_config,
                                     get_smoke_config)
    from repro_torch.core import prng
    from repro_torch.core.backstream import (OffloadConfig, OffloadProtocol,
                                             decode_attention_combined,
                                             stream_offload,
                                             stream_offload_to_device,
                                             stream_offload_to_host,
                                             use_offload)
    from repro_torch.data.pipeline import (DataConfig, make_pipeline,
                                           synth_batch)
    from repro_torch.examples import (knn_offload, quickstart, serve_offload,
                                      train_pipeline)
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import knn as kknn
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quant as kquant
    from repro_torch.kernels import sls as ksls
    from repro_torch.kernels import ssd as kssd
    from repro_torch.core import backstream
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import (BatchedServer, Request,
                                          SamplingParams, _prefill_bucket)
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.steps import QuantConfig, self_draft_params
    from repro_torch.models import encdec, layers, transformer
    from repro_torch.models.quantize import padded_rows, quantize_params
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw, compression
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis
    from repro_torch.roofline import cost as kcost
except ImportError as exc:
    fail(f"the repro_torch package is not beside this script: {exc}")

DEV = torch.device("cuda")
ARCH = "starcoder2_3b"
MAMBA = "mamba2_370m"


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of one call, CUDA events around each call, with
    the 50 MB L2 flushed before it (the main path finds each layer's
    cache cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_by_name(fn, iters: int = 20, attempts: int = 5):
    """Device time of one call by kernel name: every kernel, memset and
    copy it runs, from torch.profiler over `iters` back-to-back calls
    (warm L2), divided by `iters`; no host time in it, where time_ms's
    events also see the host's launch when it is slower than the device.
    The profiler now and then drops part of a window, or all of it: a
    window is kept only when every kernel in it ran a whole multiple of
    `iters` times (each call launches the same kernels), else it is taken
    again, up to `attempts` times, and None ("not measured") is returned
    if none was whole."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0 and all(e.count % iters == 0 for e in events):
            return {e.key: e.self_device_time_total / iters / 1e3
                    for e in events}
    return None


def device_ms(fn, iters: int = 20, attempts: int = 5):
    """`device_by_name`'s times summed: the device time of one call."""
    parts = device_by_name(fn, iters, attempts)
    return None if parts is None else sum(parts.values())


def split_parts(fn, split, n_split):
    """One decode call's device time by kernel and its plan, for a
    `[kernel]` row: the split kernel and the merge kernel."""
    parts = device_by_name(fn)
    if parts is None:
        return f"parts not measured; {n_split} splits of {split} rows"
    got = {k: sum(t for n, t in parts.items() if k in n.lower())
           for k in ("decode_split", "decode_merge")}
    return (f"split kernel {got['decode_split']:.4f} ms + merge kernel "
            f"{got['decode_merge']:.4f} ms; plan {n_split} splits a row of "
            f"{split} rows, {-(-split // fa.DECODE_TILE)} tile(s) of "
            f"{fa.DECODE_TILE} a split")


def show(x, spec: str = ".4f") -> str:
    return "not measured" if x is None else format(x, spec)


def div(a, b):
    return None if a is None or not b else a / b


def timings(kernel, plain, library=None) -> dict:
    """A record's times: time_ms of the kernel, its plain version and the
    library call, and device_ms of the kernel and the library call."""
    return dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=None if library is None else time_ms(library),
                device_ms=device_ms(kernel),
                library_device_ms=None if library is None
                else device_ms(library))


def routes_of(counts, *names) -> dict:
    """The counts of `names` and of their tensor-core counters in
    `counts`."""
    return {k: counts[k] for n in names for k in (n, n + "_tc")}


def routes(*names) -> dict:
    """The launch counts of `names` and their tensor-core counters."""
    return routes_of(kbuild.LAUNCHES, *names)


def on_cuda_cores(what, call, name, calls=1):
    """`call()` on f32 copies of a row's inputs: `calls` launches of
    `name`, none of them on its tensor-core kernel.  Returns the output
    and the launch counts."""
    kbuild.reset_launch_counts()
    got = call()
    variants = routes(name)
    torch.cuda.synchronize()
    check(variants == {name: calls, name + "_tc": 0},
          f"{what} f32: launches {variants}, not the CUDA-core kernel")
    return got, variants


def f32_err(got, want, what):
    """Max |kernel - plain| of an f32 output; fails past 1e-5."""
    err = (got - want).abs().max().item()
    check(err <= 1e-5, f"{what} f32: err {err}")
    return err


def bound_ms(n_bytes: float, flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound(name, *args, flops_per_s=BF16_FLOPS_PER_S, **kw) -> tuple:
    """`bound_ms` of one kernel call from its formula in
    `roofline/cost.py` (the dry-run's yardstick); the data's counts (valid
    keys, pages, rows) as keywords; `flops_per_s` the peak of the inputs'
    type (F32_FLOPS_PER_S for f32 on the CUDA cores)."""
    c = kcost.kernel_cost(name, *args, **kw)
    return bound_ms(c.bytes, c.flops, flops_per_s)


KERNEL_KINDS = ("ssd_kernel", "ssd_chunk_tc_kernel", "ssd_pass_kernel",
                "ssd_out_tc_kernel", "decode_split_tc_kernel",
                "decode_split_kernel", "decode_merge_kernel", "flash_kernel",
                "flash_tc_kernel", "skinny_kernel", "skinny_tc_kernel",
                "tiled_kernel",
                "quant_tc_kernel", "splitk_reduce", "knn_kernel",
                "knn_wgmma_kernel", "sls_kernel")
TEMPLATE_ARGS = {"13__nv_bfloat16": "bf16", "S1_": "bf16", "f": "f32",
                 "a": "i8", "Li32E": "32", "Li64E": "64", "Li80E": "80",
                 "Li128E": "128", "Li256E": "256",
                 "Lb0E": "0", "Lb1E": "1", "Li0E": "0", "Li1E": "1"}
# the tensor-core kernels and the instruction their SASS must hold
TENSOR_CORE_SASS = {"flash_tc_kernel": "HMMA", "knn_wgmma_kernel": "HGMMA",
                    "decode_split_tc_kernel": "HMMA",
                    "quant_tc_kernel": "HMMA", "skinny_tc_kernel": "HMMA",
                    "ssd_chunk_tc_kernel": "HMMA",
                    "ssd_out_tc_kernel": "HMMA"}


def ptxas_summary(log: str) -> str:
    """`-Xptxas -v`'s registers and spills of each kernel, one item per
    compiled kernel, named by its mangled name's kernel and template
    arguments (types, then flags and formats as 0 / 1 in source order)."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            kind = next((k for k in KERNEL_KINDS if k in mangled), mangled)
            tmpl = mangled.split(kind, 1)[-1]
            tmpl = tmpl[1:tmpl.find("EEv") + 1] if tmpl.startswith("I") \
                else ""
            args = re.findall("|".join(map(re.escape, TEMPLATE_ARGS)), tmpl)
            name = f"{kind}<{','.join(TEMPLATE_ARGS[a] for a in args)}>"
        elif name and "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split(",")[0].strip()
            out.append(f"{name} {regs}, {spill}")
            name = None
    return "; ".join(out) or "not in the build log"


def sass_check(lib: Path) -> str:
    """`cuobjdump -sass` on the built library: every compiled function of
    each TENSOR_CORE_SASS kernel holds its tensor-core instruction; fails
    if one does not."""
    cuobjdump = Path(kbuild.nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr}")
    funcs = re.split(r"\n\s*Function : ", proc.stdout)[1:]
    parts = []
    for kernel, op in TENSOR_CORE_SASS.items():
        bodies = [f for f in funcs if kernel in f.split("\n", 1)[0]]
        counts = [f.count(op) for f in bodies]
        check(bodies and all(counts),
              f"{kernel}: {op} not in its SASS ({counts} in {len(bodies)} "
              "compiled functions)")
        parts.append(f"{kernel} {op} x{'/'.join(map(str, counts))}")
    # the attention kernels are instantiated at every head dim their
    # route takes
    for kernel in ("flash_tc_kernel", "decode_split_tc_kernel"):
        dims = [hd for hd in fa.TC_HEAD_DIMS
                if not any(f"{kernel}ILi{hd}E" in f.split("\n", 1)[0]
                           for f in funcs)]
        check(not dims, f"{kernel}: no instantiation at head dims {dims}")
    return "; ".join(parts) + (f"; flash_tc_kernel and decode_split_tc_"
                               f"kernel at hd {fa.TC_HEAD_DIMS}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

phase("1")

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60)
check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
SMI_LINE = smi.stdout.strip().splitlines()[0]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(SMI_LINE, flush=True)
print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
      f" torch {torch.__version__} cuda {torch.version.cuda}; "
      "TF32 off for matmul and cuDNN", flush=True)

# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

phase("2")

t0 = time.perf_counter()
lib = kbuild.build()
print(f"[build] nvcc {lib.name} in {time.perf_counter() - t0:.2f} s; "
      f"ptxas: {ptxas_summary(lib.with_suffix('.log').read_text())}; "
      f"SASS: {sass_check(lib)}", flush=True)

# the [dryrun] phase's meta-tensor counts, and the counts behind the
# [train] bounds, in a process of its own (no card: it runs the port's
# steps on meta tensors) while the phases below run; read at [train]
DRY_CELLS = {   # name: (kind, arch, layers (None: all), batch, seq)
    "decode": ("decode", ARCH, None, 8, 32768),
    "prefill": ("prefill", ARCH, 2, 1, 32768),
    "train": ("train", ARCH, 8, 4, 2048),
}
TRAIN_RUNS = {  # the [train] runs: arch, layers (None: all)
    f"{ARCH}_first8": (ARCH, 8), f"{MAMBA}_first24": (MAMBA, 24),
    "granite_moe_3b_first4": ("granite_moe_3b", 4),
}
DRY_ROWS = (("starcoder2_3b", "decode_32k"), ("mamba2_370m", "prefill_32k"),
            ("starcoder2_3b", "train_4k"))
DRY_CHILD = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
spec = json.loads(sys.argv[1])
def cut(arch, layers):
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(
        cfg, arch_id=f"{arch}_first{layers}", n_layers=layers)
out = {"cells": {}, "train": {}, "rows": []}
for name, (kind, arch, layers, b, s) in spec["cells"].items():
    out["cells"][name] = dryrun.counts(
        dryrun.meta_device_cell(cut(arch, layers), kind, b, s))
for name, (arch, layers) in spec["train"].items():
    grads, update = dryrun.meta_train_parts(cut(arch, layers), 4, 2048)
    out["train"][name] = {"grads": dryrun.counts(grads),
                          "update": dryrun.counts(update)}
for arch, shape in spec["rows"]:
    out["rows"].append(dryrun.run_cell(arch, shape, multi_pod=True))
with open(spec["out"], "w") as f:
    json.dump(out, f)
"""
DRY_OUT = Path(__file__).resolve().parent / "build" / "dryrun_meta.json"
DRY_OUT.parent.mkdir(exist_ok=True)
DRY_OUT.unlink(missing_ok=True)
DRY_ERR = open(DRY_OUT.with_suffix(".err"), "w")
DRY_PROC = subprocess.Popen(
    [sys.executable, "-c", DRY_CHILD, json.dumps(
        {"cells": DRY_CELLS, "train": TRAIN_RUNS, "rows": DRY_ROWS,
         "out": str(DRY_OUT)})],
    env=dict(os.environ, PYTHONPATH=str(DRY_OUT.parents[1] / "src"),
             CUDA_VISIBLE_DEVICES=""), stdout=DRY_ERR, stderr=DRY_ERR)
atexit.register(lambda: DRY_PROC.poll() is None and DRY_PROC.kill())
DRY: dict = {}


def dry_meta() -> dict:
    """The child's counts (waits for it the first time)."""
    if not DRY:
        try:
            rc = DRY_PROC.wait(timeout=900)
        except subprocess.TimeoutExpired:
            DRY_PROC.kill()
            fail("[dryrun] the meta-count process outlasted 900 s")
        DRY_ERR.close()
        check(rc == 0, "[dryrun] the meta-count process failed: "
              + DRY_OUT.with_suffix(".err").read_text()[-3000:])
        DRY.update(json.loads(DRY_OUT.read_text()))
    return DRY


# --------------------------------------------------------------------------
# 3. kernels against their plain versions, at main-path shapes
# --------------------------------------------------------------------------

phase("3")

cfg = get_config(ARCH)
B, H, KH, HD = 4, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
S, PAGE = 1024, 128
G = torch.Generator(device=DEV).manual_seed(0)


def randn(*shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=G, device=DEV).to(dtype)


records = {}

# decode_attention_fused: paged pool with a permuted table, ragged pos
q = randn(B, 1, H, HD)
k_log, v_log = randn(B, KH, S, HD), randn(B, KH, S, HD)
n_pages = S // PAGE
table = torch.stack([torch.randperm(n_pages, generator=G, device=DEV)
                     for _ in range(B)]).to(torch.int32)
k_pool, v_pool = torch.empty_like(k_log), torch.empty_like(v_log)
for b in range(B):
    for j in range(n_pages):
        p = int(table[b, j])
        phys, logical = slice(p * PAGE, (p + 1) * PAGE), \
            slice(j * PAGE, (j + 1) * PAGE)
        k_pool[b, :, phys] = k_log[b, :, logical]
        v_pool[b, :, phys] = v_log[b, :, logical]
pos = torch.tensor([0, 130, 400, 1023], dtype=torch.int32, device=DEV)
extra = (torch.randn(B, H, HD, generator=G, device=DEV),
         torch.randn(B, H, generator=G, device=DEV),
         torch.rand(B, H, generator=G, device=DEV) + 0.5)


def rows_alone(call, out, what):
    """Each row of the batch run alone (B = 1) gives that row's bits of the
    batched call: `call(b)` runs row b alone."""
    for b in range((out[0] if isinstance(out, tuple) else out).shape[0]):
        got = call(b)
        check(all(torch.equal(g, o[b:b + 1]) for g, o in zip(
            got if isinstance(got, tuple) else (got,),
            out if isinstance(out, tuple) else (out,))),
            f"{what}: row {b} alone != row {b} in the batch")


def one_row(b, *ts):
    return tuple(None if t is None else t[b:b + 1] for t in ts)


worst = 0.0
kbuild.reset_launch_counts()
for window in (0, 300):
    for ex in (None, extra):
        dense = fa.decode_attention_fused(q, k_log, v_log, pos, ex,
                                          window=window, blk_c=PAGE)
        paged = fa.decode_attention_fused(q, k_pool, v_pool, pos, ex,
                                          window=window, blk_c=PAGE,
                                          pages=table)
        plain = ref.decode_fused_reference(q, k_pool, v_pool, pos, ex,
                                           window=window, pages=table,
                                           page_size=PAGE)
        torch.cuda.synchronize()
        err = (paged.float() - plain.float()).abs().max().item()
        check(torch.equal(paged, dense),
              f"decode_attention_fused: paged != dense (window {window})")
        check(err <= ATOL_BF16, f"decode_attention_fused: err {err} "
              f"(window {window}, extra {ex is not None})")
        worst = max(worst, err)
variants = routes("decode_attention_fused")
check(variants == {"decode_attention_fused": 8,
                   "decode_attention_fused_tc": 8},
      f"decode_attention_fused: launches {variants}, not the tensor-core split")
rows_alone(lambda b: fa.decode_attention_fused(
    *one_row(b, q, k_pool, v_pool, pos), one_row(b, *extra), window=300,
    blk_c=PAGE, pages=table[b:b + 1]), paged, "decode_attention_fused")
valid_slots = int((pos + 1).sum())          # window 0: slots 0..pos
bnd, by = kernel_bound("decode_attention_fused", q, k_pool, v_pool, pos,
                       extra, table, blk_c=PAGE, n_valid=valid_slots)
k_gath = ref.gather_kv_pages(k_pool, table, PAGE)
v_gath = ref.gather_kv_pages(v_pool, table, PAGE)
sdpa_mask = ref.decode_valid_mask(pos, S, 0)[:, None, None, :]
records["decode_attention_fused"] = dict(
    name="decode_attention_fused", route="cuda",
    source="src/repro_torch/kernels/csrc/attention.cu",
    replaces="src/repro/kernels/flash_attention.py:313",
    max_abs_err=worst, bound_ms=bnd, bound_by=by,
    **timings(lambda: fa.decode_attention_fused(
        q, k_pool, v_pool, pos, extra, blk_c=PAGE, pages=table),
        lambda: ref.decode_fused_reference(
            q, k_pool, v_pool, pos, extra, pages=table, page_size=PAGE),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k_gath, v_gath, attn_mask=sdpa_mask,
            enable_gqa=True)))
rec = records["decode_attention_fused"]
split, n_split = fa.decode_split(S, PAGE, HD)
print(f"[kernel] decode_attention_fused B={B} H={H} KH={KH} hd={HD} S={S} "
      f"page={PAGE} permuted table, pos={pos.tolist()}, window 0 and 300, "
      f"extra on/off: max_abs_err {worst:.3g} <= {ATOL_BF16}; paged == dense "
      f"bitwise; each row alone == its row in the batch bitwise; launches "
      f"{variants} ({n_split} splits of {split} rows, the tensor-core split); "
      f"{rec['ms']:.4f} ms, bound {bnd:.6f} ms ({by}), plain "
      f"{rec['plain_ms']:.4f} ms, library (SDPA on the gathered cache, "
      f"without extra) {rec['library_ms']:.4f} ms; device time "
      f"(torch.profiler, warm L2) {show(rec['device_ms'])} ms, the "
      f"library's {show(rec['library_device_ms'])} ms: "
      f"{show(div(rec['device_ms'], rec['library_device_ms']), '.2f')}x it",
      flush=True)
# the CUDA-core split, which takes f32: the same data in f32, paged and
# dense, against the plain version within 1e-5
q32, kl32, vl32, kp32, vp32 = (t.float() for t in (q, k_log, v_log, k_pool,
                                                   v_pool))
(out, dense), variants = on_cuda_cores(
    "decode_attention_fused",
    lambda: (fa.decode_attention_fused(q32, kp32, vp32, pos, extra,
                                       window=300, blk_c=PAGE, pages=table),
             fa.decode_attention_fused(q32, kl32, vl32, pos, extra,
                                       window=300, blk_c=PAGE)),
    "decode_attention_fused", calls=2)
err = f32_err(out, ref.decode_fused_reference(
    q32, kp32, vp32, pos, extra, window=300, pages=table, page_size=PAGE),
    "decode_attention_fused")
check(torch.equal(out, dense), "decode_attention_fused f32: paged != dense")
print(f"[kernel] decode_attention_fused f32, window 300, extra: max_abs_err "
      f"{err:.3g} <= 1e-5; paged == dense bitwise; launches {variants}; the "
      f"CUDA-core split, {time_ms(lambda: fa.decode_attention_fused(q32, kp32, vp32, pos, extra, blk_c=PAGE, pages=table)):.4f} ms",
      flush=True)
del q32, kl32, vl32, kp32, vp32, out, dense

# flash_attention: prefill of one prompt, S = 8, 300 (ragged) and 512,
# causal, and a window of 300 at S = 512; bf16 at hd 128 takes the
# tensor-core kernel (flash_route)
worst = 0.0
for s, window in ((8, 0), (300, 0), (512, 300), (512, 0)):
    qf, kf, vf = randn(1, s, H, HD), randn(1, s, KH, HD), randn(1, s, KH, HD)
    kbuild.reset_launch_counts()
    out = fa.flash_attention(qf, kf, vf, causal=True, window=window)
    variants = {k: kbuild.LAUNCHES[k]
                for k in ("flash_attention", "flash_attention_tc")}
    plain = ref.mha_reference(qf, kf, vf, causal=True, window=window)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    check(err <= ATOL_BF16, f"flash_attention S={s} window {window}: err "
          f"{err}")
    check(variants == {"flash_attention": 1, "flash_attention_tc": 1},
          f"flash_attention S={s}: launches {variants}, not the tensor-core "
          "kernel")
    worst = max(worst, err)
    print(f"[kernel] flash_attention S={s} H={H} KH={KH} hd={HD} causal, "
          f"window {window}: max_abs_err {err:.3g} <= {ATOL_BF16}; launches "
          f"{variants}", flush=True)
bnd, by = kernel_bound("flash_attention", qf, kf, vf, causal=True)
records["flash_attention"] = dict(
    name="flash_attention", route="cuda",
    source="src/repro_torch/kernels/csrc/attention.cu",
    replaces="src/repro/kernels/flash_attention.py:98",
    max_abs_err=worst,
    ms=time_ms(lambda: fa.flash_attention(qf, kf, vf, causal=True)),
    plain_ms=time_ms(lambda: ref.mha_reference(qf, kf, vf, causal=True)),
    bound_ms=bnd, bound_by=by,
    library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
        is_causal=True, enable_gqa=True)))
rec = records["flash_attention"]
flash_flops = kcost.kernel_cost("flash_attention", qf, kf, vf,
                                causal=True).flops
dev_k = device_ms(lambda: fa.flash_attention(qf, kf, vf, causal=True))
dev_l = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
    qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
    is_causal=True, enable_gqa=True))
rec.update(device_ms=dev_k, library_device_ms=dev_l)
# what bounds it at this size: the same prompt with H = KH (16 blocks, one
# per SM) times one block's chain of KV tiles alone
q_kh = randn(1, s, KH, HD)
dev_chain = device_ms(lambda: fa.flash_attention(q_kh, kf, vf, causal=True))
print(f"[kernel] flash_attention S={s} causal, timed: {rec['ms']:.4f} ms = "
      f"{flash_flops / rec['ms'] / 1e9:.2f} TFLOP/s, bound {bnd:.5f} ms "
      f"({by}), plain {rec['plain_ms']:.4f} ms, library (SDPA causal GQA) "
      f"{rec['library_ms']:.4f} ms: {rec['ms'] / rec['library_ms']:.2f}x it; "
      f"device time (torch.profiler, warm L2) {show(dev_k)} ms = "
      f"{show(div(flash_flops / 1e9, dev_k), '.2f')} TFLOP/s, the library's "
      f"{show(dev_l)} ms: {show(div(dev_k, dev_l), '.2f')}x it; with H = KH = "
      f"{KH} (one block per SM) {show(dev_chain)} ms", flush=True)
del q_kh
# the CUDA-core flash_kernel, which takes f32 (and the bf16 head dims the
# tensor-core kernel has no instantiation for): the S = 512 prompt in f32,
# against the plain version within 1e-5 (the GPU tests' f32 tolerance)
q32, k32, v32 = qf.float(), kf.float(), vf.float()
out, variants = on_cuda_cores(
    f"flash_attention S={s}",
    lambda: fa.flash_attention(q32, k32, v32, causal=True),
    "flash_attention")
err = f32_err(out, ref.mha_reference(q32, k32, v32, causal=True),
              f"flash_attention S={s}")
print(f"[kernel] flash_attention S={s} H={H} KH={KH} hd={HD} causal f32: "
      f"max_abs_err {err:.3g} <= 1e-5; launches {variants}; the CUDA-core "
      f"kernel, {time_ms(lambda: fa.flash_attention(q32, k32, v32)):.4f} ms",
      flush=True)
del q32, k32, v32, out

# decode_attention_partial: the rp path's one chunk over the whole cache,
# row 1 fully masked (and the splits past pos of the other rows)
valid = ref.decode_valid_mask(pos, S, 0)
valid[1] = False


def partial_err(got, want, what, empty=1):
    """Max error of the partial statistics; fails past 1e-3 + 1e-4 |plain|
    and unless the empty rows match (m = -inf, l = 0; row `empty` is one,
    None where no row is)."""
    (acc, m, l), (acc_r, m_r, l_r) = got, want
    check(torch.equal(torch.isinf(m), torch.isinf(m_r)) and (
        empty is None or (bool(torch.isinf(m[empty]).all())
                          and bool((l[empty] == 0).all()))),
          f"{what}: empty row must give m=-inf, l=0")
    fin = torch.isfinite(m_r)
    worst = 0.0
    for g, w in ((acc, acc_r), (m[fin], m_r[fin]), (l, l_r)):
        diff = (g - w).abs()
        check(bool((diff <= 1e-3 + 1e-4 * w.abs()).all()),
              f"{what}: err {diff.max().item()}")
        worst = max(worst, diff.max().item())
    return worst


def partial_excess(got, want):
    """Per row, the worst ratio of a partial's error to partial_err's
    limit, 1e-3 + 1e-4 |plain|, over acc, m and l."""
    return torch.stack([((g - w).abs() / (1e-3 + 1e-4 * w.abs())).flatten(
        1).amax(1) for g, w in zip(got, want)]).amax(0)


def bf16_out_excess(got, want32):
    """Per row, the worst ratio of |got - want32| to 5e-4 + 2^-8 |want32|:
    got a decode's bf16 output, want32 the plain version's in f32 on the
    same inputs.  2^-8 |want32| covers got's rounding to bf16 (2^-9
    relative) and as much again for the products the kernel takes in
    bf16; 5e-4 is twice the largest error (2.4e-4) measured against the
    bf16 plain version at whisper's cross read."""
    return ((got.float() - want32).abs()
            / (5e-4 + 2 ** -8 * want32.abs())).flatten(1).amax(1)


def split_faults(q, k, v, valid, split):
    """The partial statistics two planted faults of a split decode would
    give: in each row, the split (of `split` rows) in the middle of its
    valid range dropped, or read twice.  A limit that passes either on a
    row of two splits or more cannot tell a split decode from a wrong
    one."""
    j = (valid.sum(dim=1) - 1) // split // 2
    rows = torch.arange(valid.shape[1], device=valid.device)[None]
    one = valid & (rows >= j[:, None] * split) \
        & (rows < (j[:, None] + 1) * split)
    acc, m, l = ref.decode_partial_reference(q, k, v, valid)
    acc_s, m_s, l_s = ref.decode_partial_reference(q, k, v, one)
    w = torch.exp(m_s - m)
    return {"dropped": ref.decode_partial_reference(q, k, v, valid & ~one),
            "read twice": (acc + acc_s * w[..., None], m, l + l_s * w)}


kbuild.reset_launch_counts()
part = fa.decode_attention_partial(q, k_log, v_log, valid)
variants = routes("decode_attention_partial")
torch.cuda.synchronize()
worst = partial_err(part, ref.decode_partial_reference(q, k_log, v_log,
                                                       valid),
                    "decode_attention_partial")
check(variants == {"decode_attention_partial": 1,
                   "decode_attention_partial_tc": 1},
      f"decode_attention_partial: launches {variants}, not the tensor-core "
      "split")
rows_alone(lambda b: fa.decode_attention_partial(
    *one_row(b, q, k_log, v_log, valid)), part, "decode_attention_partial")
acc, m, l = part
n_valid = int(valid.sum())
bnd, by = kernel_bound("decode_attention_partial", q, k_log, v_log, valid,
                       n_valid=n_valid)
records["decode_attention_partial"] = dict(
    name="decode_attention_partial", route="cuda",
    source="src/repro_torch/kernels/csrc/attention.cu",
    replaces="src/repro/kernels/flash_attention.py:192",
    max_abs_err=worst, bound_ms=bnd, bound_by=by,
    **timings(lambda: fa.decode_attention_partial(q, k_log, v_log, valid),
              lambda: ref.decode_partial_reference(q, k_log, v_log, valid)))
rec = records["decode_attention_partial"]
# the CUDA-core split in f32, at the same tolerance
q32, kl32, vl32 = q.float(), k_log.float(), v_log.float()
part32, variants32 = on_cuda_cores(
    "decode_attention_partial",
    lambda: fa.decode_attention_partial(q32, kl32, vl32, valid),
    "decode_attention_partial")
err32 = partial_err(part32, ref.decode_partial_reference(q32, kl32, vl32,
                                                         valid),
                    "decode_attention_partial f32")
print(f"[kernel] decode_attention_partial B={B} C={S} row 1 empty: "
      f"max_abs_err {worst:.3g} (<= 1e-3 + 1e-4|plain|); empty row m=-inf; "
      f"each row alone == its row in the batch bitwise; launches {variants} "
      f"(the tensor-core split); {rec['ms']:.4f} ms, bound {bnd:.6f} ms "
      f"({by}), plain {rec['plain_ms']:.4f} ms, device time "
      f"{show(rec['device_ms'])} ms; f32 copies on the CUDA-core split: "
      f"max_abs_err {err32:.3g}, launches {variants32}, "
      f"{time_ms(lambda: fa.decode_attention_partial(q32, kl32, vl32, valid)):.4f} ms",
      flush=True)
del k_gath, v_gath, q32, kl32, vl32, part32

# ssd_scan: one prompt of the mamba2_370m prefill at its full width, with
# the full-width draw of dt (softplus(N(0,1)) ~ 0.8) and A = -1 (A_log =
# 0), where a chunk's cumsum reaches ~-50: in bf16 (the model's dtype)
# and f32, a padded tail (dt = 0 past 300) and the init_state handoff
mcfg = get_config(MAMBA)
SH, SP, SN, SS = mcfg.n_ssm_heads, mcfg.ssm_head_dim, mcfg.ssm_state, 512


def ssd_inputs(dtype):
    x = randn(1, SS, SH, SP, dtype=dtype)
    dt = torch.nn.functional.softplus(torch.randn(1, SS, SH, generator=G,
                                                  device=DEV))
    return (x, dt, -torch.ones(SH, device=DEV),
            randn(1, SS, SN, dtype=dtype), randn(1, SS, SN, dtype=dtype))


def ssd_err(got, want, dtype):
    """Max abs error of (y, state); fails past the stated tolerance."""
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    worst = 0.0
    for g, w, rt in ((got[0], want[0], rtol), (got[1], want[1], 1e-3)):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), "ssd_scan: non-finite output")
        diff = (g - w).abs()
        check(bool((diff <= 1e-3 + rt * w.abs()).all()),
              f"ssd_scan: err {diff.max().item()} ({dtype})")
        worst = max(worst, diff.max().item())
    return worst


worst = 0.0
HALF = 233
kbuild.reset_launch_counts()
for dtype in (torch.bfloat16, torch.float32):
    sx, sdt, sA, sB, sC = ssd_inputs(dtype)
    got = kssd.ssd_scan(sx, sdt, sA, sB, sC)
    again = kssd.ssd_scan(sx, sdt, sA, sB, sC)
    torch.cuda.synchronize()
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          f"ssd_scan ({dtype}): not repeatable")
    worst = max(worst, ssd_err(got, ref.ssd_reference(sx, sdt, sA, sB, sC),
                               dtype))
    dt_pad = sdt.clone()
    dt_pad[:, 300:] = 0.0
    got = kssd.ssd_scan(sx, dt_pad, sA, sB, sC)
    want = ref.ssd_reference(*(t[:, :300].contiguous() for t in (sx, sdt)),
                             sA, *(t[:, :300].contiguous() for t in (sB, sC)))
    torch.cuda.synchronize()
    worst = max(worst, ssd_err((got[0][:, :300], got[1]), want, dtype))
    first = kssd.ssd_scan(*(t[:, :HALF].contiguous() for t in (sx, sdt)), sA,
                          *(t[:, :HALF].contiguous() for t in (sB, sC)))
    second = kssd.ssd_scan(*(t[:, HALF:].contiguous() for t in (sx, sdt)),
                           sA, *(t[:, HALF:].contiguous() for t in (sB, sC)),
                           init_state=first[1])
    torch.cuda.synchronize()
    worst = max(worst, ssd_err((torch.cat([first[0], second[0]], 1),
                                second[1]),
                               ref.ssd_reference(sx, sdt, sA, sB, sC), dtype))
    # B = 2 (this prompt and its reverse, a handed-in state on each row):
    # each row alone gives that row's bits
    x2, dt2, B2, C2 = (torch.cat([t, t.flip(1)]).contiguous()
                       for t in (sx, sdt, sB, sC))
    init2 = torch.cat([first[1], second[1]])
    both = kssd.ssd_scan(x2, dt2, sA, B2, C2, init_state=init2)
    rows_alone(lambda b: kssd.ssd_scan(
        *(t[b:b + 1].contiguous() for t in (x2, dt2)), sA,
        *(t[b:b + 1].contiguous() for t in (B2, C2)),
        init_state=init2[b:b + 1].contiguous()), both, f"ssd_scan ({dtype})")
    worst = max(worst, ssd_err(both, ref.ssd_reference(
        x2, dt2, sA, B2, C2, init_state=init2), dtype))
ssd_variants = routes("ssd_scan")
# per dtype: 2 scans, the padded one, the two halves, B = 2 and its 2 rows
check(ssd_variants == {"ssd_scan": 16, "ssd_scan_tc": 8},
      f"ssd_scan: launches {ssd_variants}: bf16 not on the tensor cores or "
      "f32 not on the CUDA cores")
del x2, dt2, B2, C2, init2, both
# timed and bounded in bf16, the main path's dtype
sx, sdt, sA, sB, sC = ssd_inputs(torch.bfloat16)
s_y, s_fin = kssd.ssd_scan(sx, sdt, sA, sB, sC)
bnd, by = kernel_bound("ssd_scan", sx, sdt, sA, sB, sC)
records["ssd_scan"] = dict(
    name="ssd_scan", route="cuda",
    source="src/repro_torch/kernels/csrc/ssd.cu",
    replaces="src/repro/kernels/ssd.py:74",
    max_abs_err=worst, bound_ms=bnd, bound_by=by,
    # no PyTorch call computes the SSD scan: no library call
    **timings(lambda: kssd.ssd_scan(sx, sdt, sA, sB, sC),
              lambda: ref.ssd_reference(sx, sdt, sA, sB, sC)))
rec = records["ssd_scan"]
ssd_f32 = ssd_inputs(torch.float32)
print(f"[kernel] ssd_scan S={SS} H={SH} P={SP} N={SN}, dt=softplus(N(0,1)), "
      f"A=-1, bf16 (tensor cores) and f32 (CUDA cores), dt=0 past 300, "
      f"init_state handoff at {HALF}, B=2 rows alone == rows in the batch "
      f"bitwise, repeats bitwise: max_abs_err {worst:.3g} (<= 1e-3 + rtol "
      f"|plain|); launches {ssd_variants}; {rec['ms']:.4f} ms, bound "
      f"{bnd:.6f} ms ({by}), plain {rec['plain_ms']:.4f} ms, device time "
      f"{show(rec['device_ms'])} ms (three kernels), the f32 CUDA-core "
      f"kernel's {show(device_ms(lambda: kssd.ssd_scan(*ssd_f32)))} ms",
      flush=True)
del ssd_f32

# decode_attention_fused[int8]: the fp row's shapes and data, on int8 pools
# from quantize_kv_pages (quantization is page-local, so the physical
# pool's quants and scales are the logical ones, permuted)
(k8_log, ks_log), (v8_log, vs_log) = (ref.quantize_kv_pages(t, PAGE)
                                      for t in (k_log, v_log))
(k8_pool, ks_pool), (v8_pool, vs_pool) = (ref.quantize_kv_pages(t, PAGE)
                                          for t in (k_pool, v_pool))
sc_log, sc_pool = (ks_log, vs_log), (ks_pool, vs_pool)
worst = 0.0
kbuild.reset_launch_counts()
for window in (0, 300):
    for ex in (None, extra):
        dense = fa.decode_attention_fused(q, k8_log, v8_log, pos, ex,
                                          window=window, kv_scales=sc_log)
        paged = fa.decode_attention_fused(q, k8_pool, v8_pool, pos, ex,
                                          window=window, blk_c=PAGE,
                                          pages=table, kv_scales=sc_pool)
        plain = ref.decode_fused_reference(q, k8_pool, v8_pool, pos, ex,
                                           window=window, pages=table,
                                           page_size=PAGE, kv_scales=sc_pool)
        torch.cuda.synchronize()
        err = (paged.float() - plain.float()).abs().max().item()
        check(torch.equal(paged, dense),
              f"decode_attention_fused[int8]: paged != dense (window {window})")
        check(err <= ATOL_BF16, f"decode_attention_fused[int8]: err {err} "
              f"(window {window}, extra {ex is not None})")
        worst = max(worst, err)
variants = routes("decode_attention_fused[int8]")
check(variants == {"decode_attention_fused[int8]": 8,
                   "decode_attention_fused[int8]_tc": 8},
      f"decode_attention_fused[int8]: launches {variants}, not the "
      "tensor-core split")
rows_alone(lambda b: fa.decode_attention_fused(
    *one_row(b, q, k8_pool, v8_pool, pos), one_row(b, *extra), window=300,
    blk_c=PAGE, pages=table[b:b + 1], kv_scales=one_row(b, *sc_pool)),
    paged, "decode_attention_fused[int8]")
valid_pages = int(((pos + PAGE) // PAGE).sum())      # pages holding slots
bnd, by = kernel_bound("decode_attention_fused", q, k8_pool, v8_pool, pos,
                       extra, table, sc_pool, blk_c=PAGE,
                       n_valid=valid_slots, n_pages=valid_pages)
records["decode_attention_fused[int8]"] = dict(
    name="decode_attention_fused[int8]", route="cuda",
    source="src/repro_torch/kernels/csrc/attention.cu",
    replaces="src/repro/kernels/flash_attention.py:252",
    max_abs_err=worst, bound_ms=bnd, bound_by=by,
    # no PyTorch call attends over int8 pages with scales: no library call
    **timings(lambda: fa.decode_attention_fused(
        q, k8_pool, v8_pool, pos, extra, blk_c=PAGE, pages=table,
        kv_scales=sc_pool),
        lambda: ref.decode_fused_reference(
            q, k8_pool, v8_pool, pos, extra, pages=table, page_size=PAGE,
            kv_scales=sc_pool)))
rec = records["decode_attention_fused[int8]"]
# f32 q over the same int8 pools takes the CUDA-core split
out, variants32 = on_cuda_cores(
    "decode_attention_fused[int8]",
    lambda: fa.decode_attention_fused(q.float(), k8_pool, v8_pool, pos,
                                      extra, window=300, blk_c=PAGE,
                                      pages=table, kv_scales=sc_pool),
    "decode_attention_fused[int8]")
err32 = f32_err(out, ref.decode_fused_reference(
    q.float(), k8_pool, v8_pool, pos, extra, window=300, pages=table,
    page_size=PAGE, kv_scales=sc_pool), "decode_attention_fused[int8]")
print(f"[kernel] decode_attention_fused[int8] B={B} H={H} KH={KH} hd={HD} "
      f"S={S} page={PAGE} permuted table, pos={pos.tolist()}, window 0 and "
      f"300, extra on/off, pools from quantize_kv_pages: max_abs_err "
      f"{worst:.3g} <= {ATOL_BF16}; paged == dense bitwise; each row alone "
      f"== its row in the batch bitwise; launches {variants} (the "
      f"tensor-core split); {rec['ms']:.4f} ms, bound {bnd:.6f} ms ({by}), "
      f"plain {rec['plain_ms']:.4f} ms, device time {show(rec['device_ms'])} "
      f"ms; f32 q on the CUDA-core split: max_abs_err {err32:.3g} <= 1e-5, "
      f"launches {variants32}", flush=True)
del k8_log, v8_log, k8_pool, v8_pool, out

# decode_attention_fused_partial: the mesh decode's producer, the fused
# route with a raw-statistics epilogue, at starcoder2_3b's widths (H 24 on
# KH 2) and mistral_nemo_12b's (H 32 on KH 8), S 2048 in pages of 128
# through a permuted table, ragged pos, extra, window 0 and 300, over bf16
# and int8 pools.  Its statistics within partial_err's limit of the plain
# version; normalised, the fused decode's bits; and n head groups'
# statistics concatenated and normalised, the fused decode's bits too, at
# n = 2 and 4 where the split aligns with the GQA groups (n | KH, or KH ==
# 1 and n | H).  The record is timed at the [mesh] serve's shape on a rank
# of 1x2: starcoder2_3b's head group of 12 heads on 1 KV head
PS = 2048
fp_worst, fp_groups = 0.0, []
kbuild.reset_launch_counts()
for h_, kh_ in ((H, KH), (32, 8)):
    qx = randn(B, 1, h_, HD)
    kx, vx = randn(B, kh_, PS, HD), randn(B, kh_, PS, HD)
    tbl = torch.stack([torch.randperm(PS // PAGE, generator=G, device=DEV)
                       for _ in range(B)]).to(torch.int32)
    posx = torch.tensor([0, 700, 1500, PS - 1], dtype=torch.int32,
                        device=DEV)
    ex = (torch.randn(B, h_, HD, generator=G, device=DEV),
          torch.randn(B, h_, generator=G, device=DEV),
          torch.rand(B, h_, generator=G, device=DEV) + 0.5)
    (k8x, ksx), (v8x, vsx) = (ref.quantize_kv_pages(t, PAGE)
                              for t in (kx, vx))
    for kv_name, kk, vv, sc in (("bf16", kx, vx, None),
                                ("int8", k8x, v8x, (ksx, vsx))):
        for window in (0, 300):
            what = (f"decode_attention_fused_partial H={h_} KH={kh_} "
                    f"{kv_name} window {window}")
            full = fa.decode_attention_fused(qx, kk, vv, posx, ex,
                                             window=window, blk_c=PAGE,
                                             pages=tbl, kv_scales=sc)
            raw = fa.decode_attention_fused_partial(
                qx, kk, vv, posx, ex, window=window, blk_c=PAGE, pages=tbl,
                kv_scales=sc)
            fp_worst = max(fp_worst, partial_err(
                raw, ref.decode_fused_partial_reference(
                    qx, kk, vv, posx, ex, window=window, pages=tbl,
                    page_size=PAGE, kv_scales=sc), what, empty=None))
            check(torch.equal(ref.normalize_fused_partial(
                raw[0], raw[2], qx.dtype), full),
                f"{what}: normalised != decode_attention_fused")
            for n in (2, 4):
                if not (kh_ % n == 0 or (kh_ == 1 and h_ % n == 0)):
                    continue
                hl, khl = h_ // n, kh_ // n
                accs, ls = [], []
                for r in range(n):
                    hs, kvs = slice(r * hl, (r + 1) * hl), \
                        slice(r * khl, (r + 1) * khl)
                    acc, _, l = fa.decode_attention_fused_partial(
                        qx[:, :, hs].contiguous(), kk[:, kvs].contiguous(),
                        vv[:, kvs].contiguous(), posx,
                        tuple(t[:, hs].contiguous() for t in ex),
                        window=window, blk_c=PAGE, pages=tbl,
                        kv_scales=None if sc is None else tuple(
                            t[:, kvs].contiguous() for t in sc))
                    accs.append(acc)
                    ls.append(l)
                check(torch.equal(ref.normalize_fused_partial(
                    torch.cat(accs, 1), torch.cat(ls, 1), qx.dtype), full),
                    f"{what}: {n} head groups != decode_attention_fused")
                fp_groups.append(f"H{h_}/KH{kh_} n={n}")
fp_variants = routes("decode_attention_fused_partial",
                     "decode_attention_fused_partial[int8]")
check(all(fp_variants[k] == fp_variants[k + "_tc"] > 0
          for k in ("decode_attention_fused_partial",
                    "decode_attention_fused_partial[int8]")),
      f"decode_attention_fused_partial: launches {fp_variants}, not the "
      "tensor-core split")
# the record: a 1x2 rank's call in the [mesh] serve (one head group)
q_g = randn(B, 1, H // 2, HD)
k_g, v_g = randn(B, 1, PS, HD), randn(B, 1, PS, HD)
ex_g = (torch.randn(B, H // 2, HD, generator=G, device=DEV),
        torch.randn(B, H // 2, generator=G, device=DEV),
        torch.rand(B, H // 2, generator=G, device=DEV) + 0.5)
fp_slots = int((posx + 1).sum())
bnd, by = kernel_bound("decode_attention_fused_partial", q_g, k_g, v_g, posx,
                       ex_g, tbl, blk_c=PAGE, n_valid=fp_slots)
records["decode_attention_fused_partial"] = dict(
    name="decode_attention_fused_partial", route="cuda",
    source="src/repro_torch/kernels/csrc/attention.cu",
    replaces="src/repro/kernels/ops.py:86 (flash_attention.py:213 on the "
             "TPU)",
    max_abs_err=fp_worst, bound_ms=bnd, bound_by=by,
    # no single PyTorch call returns the raw (acc, m, l)
    **timings(lambda: fa.decode_attention_fused_partial(
        q_g, k_g, v_g, posx, ex_g, blk_c=PAGE, pages=tbl),
        lambda: ref.decode_fused_partial_reference(
            q_g, k_g, v_g, posx, ex_g, pages=tbl, page_size=PAGE)))
rec = records["decode_attention_fused_partial"]
print(f"[kernel] decode_attention_fused_partial B={B} S={PS} page={PAGE} "
      f"permuted table, pos={posx.tolist()}, extra, window 0 and 300, bf16 "
      f"and int8 pools, at H={H}/KH={KH} and H=32/KH=8: raw (acc, m, l) "
      f"max_abs_err {fp_worst:.3g} (<= 1e-3 + 1e-4|plain|); normalised == "
      f"decode_attention_fused bitwise; head groups concatenated and "
      f"normalised == decode_attention_fused bitwise at "
      f"{', '.join(sorted(set(fp_groups)))}; launches {fp_variants} (the "
      f"tensor-core split); a 1x2 rank's call (H={H // 2} KH=1, bf16): "
      f"time_ms {rec['ms']:.4f} ms, device_ms {show(rec['device_ms'])} ms, "
      f"byte bound {bnd:.6f} ms ({by}), plain {rec['plain_ms']:.4f} ms; "
      f"library: none (no single call returns (acc, m, l)); {SMI_LINE}",
      flush=True)
del qx, kx, vx, k8x, v8x, q_g, k_g, v_g, full, raw

# --------------------------------------------------------------------------
# 3a. the attention kernels at the other archs' head dims: gemma3_12b's 256
# (16 heads on 8 KV heads) and opt_2_7b's 80 (MHA, 32 heads) under
# gemma3's window (1024 in the prefill, 1023 cached slots plus the current
# token in the decode), and granite_moe_3b's 64 (24 heads on 8 KV heads)
# with none, all on the tensor-core kernels in bf16 and on the CUDA-core
# ones in f32
# --------------------------------------------------------------------------

phase("3a")

W_S, W_PAGE, W_WIN = 2048, 128, 1024
W_POS = [300, 1023, 1024, 2047]


def to_pool(t, table, page):
    """The physical pool holding logical (B, KH, S, hd) rows under the
    page table."""
    pool = torch.empty_like(t)
    for b in range(t.shape[0]):
        for j in range(table.shape[1]):
            p = int(table[b, j])
            pool[b, :, p * page:(p + 1) * page] = \
                t[b, :, j * page:(j + 1) * page]
    return pool


def sdpa_backend(fn):
    """The SDPA backend a call ran on, named by its longest kernel under
    torch.profiler: (backend, that kernel's name)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e.self_device_time_total, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if not ev:
        return "not measured", ""
    top = ev[-1][1]
    low = top.lower()
    backend = ("cudnn" if "cudnn" in low
               else "flash" if "flash" in low
               else "efficient" if "fmha" in low or "memeff" in low
               else "math")
    return backend, top[:60]


def attention_at(label, h, kh, hd, served, window=W_WIN, s=W_S, pos=W_POS,
                 full=True):
    """flash_attention, decode_attention_fused (bf16 and int8 pools) and
    decode_attention_partial at head dim `hd`, H = h, KH = kh: each held
    to its plain version within the hd 128 rows' tolerances, on the route
    `flash_route` / `decode_route` names for bf16, timed beside its bound
    and SDPA with an explicit boolean mask, and again on f32 copies of the
    same inputs, which take the CUDA-core kernels.  `window` is the
    prefill's (W - 1 cached slots in the decode; 0: causal, no window);
    `s` the prompt and the cache's length, `pos` the decode rows' last
    slots.  Returns the records ("flash", "fused", "int8", "partial", and
    "partial32": the partial timed on the f32 copies, the route of `rp`
    over an int8 cache); with `full` False only "flash" and "fused".
    `served` names those a serve of this script takes (their launches come
    from it, below)."""
    tag = f"[hd{hd}]" if s == W_S else f"[hd{hd}s{s}]"
    tc_flash = fa.flash_route(torch.bfloat16, hd) == "tensor_core"
    tc_dec = fa.decode_route(torch.bfloat16, hd, h // kh) == "tensor_core"
    route = "tensor-core" if tc_flash else "CUDA-core"
    droute = "tensor-core" if tc_dec else "CUDA-core"

    def serving(key):
        return ("served in [archs] / [moe]" if key in served
                else "not on a serve path of this script")

    wtext = f"window {window}" if window else "no window"

    out = {}
    # flash: one s-token prompt, causal, under the window
    qf, kf, vf = (randn(1, s, n, hd) for n in (h, kh, kh))
    kbuild.reset_launch_counts()
    got = fa.flash_attention(qf, kf, vf, causal=True, window=window)
    variants = routes("flash_attention")
    plain = ref.mha_reference(qf, kf, vf, causal=True, window=window)
    torch.cuda.synchronize()
    err = (got.float() - plain.float()).abs().max().item()
    check(err <= ATOL_BF16, f"flash_attention{tag}: err {err}")
    check(variants == {"flash_attention": 1,
                       "flash_attention_tc": int(tc_flash)},
          f"flash_attention{tag}: launches {variants}, not the {route} "
          "kernel")
    qi = torch.arange(s, device=DEV)
    mask = (qi[None, :] <= qi[:, None]) & (
        (qi[None, :] > qi[:, None] - window) | (window == 0))
    pairs = int(mask.sum())
    bnd, by = kernel_bound("flash_attention", qf, kf, vf, causal=True,
                           window=window)
    check(kcost.attention_pairs(s, s, True, window) == pairs,
          f"flash_attention{tag}: the formula's pairs != the mask's")

    def sdpa_prefill():
        return torch.nn.functional.scaled_dot_product_attention(
            qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    rec = out["flash"] = dict(
        name=f"flash_attention{tag}", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        **timings(lambda: fa.flash_attention(qf, kf, vf, causal=True,
                                             window=window),
                  lambda: ref.mha_reference(qf, kf, vf, causal=True,
                                            window=window),
                  sdpa_prefill))
    backend = sdpa_backend(sdpa_prefill)
    q32, k32, v32 = qf.float(), kf.float(), vf.float()
    got32, var32 = on_cuda_cores(
        f"flash_attention{tag}",
        lambda: fa.flash_attention(q32, k32, v32, causal=True, window=window),
        "flash_attention")
    err32 = f32_err(got32, ref.mha_reference(q32, k32, v32, causal=True,
                                             window=window),
                    f"flash_attention{tag}")
    dev32 = device_ms(lambda: fa.flash_attention(q32, k32, v32, causal=True,
                                                 window=window))
    del q32, k32, v32, got32
    print(f"[kernel] flash_attention{tag} {label}: B=1 S={s} H={h} KH={kh} "
          f"hd={hd} causal, {wtext}: max_abs_err {err:.3g} <= "
          f"{ATOL_BF16}; launches {variants} (the {route} kernel); "
          f"{rec['ms']:.4f} ms, bound {bnd:.5f} ms ({by}), plain "
          f"{rec['plain_ms']:.4f} ms, SDPA with the boolean mask "
          f"{rec['library_ms']:.4f} ms; device {show(rec['device_ms'])} ms "
          f"= {show(div(4 * pairs * h * hd / 1e9, rec['device_ms']), '.1f')} "
          f"TFLOP/s, SDPA's {show(rec['library_device_ms'])} ms on its "
          f"{backend[0]} backend ({backend[1]}): "
          f"{show(div(rec['device_ms'], rec['library_device_ms']), '.2f')}x "
          f"it; f32 copies on the CUDA-core kernel: max_abs_err {err32:.3g} "
          f"<= 1e-5, launches {var32}, device {show(dev32)} ms", flush=True)
    del qf, kf, vf, got, plain, mask

    # decode: 4 rows at `pos` over an s-slot cache in pages of W_PAGE under
    # a permuted table, extra merged, window - 1 cached slots (a local
    # layer's), or all of them
    win = max(0, window - 1)
    q = randn(B, 1, h, hd)
    k_log, v_log = randn(B, kh, s, hd), randn(B, kh, s, hd)
    table = torch.stack([torch.randperm(s // W_PAGE, generator=G,
                                        device=DEV)
                         for _ in range(B)]).to(torch.int32)
    k_pool, v_pool = to_pool(k_log, table, W_PAGE), to_pool(v_log, table,
                                                            W_PAGE)
    pos_w = torch.tensor(pos, dtype=torch.int32, device=DEV)
    ex = (torch.randn(B, h, hd, generator=G, device=DEV),
          torch.randn(B, h, generator=G, device=DEV),
          torch.rand(B, h, generator=G, device=DEV) + 0.5)
    valid = ref.decode_valid_mask(pos_w, s, win)
    n_valid = int(valid.sum())
    kbuild.reset_launch_counts()
    dense = fa.decode_attention_fused(q, k_log, v_log, pos_w, ex, window=win,
                                      blk_c=W_PAGE)
    paged = fa.decode_attention_fused(q, k_pool, v_pool, pos_w, ex,
                                      window=win, blk_c=W_PAGE, pages=table)
    variants = routes("decode_attention_fused")
    plain = ref.decode_fused_reference(q, k_pool, v_pool, pos_w, ex,
                                       window=win, pages=table,
                                       page_size=W_PAGE)
    torch.cuda.synchronize()
    err = (paged.float() - plain.float()).abs().max().item()
    check(torch.equal(paged, dense),
          f"decode_attention_fused{tag}: paged != dense")
    check(err <= ATOL_BF16, f"decode_attention_fused{tag}: err {err}")
    check(variants == {"decode_attention_fused": 2,
                       "decode_attention_fused_tc": 2 * int(tc_dec)},
          f"decode_attention_fused{tag}: launches {variants}, not the "
          f"{droute} split")
    rows_alone(lambda b: fa.decode_attention_fused(
        *one_row(b, q, k_pool, v_pool, pos_w), one_row(b, *ex), window=win,
        blk_c=W_PAGE, pages=table[b:b + 1]), paged,
        f"decode_attention_fused{tag}")
    bnd, by = kernel_bound("decode_attention_fused", q, k_pool, v_pool,
                           pos_w, ex, table, blk_c=W_PAGE, n_valid=n_valid)
    k_gath = ref.gather_kv_pages(k_pool, table, W_PAGE)
    v_gath = ref.gather_kv_pages(v_pool, table, W_PAGE)

    def sdpa_decode():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k_gath, v_gath, attn_mask=valid[:, None, None],
            enable_gqa=True)

    rec = out["fused"] = dict(
        name=f"decode_attention_fused{tag}", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/flash_attention.py:313",
        max_abs_err=err, bound_ms=bnd, bound_by=by,
        **timings(lambda: fa.decode_attention_fused(
            q, k_pool, v_pool, pos_w, ex, window=win, blk_c=W_PAGE,
            pages=table),
            lambda: ref.decode_fused_reference(
                q, k_pool, v_pool, pos_w, ex, window=win, pages=table,
                page_size=W_PAGE),
            sdpa_decode))
    backend = sdpa_backend(sdpa_decode)
    split, n_split = fa.decode_split(s, W_PAGE, hd)
    fused_parts = split_parts(lambda: fa.decode_attention_fused(
        q, k_pool, v_pool, pos_w, ex, window=win, blk_c=W_PAGE, pages=table),
        split, n_split)
    q32, kl32, vl32, kp32, vp32 = (t.float() for t in (q, k_log, v_log,
                                                       k_pool, v_pool))
    (out32, dense32), var32 = on_cuda_cores(
        f"decode_attention_fused{tag}",
        lambda: (fa.decode_attention_fused(q32, kp32, vp32, pos_w, ex,
                                           window=win, blk_c=W_PAGE,
                                           pages=table),
                 fa.decode_attention_fused(q32, kl32, vl32, pos_w, ex,
                                           window=win, blk_c=W_PAGE)),
        "decode_attention_fused", calls=2)
    err32 = f32_err(out32, ref.decode_fused_reference(
        q32, kp32, vp32, pos_w, ex, window=win, pages=table,
        page_size=W_PAGE), f"decode_attention_fused{tag}")
    check(torch.equal(out32, dense32),
          f"decode_attention_fused{tag} f32: paged != dense")
    del q32, kl32, vl32, kp32, vp32, out32, dense32
    print(f"[kernel] decode_attention_fused{tag} {label}: B={B} H={h} KH={kh} "
          f"hd={hd} S={s} page={W_PAGE} permuted table, pos={pos}, "
          f"window {win}, extra: max_abs_err {err:.3g} <= {ATOL_BF16}; "
          f"paged == dense bitwise; each row alone == its row in the batch "
          f"bitwise; launches {variants} ({n_split} splits of {split} rows, "
          f"the {droute} split); {rec['ms']:.4f} ms, bound {bnd:.6f} ms "
          f"({by}), plain {rec['plain_ms']:.4f} ms, SDPA on the gathered "
          f"cache with the boolean window mask (without extra) "
          f"{rec['library_ms']:.4f} ms; device {show(rec['device_ms'])} ms, "
          f"SDPA's {show(rec['library_device_ms'])} ms on its {backend[0]} "
          f"backend ({backend[1]}): "
          f"{show(div(rec['device_ms'], rec['library_device_ms']), '.2f')}x "
          f"it; {fused_parts}; f32 copies on the CUDA-core split: "
          f"max_abs_err {err32:.3g} <= 1e-5, paged == dense bitwise, "
          f"launches {var32}", flush=True)
    if not full:
        return out

    # int8 pools of the same data (quantization is page-local: the
    # physical pool's quants and scales are the logical ones, permuted)
    (k8l, ksl), (v8l, vsl) = (ref.quantize_kv_pages(t, W_PAGE)
                              for t in (k_log, v_log))
    (k8p, ksp), (v8p, vsp) = (ref.quantize_kv_pages(t, W_PAGE)
                              for t in (k_pool, v_pool))
    kbuild.reset_launch_counts()
    dense8 = fa.decode_attention_fused(q, k8l, v8l, pos_w, ex, window=win,
                                       kv_scales=(ksl, vsl))
    paged8 = fa.decode_attention_fused(q, k8p, v8p, pos_w, ex, window=win,
                                       blk_c=W_PAGE, pages=table,
                                       kv_scales=(ksp, vsp))
    variants8 = routes("decode_attention_fused[int8]")
    plain8 = ref.decode_fused_reference(q, k8p, v8p, pos_w, ex, window=win,
                                        pages=table, page_size=W_PAGE,
                                        kv_scales=(ksp, vsp))
    torch.cuda.synchronize()
    err8 = (paged8.float() - plain8.float()).abs().max().item()
    check(torch.equal(paged8, dense8),
          f"decode_attention_fused[int8]{tag}: paged != dense")
    check(err8 <= ATOL_BF16, f"decode_attention_fused[int8]{tag}: err {err8}")
    check(variants8 == {"decode_attention_fused[int8]": 2,
                        "decode_attention_fused[int8]_tc": 2 * int(tc_dec)},
          f"decode_attention_fused[int8]{tag}: launches {variants8}")
    rows_alone(lambda b: fa.decode_attention_fused(
        *one_row(b, q, k8p, v8p, pos_w), one_row(b, *ex), window=win,
        blk_c=W_PAGE, pages=table[b:b + 1],
        kv_scales=one_row(b, ksp, vsp)), paged8,
        f"decode_attention_fused[int8]{tag}")
    n_pages = int(((valid.reshape(B, -1, W_PAGE)).any(-1)).sum())
    bnd8, by8 = kernel_bound("decode_attention_fused", q, k8p, v8p, pos_w,
                             ex, table, (ksp, vsp), blk_c=W_PAGE,
                             n_valid=n_valid, n_pages=n_pages)
    rec8 = out["int8"] = dict(
        name=f"decode_attention_fused[int8]{tag}", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/flash_attention.py:252",
        max_abs_err=err8, bound_ms=bnd8, bound_by=by8,
        **timings(lambda: fa.decode_attention_fused(
            q, k8p, v8p, pos_w, ex, window=win, blk_c=W_PAGE, pages=table,
            kv_scales=(ksp, vsp)),
            lambda: ref.decode_fused_reference(
                q, k8p, v8p, pos_w, ex, window=win, pages=table,
                page_size=W_PAGE, kv_scales=(ksp, vsp))))
    int8_parts = split_parts(lambda: fa.decode_attention_fused(
        q, k8p, v8p, pos_w, ex, window=win, blk_c=W_PAGE, pages=table,
        kv_scales=(ksp, vsp)), split, n_split)
    q32 = q.float()
    got32, var32 = on_cuda_cores(
        f"decode_attention_fused[int8]{tag}",
        lambda: fa.decode_attention_fused(q32, k8p, v8p, pos_w, ex,
                                          window=win, blk_c=W_PAGE,
                                          pages=table, kv_scales=(ksp, vsp)),
        "decode_attention_fused[int8]")
    err32 = f32_err(got32, ref.decode_fused_reference(
        q32, k8p, v8p, pos_w, ex, window=win, pages=table, page_size=W_PAGE,
        kv_scales=(ksp, vsp)), f"decode_attention_fused[int8]{tag}")
    print(f"[kernel] decode_attention_fused[int8]{tag} {label}, the same "
          f"shapes and window on int8 pools from quantize_kv_pages: "
          f"max_abs_err {err8:.3g} <= {ATOL_BF16}; paged == dense bitwise; "
          f"each row alone == its row in the batch bitwise; launches "
          f"{variants8} (the {droute} split); {rec8['ms']:.4f} ms, bound "
          f"{bnd8:.6f} ms ({by8}), plain {rec8['plain_ms']:.4f} ms, device "
          f"{show(rec8['device_ms'])} ms ({int8_parts}); no library call "
          f"(int8 pages with scales); f32 q on the CUDA-core split: "
          f"max_abs_err {err32:.3g} <= 1e-5, launches {var32}; "
          f"{serving('int8')}", flush=True)

    # partial: one chunk over the cache, the window's mask, row 1 empty
    pvalid = valid.clone()
    pvalid[1] = False
    n_pvalid = int(pvalid.sum())
    kbuild.reset_launch_counts()
    part = fa.decode_attention_partial(q, k_log, v_log, pvalid)
    variantsp = routes("decode_attention_partial")
    torch.cuda.synchronize()
    errp = partial_err(part, ref.decode_partial_reference(q, k_log, v_log,
                                                          pvalid),
                       f"decode_attention_partial{tag}")
    check(variantsp == {"decode_attention_partial": 1,
                        "decode_attention_partial_tc": int(tc_dec)},
          f"decode_attention_partial{tag}: launches {variantsp}")
    rows_alone(lambda b: fa.decode_attention_partial(
        *one_row(b, q, k_log, v_log, pvalid)), part,
        f"decode_attention_partial{tag}")
    bndp, byp = kernel_bound("decode_attention_partial", q, k_log, v_log,
                             pvalid, n_valid=n_pvalid)
    recp = out["partial"] = dict(
        name=f"decode_attention_partial{tag}", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/flash_attention.py:192",
        max_abs_err=errp, bound_ms=bndp, bound_by=byp,
        **timings(lambda: fa.decode_attention_partial(q, k_log, v_log,
                                                      pvalid),
                  lambda: ref.decode_partial_reference(q, k_log, v_log,
                                                       pvalid)))
    part_parts = split_parts(
        lambda: fa.decode_attention_partial(q, k_log, v_log, pvalid),
        *fa.decode_split(s, fa.PARTIAL_CHUNK, hd))
    kl32, vl32 = k_log.float(), v_log.float()
    got32, var32 = on_cuda_cores(
        f"decode_attention_partial{tag}",
        lambda: fa.decode_attention_partial(q32, kl32, vl32, pvalid),
        "decode_attention_partial")
    err32 = partial_err(got32, ref.decode_partial_reference(
        q32, kl32, vl32, pvalid), f"decode_attention_partial{tag} f32")
    bnd32, by32 = kernel_bound("decode_attention_partial", q32, kl32, vl32,
                               pvalid, n_valid=n_pvalid,
                               flops_per_s=F32_FLOPS_PER_S)
    rec32 = out["partial32"] = dict(
        name=f"decode_attention_partial{tag}[f32]", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/flash_attention.py:192",
        max_abs_err=err32, bound_ms=bnd32, bound_by=by32,
        **timings(lambda: fa.decode_attention_partial(q32, kl32, vl32,
                                                      pvalid),
                  lambda: ref.decode_partial_reference(q32, kl32, vl32,
                                                       pvalid)))
    del q32, kl32, vl32, got32
    print(f"[kernel] decode_attention_partial{tag} {label}: B={B} C={s}, "
          f"the window's mask, row 1 empty: max_abs_err {errp:.3g} (<= 1e-3 "
          f"+ 1e-4|plain|); empty row m=-inf; each row alone == its row in "
          f"the batch bitwise; launches {variantsp} (the {droute} split); "
          f"{recp['ms']:.4f} ms, bound {bndp:.6f} ms ({byp}), plain "
          f"{recp['plain_ms']:.4f} ms, device {show(recp['device_ms'])} ms "
          f"({part_parts}); no library call; f32 copies on the CUDA-core "
          f"split: max_abs_err {err32:.3g}, launches {var32}, "
          f"{rec32['ms']:.4f} ms, bound {bnd32:.6f} ms ({by32}, f32), plain "
          f"{rec32['plain_ms']:.4f} ms, device {show(rec32['device_ms'])} ms "
          f"({serving('partial32')}); {serving('partial')}", flush=True)
    return out


# the records a serve of this script takes at each head dim: gemma3_12b,
# opt_2_7b and granite_moe_3b (hd 64, full causal layers: no window) serve
# fp axle, rp and an int8 KV cache; gemma3_12b also rp over an int8 cache
# (the f32 partial) and prompts past 2,048 positions at max_seq 4096 (its
# global layers: no window, 64 splits a decode row)
g3cfg, optcfg = get_config("gemma3_12b"), get_config("opt_2_7b")
gcfg = get_config("granite_moe_3b")
ALL4 = ("flash", "fused", "int8", "partial")
G3_S4K = 4096
for arch_cfg, served, window, s_kw in (
        (g3cfg, ALL4 + ("partial32",), W_WIN, {}),
        (g3cfg, ("flash", "fused"), 0,
         dict(s=G3_S4K, pos=[2040, 2048, 3500, 4095], full=False)),
        (optcfg, ALL4, W_WIN, {}), (gcfg, ALL4, 0, {})):
    recs = attention_at(arch_cfg.arch_id, arch_cfg.n_heads,
                        arch_cfg.n_kv_heads, arch_cfg.head_dim_, served,
                        window, **s_kw)
    for key in served:
        records[recs[key]["name"]] = recs[key]


# rp (the chunked schedule) against bs (the fused one) on the same paged
# inputs and the current token's partial: with one chunk the partial runs
# the fused route's splits (the same plan and tile arithmetic) and torch
# merges the chunk with the current token's partial as the fused epilogue
# does, each product rounded: bitwise equal.  With more chunks each chunk
# is merged under its own maximum first (exp(m_j - m_c) exp(m_c - m) is
# not exp(m_j - m) in f32) and a chunk shorter than a split is a tile of
# its own: not held bitwise, printed
def rp_against_bs(label, arch_cfg, s, window, n_chunks):
    h, kh, hd = arch_cfg.n_heads, arch_cfg.n_kv_heads, arch_cfg.head_dim_
    page = min(W_PAGE, s)
    q = randn(B, 1, h, hd)
    k_log, v_log = randn(B, kh, s, hd), randn(B, kh, s, hd)
    table = torch.stack([torch.randperm(s // page, generator=G, device=DEV)
                         for _ in range(B)]).to(torch.int32)
    k_pool, v_pool = to_pool(k_log, table, page), to_pool(v_log, table, page)
    pos_r = torch.tensor([s // 8, s // 2 - 1, s // 2, s - 2],
                         dtype=torch.int32, device=DEV)
    # rows 0 and 2: the current token's key along its group's mean query,
    # so that its score (~8) holds the row's maximum, where the fused
    # epilogue rescales the cache's sum (exp(m - m_e) < 1); rows 1 and 3:
    # a random key, the cache holding the maximum
    k_new = randn(B, 1, kh, hd)
    g = h // kh
    k_new[0::2, 0] = (q[0::2, 0].float().reshape(-1, kh, g, hd).mean(2)
                      * (8 * g / hd ** 0.5)).to(k_new.dtype)
    ex = layers.single_kv_partial(q, k_new, randn(B, 1, kh, hd))
    out = {}
    for proto in (OffloadProtocol.BS, OffloadProtocol.RP):
        with use_offload(OffloadConfig(protocol=proto,
                                       chunks_per_shard=n_chunks)):
            out[proto] = decode_attention_combined(
                q, k_pool, v_pool, pos_r, window=window, extra=ex,
                pages=table)
    a, b = out[OffloadProtocol.BS], out[OffloadProtocol.RP]
    same = int((a.view(torch.int16) == b.view(torch.int16)).sum())
    apart = (a.float() - b.float()).abs().max().item()
    if n_chunks == 1:
        check(torch.equal(a, b), f"[kernel] rp vs bs {label}: one chunk, "
              f"{a.numel() - same} of {a.numel()} outputs apart (by {apart})")
    print(f"[kernel] rp vs bs {label} (H {h}, KH {kh}, hd {hd}, S {s}, page "
          f"{page}, window {window}, {n_chunks} chunk(s)): {same} of "
          f"{a.numel()} bf16 outputs bitwise equal, max |diff| {apart:.3g}"
          f"{' (held bitwise)' if n_chunks == 1 else ' (not held)'}",
          flush=True)


for label, arch_cfg, s_rp, window, chunks in (
        ("gemma3_12b local", g3cfg, W_S, W_WIN - 1, (1, 4)),
        ("gemma3_12b global", g3cfg, W_S, 0, (1,)),
        (ARCH, cfg, S, 0, (1,)),
        ("mistral_nemo_12b (serve_offload)",
         get_config("mistral_nemo_12b"), 128, 0, (4, 1))):
    for n_chunks in chunks:
        rp_against_bs(label, arch_cfg, s_rp, window, n_chunks)


def quant_err(got, x, qt):
    """Max |kernel - plain|; fails past 1e-5 (|x| @ |W|), plus one bf16
    unit of the plain value for a bf16 output."""
    want = ref.quant_matmul_reference(x, qt).float()
    tol = 1e-5 * (x.float().abs() @ kquant.dequantize_tensor(qt).abs())
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(want)
        tol += torch.ldexp(torch.ones_like(want), e - 8)
    diff = (got.float() - want).abs()
    check(bool(torch.isfinite(got.float()).all()), "quant_matmul: non-finite")
    check(bool((diff <= tol).all()),
          f"quant_matmul[{qt.fmt}] {tuple(x.shape)} {x.dtype}: err "
          f"{diff.max().item()} past its tolerance by "
          f"{(diff - tol).max().item()}")
    return diff.max().item()


# quant_matmul: the main path's products, bf16 x against weights drawn at
# the model's init scale (fan-in^-0.5) and quantized: decode (m = 4 slots,
# the skinny kernel) against w_gate and w_down, prefill (m = 512, the
# tensor-core kernel) against w_gate.  The records are the decode w_gate
# product (`quant_matmul[<fmt>]`) and the prefill one
# (`quant_matmul[<fmt>]_tc`); the line prints all three, with the
# yardstick torch.matmul(x, W) on the weight dequantized to bf16 before
# the timing (not a port of the product, not gated).  The prefill shape is
# also held in f32 (f32 copies of x), which takes the CUDA-core tiled
# kernel.
# The decode products run the skinny kernel in one launch (no split-K
# pass); their device time is taken cold, the calls rotating over copies
# of the weight that together exceed the 50 MB L2 (a served layer's weight
# is not in L2 when its turn comes), with the warm reading (20 calls on one
# copy) beside it.  wq and wk show the floor of a launch: the device time
# of a one-block fill kernel is printed with them.
QSHAPES = (("decode w_gate", 4, cfg.d_model, cfg.d_ff),
           ("decode w_down", 4, cfg.d_ff, cfg.d_model),
           ("decode wq", 4, cfg.d_model, cfg.n_heads * HD),
           ("decode wk", 4, cfg.d_model, KH * HD),
           ("prefill w_gate", 512, cfg.d_model, cfg.d_ff))
L2_BYTES = 50 << 20


def cold_copies(qt):
    """Copies of a quantized weight, as many as it takes for 3 x the L2 to
    pass between two uses of one copy when the calls rotate over them."""
    return [kquant.QTensor(qt.scales.clone(), qt.quants.clone(),
                           None if qt.mins is None else qt.mins.clone(),
                           qt.fmt, qt.d_in)
            for _ in range(max(2, -(-3 * L2_BYTES // qt.nbytes) + 1))]


def skinny_cuda_core(x, qt):
    """The CUDA-core skinny kernel on bf16 inputs that the serve sends to
    the tensor-core one: the A/B of the decode route's two kernels, a
    comparison launch that no counter sees."""
    m, d = x.shape
    nb, n = qt.scales.shape
    out = torch.empty((m, n), dtype=x.dtype, device=DEV)
    tile, splits, per, ks = kquant.skinny_plan(n, nb)
    err = kquant.function("rt_quant_skinny", kquant._SKINNY_SIGNATURE)(
        kbuild.DTYPE_CODE[x.dtype], kquant.FMT_CODE[qt.fmt], x.data_ptr(),
        qt.quants.data_ptr(), qt.scales.data_ptr(),
        None if qt.mins is None else qt.mins.data_ptr(), out.data_ptr(), m,
        d, n, nb, tile, splits, per, ks, 1, 0, kbuild.stream())
    kbuild.raise_on(err, "skinny_kernel")
    return out


fill = torch.empty((4, KH * HD), dtype=torch.bfloat16, device=DEV)
floor_ms = device_ms(lambda: fill.zero_())
del fill
for fmt in kquant.WEIGHT_FORMATS:
    parts, worst = [], 0.0
    name = f"quant_matmul[{fmt}]"
    for label, m, d, n in QSHAPES:
        qt = kquant.quantize_tensor(randn(d, n) * d ** -0.5, fmt)
        x = randn(m, d)
        kbuild.reset_launch_counts()
        got = kquant.quant_matmul(x, qt)
        again = kquant.quant_matmul(x, qt)
        variants = routes(name)
        one_launch = {k: kbuild.LAUNCHES[name + k]
                      for k in ("_skinny", "_splitk")}
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name}: not repeatable")
        prefill = label.startswith("prefill")
        check(variants == {name: 2, name + "_tc": 2 * prefill},
              f"{name} {label}: launches {variants}")
        if not prefill:
            check(one_launch == {"_skinny": 2, "_splitk": 0},
                  f"{name} {label}: not the one-launch skinny kernel: "
                  f"{one_launch}")
            rows_alone(lambda i: kquant.quant_matmul(x[i:i + 1], qt), got,
                       f"{name} {label}")
        err = quant_err(got, x, qt)
        w_bf16 = kquant.dequantize_tensor(qt).to(torch.bfloat16)
        flops = 2 * m * d * n
        bnd, by = kernel_bound("quant_matmul", x, qt)
        # no PyTorch call dequantizes blocks: no library call; the
        # yardstick's times are printed
        rec = dict(max_abs_err=err, bound_ms=bnd, bound_by=by,
                   **timings(lambda: kquant.quant_matmul(x, qt),
                             lambda: ref.quant_matmul_reference(x, qt)))
        yard = time_ms(lambda: torch.matmul(x, w_bf16))
        yard_dev = device_ms(lambda: torch.matmul(x, w_bf16))
        kernel = ("skinny_tc_kernel" if kquant.skinny_tensor_core(
            x.dtype, d, n, True) else "skinny_kernel") if not prefill \
            else "quant_tc_kernel"
        device = f"device {show(rec['device_ms'])} ms"
        if not prefill:
            pool = cold_copies(qt)
            turn = iter(pool * 4)
            warm = rec["device_ms"]
            rec["device_ms"] = device_ms(
                lambda: kquant.quant_matmul(x, next(turn)), iters=len(pool),
                attempts=3)
            device = (f"device cold {show(rec['device_ms'])} ms "
                      f"({show(div(rec['device_ms'], bnd), '.2f')}x the bound;"
                      f" {len(pool)} copies), warm {show(warm)} ms")
            if kernel == "skinny_tc_kernel":
                # the CUDA-core kernel on the same inputs, within the same
                # tolerance, timed cold the same way
                cc_err = quant_err(skinny_cuda_core(x, qt), x, qt)
                turn = iter(pool * 4)
                cc_dev = device_ms(lambda: skinny_cuda_core(x, next(turn)),
                                   iters=len(pool), attempts=3)
                device += (f" (skinny_kernel on the CUDA cores, same inputs: "
                           f"err {cc_err:.3g}, device cold {show(cc_dev)} ms)")
            del pool, turn
        part = (f"{label} ({m}x{d})@({d}x{n}) {kernel} err {err:.3g}, "
                f"{rec['ms']:.4f} ms, {device} = "
                f"{show(div(flops / 1e9, rec['device_ms']), '.1f')} TFLOP/s, "
                f"bound "
                f"{bnd:.4f} ms ({by}), plain {rec['plain_ms']:.4f} ms, "
                f"yardstick bf16 matmul {yard:.4f} ms, device {show(yard_dev)} "
                f"ms")
        if prefill:
            # the same product in f32 on the CUDA-core tiled kernel
            x32 = x.float()
            kbuild.reset_launch_counts()
            got32 = kquant.quant_matmul(x32, qt)
            variants32 = routes(name)
            torch.cuda.synchronize()
            check(variants32 == {name: 1, name + "_tc": 0},
                  f"{name} f32 prefill: launches {variants32}")
            err32 = quant_err(got32, x32, qt)
            part += (f"; the tensor-core kernel; f32 copies on the tiled "
                     f"kernel: err {err32:.3g} (<= 1e-5 (|x|@|W|)), "
                     f"{time_ms(lambda: kquant.quant_matmul(x32, qt)):.4f} "
                     f"ms, device "
                     f"{show(device_ms(lambda: kquant.quant_matmul(x32, qt)))}"
                     " ms")
            del x32, got32
            records[name + "_tc"] = dict(
                name=name + "_tc", route="cuda",
                source="src/repro_torch/kernels/csrc/quant.cu",
                replaces=("src/repro/kernels/quant.py:118" if fmt == "q8_0"
                          else "src/repro/kernels/quant.py:134"), **rec)
        else:
            worst = max(worst, err)
        parts.append(part)
        if label == "decode w_gate":
            records[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/quant.cu",
                replaces=("src/repro/kernels/quant.py:118" if fmt == "q8_0"
                          else "src/repro/kernels/quant.py:134"), **rec)
        del qt, w_bf16
    records[name]["max_abs_err"] = worst
    print(f"[kernel] {name} bf16 x: " + "; ".join(parts)
          + " (tolerance 1e-5 (|x|@|W|) + 1 bf16 unit; repeat runs bitwise "
          "equal; decode: one launch of the skinny kernel, each row alone "
          f"== its row in the batch bitwise; a one-block fill kernel takes "
          f"{show(floor_ms)} ms of device time)", flush=True)

# knn_distances: 256 queries (a batch) against one chunk of a
# 1,000,000-row database, in bf16, at the dimension of the paper's KNN
# workload (b) (D = 1024, src/repro/core/workloads.py:94)
KNN_Q, KNN_N, KNN_D, KNN_K, CHUNKS = 256, 1_000_000, 1024, 8, 8
KNN_CHUNK = KNN_N // CHUNKS
knn_q, knn_db = randn(KNN_Q, KNN_D), randn(KNN_N, KNN_D)
chunk = knn_db[:KNN_CHUNK]
kbuild.reset_launch_counts()
got = kknn.knn_distances(knn_q, chunk)
check(kbuild.LAUNCHES["knn_distances_wgmma"] == 1,
      f"knn_distances: launches {kbuild.LAUNCHES}, not the wgmma kernel")
plain = ref.knn_distances_reference(knn_q, chunk)
torch.cuda.synchronize()
tol = 1e-5 * (knn_q.float().norm(dim=1)[:, None]
              + chunk.float().norm(dim=1)[None, :]) ** 2
diff = (got - plain).abs()
check(bool(torch.isfinite(got).all()), "knn_distances: non-finite output")
check(bool((diff <= tol).all()), f"knn_distances: err {diff.max().item()} "
      f"past 1e-5 (|q| + |x|)^2 by {(diff - tol).max().item()}")
check(torch.equal(kknn.knn_distances(knn_q, chunk), got),
      "knn_distances: not repeatable")
knn_flops = kcost.kernel_cost("knn_distances", knn_q, chunk).flops
bnd, by = kernel_bound("knn_distances", knn_q, chunk)
# the yardstick: one addmm (cuBLAS) on the bf16 q and x with an f32
# output, on the tensor cores, the norms' sum q2 + x2 precomputed outside
# the timed call (bf16 products are exact in f32, so this is the same
# function); the f32 addmm (TF32 off) on f32 copies of q and x, timed
# beside it, runs on the CUDA cores
qf, xf = knn_q.float(), chunk.float()
q2x2 = (qf * qf).sum(-1, keepdim=True) + (xf * xf).sum(-1)[None, :]
lib = torch.addmm(q2x2, knn_q, chunk.T, alpha=-2.0, out_dtype=torch.float32)
torch.cuda.synchronize()
check(bool(((lib - plain).abs() <= tol).all()),
      "knn_distances: the bf16 addmm yardstick is not the same function")
del lib
records["knn_distances"] = dict(
    name="knn_distances", route="cuda",
    source="src/repro_torch/kernels/csrc/knn.cu",
    replaces="src/repro/kernels/knn.py:39",
    max_abs_err=diff.max().item(),
    ms=time_ms(lambda: kknn.knn_distances(knn_q, chunk)),
    plain_ms=time_ms(lambda: ref.knn_distances_reference(knn_q, chunk)),
    bound_ms=bnd, bound_by=by,
    library_ms=time_ms(lambda: torch.addmm(q2x2, knn_q, chunk.T, alpha=-2.0,
                                           out_dtype=torch.float32)))
rec = records["knn_distances"]
f32_lib_ms = time_ms(lambda: torch.addmm(q2x2, qf, xf.T, alpha=-2.0))
dev_k = device_ms(lambda: kknn.knn_distances(knn_q, chunk))
dev_l = device_ms(lambda: torch.addmm(q2x2, knn_q, chunk.T, alpha=-2.0,
                                      out_dtype=torch.float32))
rec.update(device_ms=dev_k, library_device_ms=dev_l)
print(f"[kernel] knn_distances Q={KNN_Q} N={KNN_CHUNK} D={KNN_D} bf16: "
      f"max_abs_err {rec['max_abs_err']:.4g} (<= 1e-5 (|q|+|x|)^2, at most "
      f"{(diff / tol).max().item():.3g} of it); {rec['ms']:.4f} ms = "
      f"{knn_flops / rec['ms'] / 1e9:.1f} TFLOP/s, bound {bnd:.4f} ms "
      f"({by}), plain {rec['plain_ms']:.4f} ms, library (bf16 addmm, f32 "
      f"out) {rec['library_ms']:.4f} ms: {rec['ms'] / rec['library_ms']:.2f}x"
      f" it (f32 addmm on f32 copies {f32_lib_ms:.4f} ms); the wgmma kernel; "
      f"device time (torch.profiler, warm L2) {show(dev_k)} ms = "
      f"{show(div(knn_flops / 1e9, dev_k), '.1f')} TFLOP/s, the library's "
      f"{show(dev_l)} ms: {show(div(dev_k, dev_l), '.2f')}x it", flush=True)
del got, plain, diff
# the CUDA-core knn_kernel, which takes f32 (and bf16 the wgmma kernel does
# not take): the same chunk in f32, against the plain version at the same
# tolerance (the f32 copies hold the bf16 values exactly)
kbuild.reset_launch_counts()
got = kknn.knn_distances(qf, xf)
check(kbuild.LAUNCHES["knn_distances"] == 1
      and kbuild.LAUNCHES["knn_distances_wgmma"] == 0,
      f"knn_distances f32: launches {kbuild.LAUNCHES}, not the CUDA-core "
      "kernel")
plain = ref.knn_distances_reference(qf, xf)
torch.cuda.synchronize()
diff = (got - plain).abs()
check(bool(torch.isfinite(got).all()), "knn_distances f32: non-finite output")
check(bool((diff <= tol).all()), f"knn_distances f32: err "
      f"{diff.max().item()} past 1e-5 (|q| + |x|)^2 by "
      f"{(diff - tol).max().item()}")
check(torch.equal(kknn.knn_distances(qf, xf), got),
      "knn_distances f32: not repeatable")
f32_ms = time_ms(lambda: kknn.knn_distances(qf, xf))
print(f"[kernel] knn_distances Q={KNN_Q} N={KNN_CHUNK} D={KNN_D} f32: "
      f"max_abs_err {diff.max().item():.4g} (<= 1e-5 (|q|+|x|)^2, at most "
      f"{(diff / tol).max().item():.3g} of it), repeatable; the CUDA-core "
      f"kernel, {f32_ms:.4f} ms (f32 addmm {f32_lib_ms:.4f} ms)", flush=True)
del got, plain, tol, diff, qf, xf, q2x2

# sls: the paper's DLRM / Criteo workload (i) (a 1,000,000 x 256 table,
# src/repro/core/workloads.py:148): 4096 bags of up to L = 100 slots (the
# largest multi-hot size of MLPerf's DLRM-DCNv2 Criteo setup), lengths
# uniform in 1..100 padded with -1, uniform indices (the 1 GB table
# defeats the 50 MB L2), per-sample weights in [0, 1)
SLS_V, SLS_D, SLS_B, SLS_L = 1_000_000, 256, 4096, 100
SLS_CHUNK = SLS_B // CHUNKS
sls_table = randn(SLS_V, SLS_D, dtype=torch.float32)
sls_idx = torch.randint(0, SLS_V, (SLS_B, SLS_L), generator=G, device=DEV,
                        dtype=torch.int32)
sls_len = torch.randint(1, SLS_L + 1, (SLS_B, 1), generator=G, device=DEV)
sls_idx[torch.arange(SLS_L, device=DEV)[None, :] >= sls_len] = -1
sls_w = torch.rand((SLS_B, SLS_L), generator=G, device=DEV)
sls_valid = sls_idx >= 0
n_valid = int(sls_valid.sum())


def sls_err(got, table, idx, w):
    """Max |kernel - plain| and whether they are bitwise equal; fails past
    1e-5 sum |w row|."""
    want = ref.sls_reference(table, idx, w)
    tol = 1e-5 * ref.sls_reference(table.abs(), idx,
                                   None if w is None else w.abs())
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "sls: non-finite output")
    check(bool((diff <= tol).all()), f"sls ({table.dtype}, weights "
          f"{w is not None}): err {diff.max().item()} past 1e-5 sum |w row|")
    return diff.max().item(), torch.equal(got, want)


sls_once = ksls.sls(sls_table, sls_idx, sls_w)
torch.cuda.synchronize()
parts, worst = [], 0.0
for label, table, w in (("f32, weighted", sls_table, sls_w),
                        ("f32, weights=None", sls_table, None),
                        ("bf16 table, weighted",
                         sls_table.to(torch.bfloat16), sls_w)):
    got = sls_once if w is sls_w and table is sls_table \
        else ksls.sls(table, sls_idx, w)
    torch.cuda.synchronize()
    err, same = sls_err(got, table, sls_idx, w)
    worst = max(worst, err)
    parts.append(f"{label} err {err:.3g}{' (bitwise)' if same else ''}")
    del table, got
# the bytes the function needs: each distinct row of the drawn bags once
# (a row that two slots draw is read once; the timing runs with a cold
# L2), every index, the weights of the valid slots and the output
n_rows = int(torch.unique(sls_idx[sls_valid]).numel())
bnd, by = kernel_bound("sls", sls_table, sls_idx, sls_w, rows=n_rows,
                       n_valid=n_valid)
flat_idx = sls_idx[sls_valid].long()
offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=DEV),
                     sls_valid.sum(1).cumsum(0)[:-1]])
flat_w = sls_w[sls_valid]
records["sls"] = dict(
    name="sls", route="cuda", source="src/repro_torch/kernels/csrc/sls.cu",
    replaces="src/repro/kernels/sls.py:48", max_abs_err=worst,
    bound_ms=bnd, bound_by=by,
    **timings(lambda: ksls.sls(sls_table, sls_idx, sls_w),
              lambda: ref.sls_reference(sls_table, sls_idx, sls_w),
              lambda: torch.nn.functional.embedding_bag(
                  flat_idx, sls_table, offsets, mode="sum",
                  per_sample_weights=flat_w)))
rec = records["sls"]
print(f"[kernel] sls V={SLS_V} D={SLS_D} B={SLS_B} L={SLS_L}, {n_valid} "
      f"valid slots on {n_rows} distinct rows: " + "; ".join(parts)
      + f" (<= 1e-5 sum |w row|); {rec['ms']:.4f} ms, bound {bnd:.4f} ms "
      f"({by}), plain {rec['plain_ms']:.4f} ms, library (embedding_bag, "
      f"flat valid indices) {rec['library_ms']:.4f} ms; device time "
      f"(torch.profiler, warm L2) {show(rec['device_ms'])} ms, the "
      f"library's {show(rec['library_device_ms'])} ms", flush=True)
del flat_idx, offsets, flat_w

# --------------------------------------------------------------------------
# 3b. the paper's offload workloads through stream_offload
# --------------------------------------------------------------------------

phase("3b")

PROTOCOLS = (OffloadProtocol.BS, OffloadProtocol.RP, OffloadProtocol.AXLE)


OFFLOAD_REPEATS = 10


def offload_runs(run, kernel, variant=None):
    """`run(protocol)` under BS, RP and AXLE (ring_depth 2) after one
    warm-up; the launch counts are set to 0 just before each run and read
    just after.  Checks that each run launched `kernel` once per chunk and
    nothing else, every one of them its `variant` kernel where one is
    named, and that the three outputs are bitwise equal.  Then each
    protocol runs OFFLOAD_REPEATS times more, timed.  Returns the AXLE
    output, its launches and each protocol's wall times (min / median /
    max over the repeats)."""
    outs, walls, launches = {}, {}, {}
    for proto in (OffloadProtocol.AXLE,) + PROTOCOLS:
        with use_offload(OffloadConfig(protocol=proto, ring_depth=2)):
            torch.cuda.synchronize()
            kbuild.reset_launch_counts()
            outs[proto] = run(proto)
            torch.cuda.synchronize()
            launches[proto] = dict(kbuild.LAUNCHES)
    for proto in PROTOCOLS:
        walls[proto] = []
        with use_offload(OffloadConfig(protocol=proto, ring_depth=2)):
            for _ in range(OFFLOAD_REPEATS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                run(proto)
                torch.cuda.synchronize()
                walls[proto].append((time.perf_counter() - t) * 1e3)
    for proto in PROTOCOLS:
        counts = launches[proto]
        check(counts[kernel] == CHUNKS
              and sum(n for k, n in counts.items()
                      if k not in kbuild.VARIANTS) == CHUNKS
              and all(counts[k] == (CHUNKS if k == variant else 0)
                      for k in kbuild.VARIANTS),
              f"{kernel} {proto.name} run launches {counts}")
        check(all(torch.equal(a, b) for a, b in zip(
            outs[proto], outs[OffloadProtocol.BS])),
            f"{kernel}: {proto.name} differs from BS")
    axle = OffloadProtocol.AXLE
    wall = ", ".join(
        f"{p.name} {min(walls[p]):.2f} / {statistics.median(walls[p]):.2f} / "
        f"{max(walls[p]):.2f} ms" for p in PROTOCOLS)
    return outs[axle], launches[axle], \
        f"(min / median / max of {OFFLOAD_REPEATS}) {wall}"


knn_out, knn_launches, wall = offload_runs(
    lambda proto: knn_offload.knn_stream(knn_q, knn_db, KNN_K, CHUNKS, proto,
                                         global_ids=True), "knn_distances",
    "knn_distances_wgmma")
whole = ops.knn_topk(knn_q, knn_db, KNN_K)
with ops.reference_mode():
    plain_full = ops.knn_distances(knn_q, knn_db)
plain_d, plain_ids = ref.smallest_k(plain_full, KNN_K)
torch.cuda.synchronize()
check(torch.equal(knn_out[0], whole[0]) and torch.equal(knn_out[1], whole[1]),
      "knn offload: streamed top-k != one kernel call over the database")
row_tol = 1e-5 * (knn_q.float().norm(dim=1)[:, None]
                  + knn_db.float().norm(dim=1).max()) ** 2
d_err = (knn_out[0] - plain_d).abs()
check(bool((d_err <= row_tol).all()),
      f"knn offload: top-{KNN_K} distances off the plain path's by "
      f"{d_err.max().item()}")
id_gap = (plain_full.gather(1, knn_out[1]) - plain_d).abs()
check(bool((id_gap <= row_tol).all()),
      f"knn offload: an id differs from the plain path's at a gap of "
      f"{id_gap.max().item()} (no near tie)")
n_diff = int((knn_out[1] != plain_ids).sum())
print(f"[offload] knn Q={KNN_Q} N={KNN_N} D={KNN_D} bf16, top-{KNN_K}, "
      f"{CHUNKS} chunks of {KNN_CHUNK}, global ids, on "
      f"{torch.cuda.get_device_name(0)}: wall {wall}; launches {knn_launches}"
      f" per run, all on the wgmma kernel; BS == RP == AXLE == one kernel "
      f"call bitwise; top-{KNN_K} "
      f"distances vs the plain path max_abs_err {d_err.max().item():.4g} "
      f"(<= 1e-5 (|q|+max|x|)^2); {n_diff} of {knn_out[1].numel()} ids "
      "differ from the plain path's, each at a near tie", flush=True)
# knn_topk (the port of the reference's `knn.knn_topk`: the distance
# kernel, then the k smallest on the device) against its plain version at
# the offload's chunk, on integer-valued bf16 inputs: every distance is an
# exact integer on both routes, so ids and distances must be equal, the
# many ties broken lowest id first; rows 1..3 of the chunk repeat row 0
ints = torch.randint(-2, 3, (KNN_Q + KNN_CHUNK, KNN_D), generator=G,
                     device=DEV).to(torch.bfloat16)
tq, tdb = ints[:KNN_Q], ints[KNN_Q:].clone()
tdb[1:4] = tdb[0]
tq[0] = tdb[0]
kbuild.reset_launch_counts()
top_d, top_i = ops.knn_topk(tq, tdb, KNN_K)
topk_launches = {k: kbuild.LAUNCHES[k]
                 for k in ("knn_distances", "knn_distances_wgmma")}
ref_d, ref_i = ref.knn_topk_reference(tq, tdb, KNN_K)
check(topk_launches == {"knn_distances": 1, "knn_distances_wgmma": 1},
      f"knn_topk: launches {topk_launches}, not one wgmma distance kernel")
check(torch.equal(top_i, ref_i) and torch.equal(top_d, ref_d),
      "knn_topk: ids or distances != the plain version's on exact inputs")
check(top_i[0, :4].tolist() == [0, 1, 2, 3] and top_d[0, 0].item() == 0,
      f"knn_topk: the tied rows 0..3 came back as {top_i[0, :4].tolist()}")
n_tied = int((top_d[:, 1:] == top_d[:, :-1]).sum())
print(f"[knn_topk] Q={KNN_Q} N={KNN_CHUNK} D={KNN_D} bf16 integer-valued, "
      f"top-{KNN_K}: ids and distances == the plain version's bitwise "
      f"({n_tied} tied neighbours, lowest id first; query 0's four equal "
      f"rows 0..3 in order); launches {topk_launches}; {SMI_LINE}",
      flush=True)
del ints, tq, tdb, top_d, top_i, ref_d, ref_i
# one AXLE call under torch.profiler: where its wall goes
with use_offload(OffloadConfig(protocol=OffloadProtocol.AXLE, ring_depth=2)):
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        knn_offload.knn_stream(knn_q, knn_db, KNN_K, CHUNKS,
                               OffloadProtocol.AXLE, global_ids=True)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
dev = sorted(((e.self_device_time_total, e.count, e.key)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA),
             reverse=True)
busy = sum(t for t, _, _ in dev) / 1e3
print(f"[offload] knn AXLE, one call under torch.profiler: wall "
      f"{prof_wall:.2f} ms, device busy {busy:.2f} ms (kernels, memsets and "
      f"copies); top: " + "; ".join(f"{k[:48]} x{n} {t / 1e3:.2f} ms"
                                    for t, n, k in dev[:5]), flush=True)
del knn_db, plain_full, whole, knn_out, prof, dev


def sls_stream(proto):
    def producer(i):
        rows = slice(i * SLS_CHUNK, (i + 1) * SLS_CHUNK)
        return i, ops.sls(sls_table, sls_idx[rows], sls_w[rows])

    def consumer(out, partial):
        i, pooled = partial
        out[i * SLS_CHUNK:(i + 1) * SLS_CHUNK] = pooled
        return out

    return (stream_offload(producer, consumer,
                           torch.zeros((SLS_B, SLS_D), device=DEV), CHUNKS,
                           proto),)


(sls_out,), sls_launches, wall = offload_runs(sls_stream, "sls")
check(torch.equal(sls_out, sls_once),
      "sls offload: streamed bags != one kernel call over all bags")
print(f"[offload] sls V={SLS_V} D={SLS_D} f32, B={SLS_B} L={SLS_L} in "
      f"{CHUNKS} chunks of {SLS_CHUNK}, on {torch.cuda.get_device_name(0)}: "
      f"wall {wall}; launches {sls_launches} per run; BS == RP == AXLE == "
      "one kernel call bitwise", flush=True)
del sls_table, sls_idx, sls_w, sls_valid, sls_once, sls_out

example_out = io.StringIO()
with contextlib.redirect_stdout(example_out):
    knn_offload.main([])
print("[example] python -m repro_torch.examples.knn_offload: "
      + "; ".join(ln.strip() for ln in example_out.getvalue().splitlines()),
      flush=True)

# --------------------------------------------------------------------------
# 4. serve: the starcoder2_3b path at full width
# --------------------------------------------------------------------------

phase("4")

rng = np.random.default_rng(0)


def make_requests(n, lo, hi, max_new, vocab=cfg.vocab):
    out = []
    for i in range(n):
        plen = int(rng.integers(lo, hi + 1))
        out.append(Request(i, rng.integers(1, vocab, plen).astype(
            np.int32), max_new))
    return out


def copies(reqs):
    return [Request(r.rid, r.prompt, r.max_new, sampling=r.sampling,
                    embeds=r.embeds) for r in reqs]


class EagerServer(BatchedServer):
    """The server with its decode segments run eagerly, launch by launch
    from the host, as on the CPU: the twin the [graph] phase holds the
    graphed server to.  The port itself has no switch for it."""

    def _segment_fns(self, fns, *statics):
        return fns


def serve(requests, params=None, arch=ARCH, cls=BatchedServer, around=None,
          max_seq=S, batch_slots=4, **kw):
    """One drained run; the launch counts are set to 0 just before it and
    read just after.  The server is built (and its decode segments
    captured as CUDA graphs) before that; `around` is a context entered
    for the run alone.  A graphed server must have run every segment as
    one replay."""
    server = cls(arch, smoke=False, device="cuda", batch_slots=batch_slots,
                 max_seq=max_seq, seg_len=8, params=params, **kw)
    for r in requests:
        server.submit(r)
    torch.cuda.synchronize()
    kbuild.reset_launch_counts()
    with around or contextlib.nullcontext():
        t = time.perf_counter()
        server.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    launches = dict(kbuild.LAUNCHES)
    check(server.pages_allocated == server.pages_freed
          and server.pages_resident == 0, "page ledger not closed")
    toks = {r.rid: r.generated for r in server.completed}
    check(len(toks) == len(requests), "not every request completed")
    segments = dispatches(server)
    check(server.graph_replays
          == (0 if issubclass(cls, EagerServer) else segments),
          f"{server.graph_replays} graph replays for {segments} segments")
    return server, toks, launches, dt


def dispatches(srv):
    """Segments dispatched: streamed, one per seg_len steps (rounds under
    speculation); per-token, one per step (round)."""
    if srv.stream:
        return srv.segments_dispatched
    return srv.steps // (srv.spec_k + 1 if srv.spec else 1)


def segment_args(srv):
    """What a server's segment functions take, the state last."""
    if srv.spec:
        return (srv.params, srv.draft_params, srv.cache, srv.draft_cache,
                srv.state)
    return srv.params, srv.cache, srv.state


def ledger(srv):
    return (srv.pages_allocated, srv.pages_freed, srv.pages_resident_peak,
            srv.slot_pages.tolist())


def graph_equals_eager(label, srv, toks, launches, dt, reqs, **kw):
    """The graphed run `srv` against an eager twin on the same requests
    and weights (`kw`: the twin's options): tokens, the cache's bytes at
    drain, the page ledger and the launch counts bitwise equal, the same
    host syncs, every segment a replay on the graphed side."""
    e, e_toks, e_launches, e_dt = serve(copies(reqs), params=srv.params,
                                        cls=EagerServer, **kw)
    n_tok = sum(len(t) for t in toks.values())
    check(e_toks == toks, f"[graph] {label}: graphed tokens != eager")
    check(srv.cache.keys() == e.cache.keys()
          and all(torch.equal(srv.cache[k], e.cache[k]) for k in srv.cache),
          f"[graph] {label}: the cache at drain differs from the eager run's")
    if srv.spec:
        check(srv.draft_cache.keys() == e.draft_cache.keys()
              and all(torch.equal(srv.draft_cache[k], e.draft_cache[k])
                      for k in srv.draft_cache),
              f"[graph] {label}: the draft cache at drain differs from the "
              "eager run's")
        check((srv.draft_accepted, srv.draft_proposed)
              == (e.draft_accepted, e.draft_proposed),
              f"[graph] {label}: accept counts differ")
    check(ledger(srv) == ledger(e), f"[graph] {label}: ledger "
          f"{ledger(srv)} != eager {ledger(e)}")
    check(e_launches == launches, f"[graph] {label}: launches {launches} "
          f"!= eager {e_launches}")
    check(srv.decode_syncs == e.decode_syncs
          and srv.host_syncs == e.host_syncs,
          f"[graph] {label}: host syncs differ")
    segments = dispatches(srv)
    print(f"[graph] {label}: {len(reqs)} requests, {n_tok} tokens, "
          f"{segments} segments = {srv.graph_replays} graph replays; "
          "graphed == eager bitwise (tokens, cache bytes at drain"
          f"{', the draft cache too' if srv.spec else ''}, ledger "
          f"{ledger(srv)[:3]}, launches); syncs_per_token "
          f"{srv.decode_syncs / n_tok:.4f} both; {n_tok / dt:.1f} tok/s "
          f"graphed, {n_tok / e_dt:.1f} eager; "
          f"{time.perf_counter() - T_START:.0f} s into the script",
          flush=True)
    del e


def replay_profile(srv, label, steps_only=False):
    """Each captured segment of a drained server (only the two one-step
    ones with `steps_only`: the profiler's events of the 8-step replays
    take most of a large model's phase) replayed under torch.profiler:
    kernels and device ms per replay, and the host's wall ms per replay.
    Run after the server's checks: a replay writes the (now idle) slots'
    cache rows.  Returns the parts and the bytes of weights a step
    reads."""
    parts = {}
    args = segment_args(srv)
    # a spec segment is ~10,000 kernels a round: fewer replays traced
    traced, timed = (1, 3) if srv.spec else (5, 10)
    segments = (("step_fn", 1), ("step_plain_fn", 1))
    if not steps_only:
        segments = (("segment_fn", srv.seg_len),
                    ("segment_plain_fn", srv.seg_len)) + segments
    for name, steps_n in segments:
        fn = getattr(srv, name)
        fn(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(traced):
                fn(*args)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        t = time.perf_counter()
        for _ in range(timed):
            fn(*args)
        torch.cuda.synchronize()
        parts[name] = dict(
            steps=steps_n, kernels=sum(e.count for e in ev) / traced,
            device_ms=sum(e.self_device_time_total for e in ev)
            / (traced * 1e3),
            wall_ms=(time.perf_counter() - t) * 1e3 / timed,
            launches=sum(n for k, n in fn.launches.items()
                         if k not in kbuild.VARIANTS))
    full, plain = ((parts["step_fn"], parts["step_plain_fn"]) if steps_only
                   else (parts["segment_fn"], parts["segment_plain_fn"]))
    epilogue = (full["device_ms"] - plain["device_ms"]) / full["steps"]
    unit = "rounds" if srv.spec else "steps"
    # a decode step reads every weight once: its bytes bound the step
    weights = sum(t.nbytes if isinstance(t, kquant.QTensor)
                  else t.numel() * t.element_size()
                  for t in leaves(srv.params))
    print(f"[graph] {label}, one replay of each captured segment: " + "; ".join(
        f"{k} ({v['steps']} {unit}) {v['kernels']:.0f} kernels, "
        f"{v['launches']} of ours, device {v['device_ms']:.3f} ms, wall "
        f"{v['wall_ms']:.3f} ms" for k, v in parts.items())
        + f"; the sampled epilogue (full - plain) {epilogue:.3f} ms device "
        f"a {unit[:-1]}; a step reads {weights / 1e9:.3f} GB of weights, "
        f"{weights / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate",
        flush=True)
    return parts, weights


def leaves(tree):
    """The tensors (and QTensors) of a parameter tree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def serve_line(arch, protocol, srv, toks, launches, dt):
    n_tok = sum(len(t) for t in toks.values())
    check(all(len(t) == 64 for t in toks.values()), "short stream")
    check(srv.decode_syncs / n_tok == 1 / (8 * 4),
          f"syncs_per_token {srv.decode_syncs / n_tok}")
    print(f"[serve] {arch} full width, {protocol}, streamed, 8 requests "
          f"(prompts 64-400, max_new 64), 4 slots, max_seq {S}, seg_len 8: "
          f"{n_tok} tokens in {dt:.3f} s = {n_tok / dt:.1f} tok/s; "
          f"syncs_per_token {srv.decode_syncs / n_tok:.4f}; decode steps "
          f"{srv.steps}, prefills {srv.prefill_forwards}; launches "
          f"{launches}; ledger closed ({srv.pages_allocated} pages)",
          flush=True)


PROFILE_GROUPS = (
    ("decode (split + merge)", ("decode_split", "decode_merge")),
    ("flash prefill", ("flash_tc_kernel", "flash_kernel")),
    ("quant_matmul tensor-core", ("quant_tc_kernel",)),
    ("quant_matmul skinny", ("skinny_kernel", "skinny_tc_kernel")),
    ("quant_matmul tiled", ("tiled_kernel",)),
    ("splitk_reduce", ("splitk_reduce",)),
    ("ssd_scan", ("ssd_kernel", "ssd_chunk_tc_kernel", "ssd_pass_kernel",
                  "ssd_out_tc_kernel")))


def profile(arch, params, vocab, label="", **kw):
    """Where one streamed run's time goes: device time by kernel, and the
    device's busy share of the wall time (one stream, so kernels do not
    overlap); informational, the run's correctness gates are elsewhere."""
    reqs = make_requests(4, 64, 400, 16, vocab)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    _, _, _, prof_dt = serve(reqs, params=params, arch=arch,
                             protocol="axle", stream=True, around=prof,
                             **kw)
    # the kernels' own entries only: a CPU op's row repeats the device
    # time of the kernels it launched
    by_op = sorted(((e.self_device_time_total, e.key, e.count)
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA),
                   reverse=True)
    busy_ms = sum(t for t, _, _ in by_op) / 1e3
    top = "; ".join(f"{k[:48]} {t / 1e3:.1f} ms" for t, k, _ in by_op[:6]
                    if t)
    # the port's kernels by function and route: device ms and launches
    groups = []
    for label_g, kinds in PROFILE_GROUPS:
        hits = [(t, n) for t, k, n in by_op if any(x in k for x in kinds)]
        if hits:
            groups.append(f"{label_g} {sum(t for t, _ in hits) / 1e3:.1f} ms "
                          f"/ {sum(n for _, n in hits)} kernel launches")
    print(f"[profile] {arch}{label}, axle, 4 requests x 16 tokens, streamed: "
          f"wall {prof_dt * 1e3:.1f} ms under the profiler, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / (prof_dt * 1e3):.1f}%); top: "
          f"{top or 'not measured (the profiler saw no device time)'}; the "
          f"port's kernels: {'; '.join(groups) or 'none seen'}", flush=True)


def streamed_equals_per_token(arch, params, reqs, label="", **kw):
    _, streamed, _, _ = serve(copies(reqs), params=params, arch=arch,
                              protocol="axle", stream=True, **kw)
    _, per_token, _, _ = serve(copies(reqs), params=params, arch=arch,
                               protocol="axle", stream=False, **kw)
    check(streamed == per_token, f"{arch}{label}: streamed != per-token")
    print(f"[serve] {arch}{label}: the same {len(reqs)} requests streamed "
          "and per-token: identical tokens", flush=True)
    return streamed


main_reqs = make_requests(8, 64, 400, 64)
srv, axle_toks, launches, dt = serve(main_reqs, protocol="axle",
                                     stream=True)
n_layers = cfg.n_layers
check(launches["decode_attention_fused"] == srv.steps * n_layers
      and launches["decode_attention_fused_tc"]
      == launches["decode_attention_fused"],
      f"fused launches {launches} != {srv.steps} steps x {n_layers}, all on "
      "the tensor-core split")
check(launches["flash_attention"] == srv.prefill_forwards * n_layers
      and launches["flash_attention_tc"] == launches["flash_attention"],
      f"flash launches {launches} != {srv.prefill_forwards} x {n_layers}, "
      "all on the tensor-core kernel")
check(launches["ssd_scan"] == 0, f"ssd_scan launched: {launches}")
serve_line(ARCH, "axle", srv, axle_toks, launches, dt)
main_launches = launches
main_dt, main_syncs = dt, srv.decode_syncs
params = srv.params
graph_equals_eager(f"{ARCH} fp, axle", srv, axle_toks, launches, dt,
                   main_reqs, protocol="axle", stream=True)
replay_profile(srv, f"{ARCH} fp, axle")
del srv
profile(ARCH, params, cfg.vocab)
pair = make_requests(2, 64, 200, 16)
streamed = streamed_equals_per_token(ARCH, params, pair)

# --------------------------------------------------------------------------
# 5. reference check at full width
# --------------------------------------------------------------------------

phase("5")


def logits_along(prompts, steps, reference, arch_cfg=cfg, weights=None,
                 kv_quant=None, feed=None, max_seq=S, frames=None):
    """Prefill each prompt into its own row, then `steps` decode steps;
    returns [prefill logits (B, V), step logits (B, V), ...], with the
    kernel path or (reference=True) the plain path for every kernel.
    Step i decodes feed[i] ((B, 1) int32) where `feed` is given, else the
    greedy tokens of the logits before it.  An enc-dec model takes each
    row's frame embeddings (e, D) from `frames`."""
    weights = params if weights is None else weights
    model = get_model(arch_cfg)
    cache = model.init_cache(arch_cfg, len(prompts), max_seq, device=DEV,
                             kv_quant=kv_quant)
    out = []
    with (ops.reference_mode() if reference
          else contextlib.nullcontext()):
        first = []
        for row, pr in enumerate(prompts):
            clip = () if frames is None else (
                torch.from_numpy(frames[row]).to(DEV)[None],)
            lg, cache = model.prefill_into_cache(
                arch_cfg, weights, cache, torch.from_numpy(pr).to(DEV), row,
                len(pr), *clip)
            first.append(lg)
        out.append(torch.stack(first).float())
        toks = out[-1].argmax(-1).to(torch.int32)[:, None]
        pos_b = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                             device=DEV)
        for i in range(steps):
            if feed is not None:
                toks = feed[i]
            lg, cache = model.decode_step(arch_cfg, weights, cache, toks,
                                          positions=pos_b)
            out.append(lg[:, -1].float())
            toks = out[-1].argmax(-1).to(torch.int32)[:, None]
            pos_b = pos_b + 1
    return out


def near_tie_agree(a, b, what):
    """argmax(a) == argmax(b) per row, except at a near tie in a."""
    ia, ib = a.argmax(-1), b.argmax(-1)
    for r in range(a.shape[0]):
        if ia[r] != ib[r]:
            gap = (a[r, ia[r]] - a[r, ib[r]]).item()
            check(0.0 <= gap < NEAR_TIE, f"{what}: row {r} argmax "
                  f"{ia[r].item()} vs {ib[r].item()}, gap {gap}")


def logits_agree(arch, kern, plain, rows, vocab, atol):
    """The kernel path's logits (finite, (rows, vocab) a step) within
    `atol` of the plain path's, and each step's greedy tokens equal but
    at near ties of the plain logits.  Returns (the largest difference,
    the near-tie flips)."""
    worst = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    check(all(bool(torch.isfinite(a).all()) for a in kern),
          f"{arch}: non-finite logits")
    check(worst <= atol, f"{arch}: logits kernel vs plain: {worst}")
    flips = 0
    for i, (a, b) in enumerate(zip(kern, plain)):
        near_tie_agree(b, a, f"{arch} step {i}")
        flips += int((a.argmax(-1) != b.argmax(-1)).sum())
    check(all(a.shape == (rows, vocab) for a in kern),
          f"{arch}: logits of shape {tuple(kern[0].shape)}")
    return worst, flips


def kernels_against_plain(arch, prompts, atol=LOGIT_ATOL, **kw):
    """The kernel path's logits against the plain path's, step by step on
    the same tokens: both decode the plain path's greedy tokens, so a
    near-tie flip of one step's argmax (which the near-tie gate accepts)
    does not hand the two paths different inputs for the steps after."""
    plain = logits_along(prompts, 4, reference=True, **kw)
    feed = [lg.argmax(-1).to(torch.int32)[:, None] for lg in plain[:-1]]
    kern = logits_along(prompts, 4, reference=False, feed=feed, **kw)
    worst, flips = logits_agree(arch, kern, plain, len(prompts),
                                kw.get("arch_cfg", cfg).padded_vocab, atol)
    print(f"[reference] {arch} full width, {len(prompts)} rows, prefill + 4 "
          f"decode steps on the plain path's greedy tokens, kernels vs plain "
          f"versions: logits max_abs_err {worst:.4g} <= {atol}; greedy "
          f"tokens agree (near-tie gate {NEAR_TIE}; {flips} near-tie flips)",
          flush=True)
    return kern, feed


kernels_against_plain(ARCH, [r.prompt for r in make_requests(4, 64, 400, 1)])

rp_srv, rp_toks, rp_launches, rp_dt = serve(copies(pair), params=params,
                                            protocol="rp", stream=True)
graph_equals_eager(f"{ARCH} fp, rp", rp_srv, rp_toks, rp_launches, rp_dt,
                   pair, protocol="rp", stream=True)
del rp_srv
check(rp_launches["decode_attention_partial"] > 0
      and rp_launches["decode_attention_partial_tc"]
      == rp_launches["decode_attention_partial"]
      and rp_launches["decode_attention_fused"] == 0,
      f"rp run launches {rp_launches}, the partials not all on the "
      "tensor-core split")


def partings(toks, ref_toks, reqs, **kw):
    """Each stream of `toks` that parts from `ref_toks`: (rid, token t,
    the reference's and toks' choices there, each one's distance below the
    best logit of a prefill of the common prefix).  The prefill is a third
    computation, so at a near tie it may order the two choices either way;
    it is not held to either run's order."""
    prompts = {r.rid: r.prompt for r in reqs}
    clips = {r.rid: r.embeds for r in reqs}
    out = []
    for rid, got in toks.items():
        want = ref_toks[rid]
        if got == want:
            continue
        t = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        check(t is not None, f"request {rid}: {len(got)} tokens vs "
              f"{len(want)}, one stream a prefix of the other")
        lg = logits_along([np.concatenate([prompts[rid], np.asarray(
            want[:t], np.int32)])], 0, reference=False,
            frames=None if clips[rid] is None else [clips[rid]],
            **kw)[0][0]
        best = lg.max()
        out.append((rid, t, want[t], got[t], (best - lg[want[t]]).item(),
                    (best - lg[got[t]]).item()))
    return out


def describe(parts):
    return "; ".join(
        f"request {rid} parts at token {t} ({a} vs {b}, {ga:.4f} and "
        f"{gb:.4f} below the best logit)" for rid, t, a, b, ga, gb in parts)


def near_tie_agrees(what, toks, ref_toks, reqs, **kw):
    """`toks` equal `ref_toks`, or each stream that parts does so at a
    near tie: both choices within NEAR_TIE of the replay's best logit.
    Returns what the comparison found, each parting with its gaps."""
    parts = partings(toks, ref_toks, reqs, **kw)
    for part in parts:
        check(max(part[4:]) < NEAR_TIE, f"{what}: {describe([part])}, not "
              f"a near tie (gate {NEAR_TIE})")
    return ("equal to" if not parts
            else f"near-tie equal to ({describe(parts)})")


# one chunk (chunks_per_shard 1): the partial and its merge give the fused
# route's bits (section 3a, rp vs bs), so the tokens are equal
rp_vs = near_tie_agrees('rp vs axle', rp_toks, streamed, pair)
check(rp_toks == streamed, f"rp tokens != axle's: {rp_vs}")
print(f"[reference] protocol rp (one chunk), same 2 requests: launches "
      f"{rp_launches}; tokens {rp_vs} the axle run's, bitwise", flush=True)

# --------------------------------------------------------------------------
# 5a. sampling: the same 8 requests, half sampled, one greedy with stops
# --------------------------------------------------------------------------

phase("5a")

SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# request 1 (greedy) stops at the EOS id or at the 10th token of its
# greedy stream, whichever it emits first: the stop fires on the card
STOPS = (cfg.eos_token, axle_toks[1][9])


def sampled_requests(stops=STOPS):
    out = []
    for r in main_reqs:
        if r.rid % 2 == 0:
            sp = SamplingParams(seed=1000 + r.rid, **SAMPLED)
        else:
            sp = SamplingParams(stop_tokens=stops if r.rid == 1 else ())
        out.append(Request(r.rid, r.prompt, r.max_new, sampling=sp))
    return out


s_srv, s_toks, s_launches, s_dt = serve(sampled_requests(), params=params,
                                        protocol="axle", stream=True)
check(s_launches["decode_attention_fused"] == s_srv.steps * n_layers,
      f"sampled serve launches {s_launches}")
del s_srv
_, s_per_token, _, _ = serve(sampled_requests(), params=params,
                             protocol="axle", stream=False)
check(s_per_token == s_toks, "[sampling] seg_len 8 != per-token")
# each request alone, one after another through one server (slot 0)
alone_srv = BatchedServer(ARCH, smoke=False, device="cuda", batch_slots=4,
                          max_seq=S, seg_len=8, params=params,
                          protocol="axle", stream=True)
for r in sampled_requests():
    alone_srv.submit(r)
    alone_srv.run_until_drained()
alone = {r.rid: r.generated for r in alone_srv.completed}
check(alone_srv.graph_replays == alone_srv.segments_dispatched,
      "[sampling] alone: a segment was not a graph replay")
del alone_srv
check(alone == s_toks, "[sampling] a request alone != its row in the batch")
for rid, toks in s_toks.items():
    check(all(0 <= t < cfg.vocab for t in toks), f"[sampling] id >= vocab")
    if rid == 1:
        check(toks[-1] in STOPS and toks == axle_toks[1][:len(toks)],
              f"[sampling] request 1 did not stop as its greedy stream "
              f"says: {toks}")
    elif rid % 2:
        check(toks == axle_toks[rid],
              f"[sampling] greedy request {rid} != the greedy serve's")
    else:
        check(len(toks) == 64, f"[sampling] request {rid}: short stream")
n_sampled_diff = sum(s_toks[r] != axle_toks[r] for r in s_toks if r % 2 == 0)

# the sampling epilogue of one decode step at the serve's shape: 4 rows,
# all sampled, the padded vocabulary, bf16 logits from the model
ep_logits = randn(4, cfg.padded_vocab) * 4
ep_keys = torch.stack([prng.PRNGKey(i, DEV) for i in range(4)])
ep_params = ops.BatchedSampling(
    temperature=torch.full((4,), 0.8, device=DEV),
    top_k=torch.full((4,), 50, dtype=torch.int32, device=DEV),
    top_p=torch.full((4,), 0.95, device=DEV),
    min_p=torch.zeros((4,), device=DEV))


def epilogue():
    both = prng.split(ep_keys)
    return ops.sample_tokens(ep_logits, ep_params, both[:, 1],
                             vocab=cfg.vocab)


def epilogue_capped():
    both = prng.split(ep_keys)
    return ref.sample_tokens_capped(
        ep_logits, ep_params.temperature, ep_params.top_k, ep_params.top_p,
        ep_params.min_p, both[:, 1], cfg.vocab)


def graph_ms(fn, iters: int = 50) -> float:
    """Device time of one call of `fn` captured as a CUDA graph: CUDA
    events around `iters` replays, warm L2.  A replay launches its
    kernels from one host call, so the host's time per launch, which
    time_ms sees for a call of hundreds of small kernels, is out of it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


check(torch.equal(epilogue(), epilogue_capped()),
      "[sampling] capped != full reference on the card")
ep = dict(device_ms=graph_ms(epilogue), ms=time_ms(epilogue),
          capped_device_ms=graph_ms(epilogue_capped))
print(f"[sampling] {ARCH} full width, 8 requests (4 sampled T "
      f"{SAMPLED['temperature']} top_k {SAMPLED['top_k']} top_p "
      f"{SAMPLED['top_p']}, 4 greedy, request 1 with stops {STOPS}): "
      f"{sum(len(t) for t in s_toks.values())} tokens in {s_dt:.3f} s = "
      f"{sum(len(t) for t in s_toks.values()) / s_dt:.1f} tok/s, every "
      f"segment a graph replay; seg_len 8 == per-token == each request "
      f"alone, bitwise; greedy rows == the greedy serve's, request 1 "
      f"stopped at token {len(s_toks[1])} ({s_toks[1][-1]}); "
      f"{n_sampled_diff} of 4 sampled streams differ from greedy; "
      f"epilogue (key split + sample, B=4, V={cfg.padded_vocab}) "
      f"{ep['device_ms']:.4f} ms device (one graph replay), time_ms "
      f"{ep['ms']:.4f} eager; both branches of the capped sampler "
      f"{ep['capped_device_ms']:.4f} ms device", flush=True)

# --------------------------------------------------------------------------
# 5c. speculative decoding: the [serve] and [sampling] requests again
# --------------------------------------------------------------------------

phase("5c")

SPEC_K = 3
SPEC = dict(spec=True, spec_k=SPEC_K)


def spec_rounds(srv):
    return srv.steps // (srv.spec_k + 1)


LAP = [time.perf_counter()]


def lap():
    """Seconds since the previous call (or since the spec phases began)."""
    now = time.perf_counter()
    out, LAP[0] = now - LAP[0], now
    return out


def padded_twin(reqs, **kw):
    """Greedy tokens of the non-spec serve with every fp product and norm
    of its decode steps padded to the verify's 4 x (k + 1) rows
    (`quantize.padded_rows`; the prefills have more rows and do not pad):
    the decode at the verify's numerics, which a greedy spec stream must
    equal bitwise."""
    with padded_rows(4 * (SPEC_K + 1)):
        _, toks, _, _ = serve(copies(reqs), **kw)
    return toks


def spec_line(label, srv, toks, dt, base_tps, base_dt=None):
    n_tok = sum(len(t) for t in toks.values())
    rate = srv.draft_accepted / max(1, srv.draft_proposed)
    tps = n_tok / srv.decode_syncs
    print(f"[spec] {label}: {n_tok} tokens in {dt:.3f} s = "
          f"{n_tok / dt:.1f} tok/s"
          + (f" (non-spec {n_tok / base_dt:.1f})" if base_dt else "")
          + f"; accept rate {rate:.4f} ({srv.draft_accepted}/"
          f"{srv.draft_proposed}); tokens per decode sync {tps:.2f} "
          f"(non-spec {base_tps:.2f}); {spec_rounds(srv)} rounds in "
          f"{dispatches(srv)} segments, every one a graph replay; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"phase {lap():.1f} s, {time.perf_counter() - T_START:.0f} s into "
          "the script", flush=True)
    return rate, tps


# the starcoder2_3b spec serves run its first 8 of 30 layers, views of the
# [serve] weights, with the self:2 draft and the whole-target self:8: the
# routes and widths of the full depth at about a quarter of its time; each
# is held to the non-spec serves of the same 8 layers
SC8 = dataclasses.replace(cfg, arch_id=f"{ARCH}_first8", n_layers=8)
SC = dict(params=self_draft_params(cfg, params, SC8.n_layers), cfg=SC8)
SC_LOGITS = dict(arch_cfg=SC8, weights=SC["params"])
SC_DRAFT = "self:2"
b8_srv, b8_toks, _, b8_dt = serve(copies(main_reqs), protocol="axle",
                                  stream=True, **SC)
b8_tps = sum(len(t) for t in b8_toks.values()) / b8_srv.decode_syncs
del b8_srv
_, p8_toks, _, _ = serve(copies(pair), protocol="axle", stream=True, **SC)
torch.cuda.reset_peak_memory_stats()
sp_srv, sp_toks, sp_launches, sp_dt = serve(
    copies(main_reqs), protocol="axle", stream=True, draft_arch=SC_DRAFT,
    **SC, **SPEC)
d_layers = sp_srv.draft_cfg.n_layers
rounds = spec_rounds(sp_srv)
check(rounds == sp_srv.segments_dispatched * sp_srv.seg_len,
      f"[spec] {rounds} rounds in {sp_srv.segments_dispatched} segments")
check(sp_launches["decode_attention_fused"]
      == rounds * (SPEC_K + 1) * (d_layers + SC8.n_layers)
      and sp_launches["decode_attention_fused_tc"]
      == sp_launches["decode_attention_fused"],
      f"[spec] fused launches {sp_launches} != {rounds} rounds x "
      f"{SPEC_K + 1} x ({d_layers} + {SC8.n_layers}), all on the "
      "tensor-core split")
check(sp_launches["flash_attention"]
      == sp_srv.prefill_forwards * (SC8.n_layers + d_layers)
      and sp_launches["flash_attention_tc"] == sp_launches["flash_attention"],
      f"[spec] flash launches {sp_launches} != {sp_srv.prefill_forwards} x "
      f"({SC8.n_layers} + {d_layers}), all on the tensor-core kernel")
spec_rate, spec_tps = spec_line(
    f"{ARCH} fp (its first {SC8.n_layers} layers), axle, draft "
    f"{SC_DRAFT}, spec_k {SPEC_K}, the 8 [serve] requests, seg_len 8 "
    "rounds", sp_srv, sp_toks, sp_dt, b8_tps, b8_dt)
print(f"[spec] {ARCH}: fused decode launches {sp_launches['decode_attention_fused']} = {rounds} "
      f"rounds x {SPEC_K + 1} x ({d_layers} draft + {SC8.n_layers} verify "
      f"layers); flash {sp_launches['flash_attention']} = "
      f"{sp_srv.prefill_forwards} prefills x ({SC8.n_layers} + {d_layers}); "
      f"launches {sp_launches}", flush=True)
replay_profile(sp_srv, f"{ARCH} fp, first {SC8.n_layers} layers, axle, "
               f"spec {SC_DRAFT}")
del sp_srv
# the verify's products run over 4 x (k + 1) rows, a decode step's over 4:
# cuBLAS picks its kernel by the row count, so a greedy spec stream equals
# the non-spec one bitwise only with the decode padded to the verify's
# rows, and the plain non-spec stream up to partings at near ties (gated,
# printed)
check(sp_toks == padded_twin(main_reqs, protocol="axle", stream=True,
                             **SC),
      "[spec] greedy spec tokens != the non-spec serve's at the verify's "
      "row count")
print(f"[spec] {ARCH}: tokens == the non-spec serve's at the verify's row "
      "count, bitwise, and "
      + near_tie_agrees("[spec] greedy spec vs the non-spec greedy tokens",
                        sp_toks, b8_toks, main_reqs, **SC_LOGITS)
      + " the non-spec greedy tokens", flush=True)
# graph == eager on the 2 short requests: an eager round launches
# thousands of kernels from the host
g_srv, g_toks, g_launches, g_dt = serve(
    copies(pair), protocol="axle", stream=True, draft_arch=SC_DRAFT, **SC,
    **SPEC)
g_agree = near_tie_agrees("[spec] 2 requests, spec vs non-spec", g_toks,
                          p8_toks, pair, **SC_LOGITS)
graph_equals_eager(f"{ARCH} fp, first {SC8.n_layers} layers, axle, spec "
                   f"{SC_DRAFT}", g_srv, g_toks, g_launches, g_dt, pair,
                   protocol="axle", stream=True, draft_arch=SC_DRAFT,
                   cfg=SC8, **SPEC)
print(f"[spec] {ARCH} fp, the 2 requests: spec tokens {g_agree} non-spec; "
      f"profile, padded twin and graph == eager phase {lap():.1f} s", flush=True)
del g_srv

# the whole-target self-draft computes what the target does (its steps
# run padded to the verify's rows): every greedy draft is accepted;
# budgets of 1 + 12 rounds x (k + 1) tokens, so a row dies inside its
# second segment, where non-spec takes six
spec_rng = np.random.default_rng(1)       # the later phases keep `rng`
full_reqs = [Request(i, spec_rng.integers(1, cfg.vocab, int(
    spec_rng.integers(64, 201))).astype(np.int32), 1 + 12 * (SPEC_K + 1))
    for i in range(2)]
b_srv, b_toks, _, _ = serve(copies(full_reqs), protocol="axle", stream=True,
                            **SC)
base_tps = b_srv.tokens_emitted / b_srv.decode_syncs
del b_srv
f_srv, f_toks, _, f_dt = serve(copies(full_reqs), protocol="axle",
                               stream=True, draft_arch=f"self:{SC8.n_layers}",
                               **SC, **SPEC)
f_agree = near_tie_agrees("[spec] full-depth draft vs non-spec", f_toks,
                          b_toks, full_reqs, **SC_LOGITS)
check(f_srv.draft_accepted == f_srv.draft_proposed > 0,
      f"[spec] full-depth draft: accepted {f_srv.draft_accepted} of "
      f"{f_srv.draft_proposed}")
check(f_srv.tokens_emitted / f_srv.decode_syncs > base_tps,
      "[spec] full-depth draft: tokens per sync not above non-spec")
spec_line(f"{ARCH} fp (its first {SC8.n_layers} layers), draft "
          f"self:{SC8.n_layers} (the whole target), 2 requests x "
          f"{full_reqs[0].max_new} tokens, tokens {f_agree} non-spec", f_srv,
          f_toks, f_dt, base_tps)
del f_srv

# sampled: the [sampling] request set under speculation, request 1
# stopping at the EOS id or the 10th token of its greedy spec stream
SC_STOPS = (cfg.eos_token, sp_toks[1][9])
_, s8_toks, _, _ = serve(sampled_requests(SC_STOPS), protocol="axle",
                         stream=True, **SC)
ss_srv, ss_toks, _, ss_dt = serve(sampled_requests(SC_STOPS),
                                  protocol="axle", stream=True,
                                  draft_arch=SC_DRAFT, **SC, **SPEC)
ss_rate = ss_srv.draft_accepted / max(1, ss_srv.draft_proposed)
del ss_srv
_, ss_rounds1, _, _ = serve(sampled_requests(SC_STOPS), protocol="axle",
                            stream=False, draft_arch=SC_DRAFT, **SC, **SPEC)
check(ss_rounds1 == ss_toks, "[spec] sampled: seg_len 8 != 1 round a "
      "segment")
alone_srv = BatchedServer(ARCH, smoke=False, device="cuda", batch_slots=4,
                          max_seq=S, seg_len=8, protocol="axle", stream=True,
                          draft_arch=SC_DRAFT, **SC, **SPEC)
for r in sampled_requests(SC_STOPS)[:2]:   # one sampled, one greedy, stops
    alone_srv.submit(r)
    alone_srv.run_until_drained()
alone = {r.rid: r.generated for r in alone_srv.completed}
check(alone_srv.graph_replays == alone_srv.segments_dispatched,
      "[spec] sampled alone: a segment was not a graph replay")
del alone_srv
check(alone == {rid: ss_toks[rid] for rid in alone}, "[spec] sampled: a "
      "request alone != its row in the batch")
for rid, toks in ss_toks.items():
    check(all(0 <= t < cfg.vocab for t in toks), "[spec] id >= vocab")
    if rid == 1:
        check(toks[-1] in SC_STOPS and toks == sp_toks[1][:len(toks)],
              f"[spec] request 1 did not stop as its greedy stream says: "
              f"{toks}")
    elif rid % 2:
        check(toks == sp_toks[rid],
              f"[spec] sampled serve: greedy request {rid} != the greedy "
              "spec serve's")
    else:
        check(len(toks) == 64, f"[spec] request {rid}: short stream")
print(f"[spec] {ARCH} sampled (its first {SC8.n_layers} layers), the 8 "
      f"[sampling] requests, draft {SC_DRAFT}: "
      f"{sum(len(t) for t in ss_toks.values())} tokens in {ss_dt:.3f} s; "
      f"accept rate {ss_rate:.4f}; seg_len 8 == 1 round a segment, and "
      "requests 0 (sampled) and 1 (greedy, stops) alone == in the batch, "
      "bitwise; budgets and stops hold (request 1 stopped "
      f"at token {len(ss_toks[1])}); greedy rows == the greedy spec "
      f"serve's; {sum(ss_toks[r] != s8_toks[r] for r in ss_toks if r % 2 == 0)}"
      " of 4 sampled streams differ from the non-spec sampled serve's "
      "(spec draws once a round, non-spec once a token); phase "
      f"{lap():.1f} s, {time.perf_counter() - T_START:.0f} s into the "
      "script", flush=True)
del params, SC, SC_LOGITS

# --------------------------------------------------------------------------
# 5b. serve: the quantized starcoder2_3b path at full width
# --------------------------------------------------------------------------

phase("5b")

Q8_INT8 = QuantConfig(weights="q8_0", kv="int8")
n_proj = 7                   # wq wk wv wo w_gate w_up w_down in every layer
q_reqs = make_requests(8, 64, 400, 64)
srv, q_toks, launches, dt = serve(q_reqs, protocol="axle", stream=True,
                                  quant=Q8_INT8)
forwards = srv.steps + srv.prefill_forwards
check(launches["quant_matmul[q8_0]"] == forwards * n_proj * n_layers
      and launches["quant_matmul[q8_0]_tc"]
      == srv.prefill_forwards * n_proj * n_layers,
      f"quant_matmul launches {launches} != {forwards} forwards x "
      f"{n_proj} x {n_layers}, the {srv.prefill_forwards} prefills' all on "
      "the tensor-core kernel")
check(launches["quant_matmul[q8_0]_skinny"] == srv.steps * n_proj * n_layers
      and launches["quant_matmul[q8_0]_splitk"]
      <= launches["quant_matmul[q8_0]_tc"],
      f"quant_matmul launches {launches}: the {srv.steps} decode steps' not "
      "all on the one-launch skinny kernel, or a split-K pass outside the "
      "prefills")
check(launches["decode_attention_fused[int8]"] == srv.steps * n_layers
      and launches["decode_attention_fused[int8]_tc"]
      == launches["decode_attention_fused[int8]"],
      f"int8 fused launches {launches} != {srv.steps} steps x {n_layers}, "
      "all on the tensor-core split")
check(launches["flash_attention"] == srv.prefill_forwards * n_layers
      and launches["flash_attention_tc"] == launches["flash_attention"],
      f"flash launches {launches} != {srv.prefill_forwards} x {n_layers}, "
      "all on the tensor-core kernel")
check(launches["decode_attention_fused"] == 0
      and launches["quant_matmul[q4_k]"] == 0, f"fp kernels ran: {launches}")
check(srv.cache["k0"].dtype == torch.int8 and "kscale0" in srv.cache,
      "the quantized serve's KV pools are not int8")
q_params = srv.params
q_bytes = sum(w.nbytes for blk in q_params["blocks"] for sub in blk.values()
              for w in sub.values() if isinstance(w, kquant.QTensor))
fp_bytes = sum(w.numel() * w.element_size() for w in
               [q_params["embed"], q_params["final_ln"]]
               + [w for blk in q_params["blocks"] for sub in blk.values()
                  for w in sub.values() if isinstance(w, torch.Tensor)])
serve_line(ARCH, "axle, q8_0 weights + int8 KV", srv, q_toks, launches, dt)
print(f"[serve] {ARCH} q8_0: quant_matmul by route: skinny (decode, one "
      f"launch each) {launches['quant_matmul[q8_0]_skinny']}, tensor-core "
      f"(prefill) {launches['quant_matmul[q8_0]_tc']}, tiled 0; split-K "
      f"passes {launches['quant_matmul[q8_0]_splitk']}, all in prefills",
      flush=True)
print(f"[serve] {ARCH} q8_0: weight bytes resident {q_bytes / 1e9:.3f} GB "
      f"of quants and scales in the {n_proj * n_layers} projection "
      f"matrices, plus "
      f"{fp_bytes / 1e9:.3f} GB fp (embedding, norms); int8 KV pools and "
      f"scales {sum(t.numel() * t.element_size() for k, t in srv.cache.items() if k[0] in 'kv') / 1e9:.3f} GB",
      flush=True)
quant_launches = launches
graph_equals_eager(f"{ARCH} q8_0 + int8 KV, axle", srv, q_toks, launches,
                   dt, q_reqs, protocol="axle", stream=True,
                   quant=QuantConfig(kv="int8"))
replay_profile(srv, f"{ARCH} q8_0 + int8 KV")
del srv
profile(ARCH, q_params, cfg.vocab, label=" q8_0 + int8 KV",
        quant=QuantConfig(kv="int8"))
# the quantized weights of that run, with an int8 cache, for what follows
INT8 = dict(quant=QuantConfig(kv="int8"))
q_streamed = streamed_equals_per_token(ARCH, q_params, pair,
                                       label=" q8_0 + int8 KV", **INT8)
_, q_rp_toks, q_rp_launches, _ = serve(copies(pair), params=q_params,
                                       protocol="rp", stream=True, **INT8)
# the rp path dequantizes int8 pools up front and takes q to f32 with them
# (core/backstream.py), so its partials run the f32 CUDA-core split
check(q_rp_launches["decode_attention_partial"] > 0
      and q_rp_launches["decode_attention_partial_tc"] == 0
      and q_rp_launches["decode_attention_fused[int8]"] == 0
      and q_rp_launches["quant_matmul[q8_0]"] > 0,
      f"quantized rp run launches {q_rp_launches}")
print(f"[reference] {ARCH} q8_0 + int8 KV, protocol rp (pools dequantized up "
      f"front), same 2 requests: launches {q_rp_launches}; tokens "
      f"{near_tie_agrees('quantized rp vs axle', q_rp_toks, q_streamed, pair, weights=q_params, kv_quant='int8')}"
      " the axle run's", flush=True)

# speculation over the quantized weights and the int8 cache, on the
# target's first 8 layers (views of the quantized stacks), as section 5c
# runs the fp spec serves: the draft (self:7) is sliced from them and
# keeps an fp cache; its tokens are set beside a non-spec serve of the
# same 8 layers
lap()
SQ = dict(params=self_draft_params(cfg, q_params, SC8.n_layers), cfg=SC8)
sq_layers = SC8.n_layers
_, sq_plain_toks, _, _ = serve(copies(pair), protocol="axle", stream=True,
                               **SQ, **INT8)
sq_srv, sq_toks, sq_launches, sq_dt = serve(
    copies(pair), protocol="axle", stream=True, draft_arch="self:7",
    **SQ, **INT8, **SPEC)
rounds = spec_rounds(sq_srv)
d_layers = sq_srv.draft_cfg.n_layers
check(sq_launches["quant_matmul[q8_0]_skinny"]
      == rounds * n_proj * ((SPEC_K + 1) * d_layers + sq_layers)
      and sq_launches["quant_matmul[q8_0]_tc"]
      == sq_srv.prefill_forwards * n_proj * (sq_layers + d_layers)
      and sq_launches["quant_matmul[q8_0]"]
      == sq_launches["quant_matmul[q8_0]_skinny"]
      + sq_launches["quant_matmul[q8_0]_tc"]
      and sq_launches["quant_matmul[q8_0]_splitk"]
      <= sq_launches["quant_matmul[q8_0]_tc"],
      f"[spec] quantized launches {sq_launches}: not every draft and "
      f"verify product ({rounds} rounds x {n_proj} x ({SPEC_K + 1} x "
      f"{d_layers} + {sq_layers})) on the skinny kernel, or a split-K pass "
      "outside the prefills")
check(sq_launches["decode_attention_fused[int8]"]
      == rounds * (SPEC_K + 1) * sq_layers
      and sq_launches["decode_attention_fused"]
      == rounds * (SPEC_K + 1) * d_layers,
      f"[spec] quantized decode launches {sq_launches}: not {rounds} rounds "
      f"x {SPEC_K + 1} x ({sq_layers} int8 verify + {d_layers} fp draft)")
graph_equals_eager(f"{ARCH} q8_0 + int8 KV (its first {sq_layers} "
                   "layers), spec self:7", sq_srv, sq_toks, sq_launches,
                   sq_dt, pair, protocol="axle", stream=True,
                   draft_arch="self:7", cfg=SC8, **INT8, **SPEC)
print(f"[spec] {ARCH} q8_0 + int8 KV (its first {sq_layers} layers), draft "
      f"self:7 (q8_0 views, fp KV), 2 "
      f"requests x 16 tokens: every draft and verify product on the skinny "
      f"kernel ({sq_launches['quant_matmul[q8_0]_skinny']} launches, the "
      f"verify's at m = {4 * (SPEC_K + 1)}), split-K passes "
      f"{sq_launches['quant_matmul[q8_0]_splitk']} all in prefills; accept "
      f"rate {sq_srv.draft_accepted / max(1, sq_srv.draft_proposed):.4f}; "
      f"tokens vs the non-spec serve of those layers: {describe(partings(sq_toks, sq_plain_toks, pair, arch_cfg=SC8, weights=SQ['params'], kv_quant='int8')) or 'equal'}"
      " (not required: the reference's own spec stream parts from its "
      f"non-spec one under an int8 cache); phase {lap():.1f} s, "
      f"{time.perf_counter() - T_START:.0f} s into the script", flush=True)
del sq_srv, SQ

# bf16: every quant_matmul and int8 fused-decode launch of the served
# model against its plain version on that launch's own inputs (these
# comparison launches are outside any serve run)
q_prompts = [r.prompt for r in make_requests(4, 64, 400, 1)]
held_q = {"quant_matmul[q8_0]": [], "decode_attention_fused[int8]": []}
served_kernels = (kquant.quant_matmul, fa.decode_attention_fused)


def held_quant_matmul(x, qt):
    got = served_kernels[0](x, qt)
    held_q["quant_matmul[q8_0]"].append(quant_err(got, x, qt))
    return got


def held_decode(q, k, v, pos, extra=None, *, window=0, blk_c=128,
                pages=None, kv_scales=None):
    got = served_kernels[1](q, k, v, pos, extra, window=window, blk_c=blk_c,
                            pages=pages, kv_scales=kv_scales)
    plain = ref.decode_fused_reference(
        q, k, v, pos, extra, window=window, pages=pages,
        page_size=blk_c if pages is not None else 0, kv_scales=kv_scales)
    err = (got.float() - plain.float()).abs().max().item()
    check(err <= ATOL_BF16, f"served int8 fused decode: err {err}")
    held_q["decode_attention_fused[int8]"].append(err)
    return got


kquant.quant_matmul, fa.decode_attention_fused = held_quant_matmul, \
    held_decode
kern = logits_along(q_prompts, 4, False, weights=q_params, kv_quant="int8")
kquant.quant_matmul, fa.decode_attention_fused = served_kernels
plain = logits_along(q_prompts, 4, True, weights=q_params, kv_quant="int8")
check(len(held_q["quant_matmul[q8_0]"])
      == (len(q_prompts) + 4) * n_proj * n_layers
      and len(held_q["decode_attention_fused[int8]"]) == 4 * n_layers,
      f"held launches: { {k: len(v) for k, v in held_q.items()} }")
apart = max((a - b).abs().max().item() for a, b in zip(kern, plain))
print(f"[reference] {ARCH} q8_0 + int8 KV full width, bf16, "
      f"{len(q_prompts)} rows: each of the "
      f"{len(held_q['quant_matmul[q8_0]'])} quant_matmul launches against "
      f"the plain version on its own inputs: max_abs_err "
      f"{max(held_q['quant_matmul[q8_0]']):.3g} (<= 1e-5 (|x|@|W|) + 1 bf16 "
      f"unit); each of the {len(held_q['decode_attention_fused[int8]'])} "
      f"int8 fused decodes: max_abs_err "
      f"{max(held_q['decode_attention_fused[int8]']):.3g} <= {ATOL_BF16}; "
      f"logits after prefill + 4 decode steps part by {apart:.4g} (not "
      "gated: the random-weight stack amplifies one-unit bf16 differences)",
      flush=True)
del kern, plain


def as_f32(tree):
    """The same weights in f32 arithmetic (a QTensor's scales are f32
    already; its quants stay as they are)."""
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    if isinstance(tree, kquant.QTensor):
        return tree
    return tree.float()


cfg32 = dataclasses.replace(cfg, dtype="float32")
for kvq in (None, "int8"):
    kernels_against_plain(
        f"{ARCH} q8_0 + {kvq or 'fp'} KV in f32 arithmetic", q_prompts,
        atol=LOGIT_ATOL_F32, arch_cfg=cfg32, weights=as_f32(q_params),
        kv_quant=kvq)
del q_params

# q4_k: its own weights from seed 0, quantized at construction
srv, q4_toks, q4_launches, _ = serve(copies(pair), protocol="axle",
                                     stream=True,
                                     quant=QuantConfig(weights="q4_k",
                                                       kv="int8"))
check(q4_launches["quant_matmul[q4_k]"] > 0
      and q4_launches["quant_matmul[q4_k]_tc"]
      == srv.prefill_forwards * n_proj * n_layers
      and q4_launches["quant_matmul[q4_k]_skinny"]
      == q4_launches["quant_matmul[q4_k]"]
      - q4_launches["quant_matmul[q4_k]_tc"]
      and q4_launches["quant_matmul[q4_k]_splitk"]
      <= q4_launches["quant_matmul[q4_k]_tc"]
      and q4_launches["quant_matmul[q8_0]"] == 0
      and q4_launches["decode_attention_fused[int8]"] > 0
      and q4_launches["decode_attention_fused[int8]_tc"]
      == q4_launches["decode_attention_fused[int8]"],
      f"q4_k run launches {q4_launches}: the prefills' quant_matmul and the "
      "decodes not all on the tensor cores")
del srv
check(all(len(t) == 16 for t in q4_toks.values()), "q4_k: short stream")
print(f"[serve] {ARCH} full width, axle, q4_k weights + int8 KV, 2 requests "
      f"x 16 tokens: launches {q4_launches}", flush=True)

# --------------------------------------------------------------------------
# 6. serve: the mamba2_370m path at full width, on its first 24 of 48
# layers (a cut of depth that leaves every check of the section; the
# [tier] and [chunked] phases serve all 48)
# --------------------------------------------------------------------------

phase("6")

mcfg6 = dataclasses.replace(mcfg, arch_id=f"{MAMBA}_first24", n_layers=24)
M6 = dict(arch=MAMBA, cfg=mcfg6)
M6_LABEL = f"{MAMBA} (its first 24 of 48 layers)"
mamba_reqs = make_requests(8, 64, 400, 64, mcfg.vocab)
srv, mamba_toks, launches, dt = serve(mamba_reqs, protocol="axle",
                                      stream=True, **M6)
check("page_table" not in srv.cache, "mamba cache has a page table")
check(launches["ssd_scan"] == srv.prefill_forwards * mcfg6.n_layers,
      f"ssd_scan launches {launches} != {srv.prefill_forwards} x "
      f"{mcfg6.n_layers}")
check(launches["ssd_scan_tc"] == launches["ssd_scan"],
      f"ssd_scan launches {launches}: not all on the tensor-core route")
check(all(n == 0 for k, n in launches.items()
          if k not in ("ssd_scan", "ssd_scan_tc")),
      f"an attention kernel launched in the mamba run: {launches}")
serve_line(M6_LABEL, "axle", srv, mamba_toks, launches, dt)
mamba_launches = launches
mparams = srv.params
graph_equals_eager(f"{M6_LABEL}, axle", srv, mamba_toks, launches, dt,
                   mamba_reqs, protocol="axle", stream=True, **M6)
replay_profile(srv, MAMBA)
mamba_dt, mamba_syncs = dt, srv.decode_syncs
del srv
torch.cuda.reset_peak_memory_stats()
lap()
sm_srv, sm_toks, sm_launches, sm_dt = serve(
    copies(mamba_reqs), params=mparams, protocol="axle",
    stream=True, draft_arch="self:12", **SPEC, **M6)
d_layers = sm_srv.draft_cfg.n_layers
check(sm_launches["ssd_scan"]
      == sm_srv.prefill_forwards * (mcfg6.n_layers + d_layers)
      and all(n == 0 for k, n in sm_launches.items()
              if not k.startswith("ssd_scan")),
      f"[spec] mamba launches {sm_launches}")
spec_line(f"{M6_LABEL}, draft self:12, spec_k {SPEC_K}, the 8 [serve] "
          "requests, seg_len 8 rounds", sm_srv, sm_toks, sm_dt,
          sum(len(t) for t in mamba_toks.values()) / mamba_syncs, mamba_dt)
del sm_srv
check(sm_toks == padded_twin(mamba_reqs, params=mparams,
                             protocol="axle", stream=True, **M6),
      "[spec] mamba greedy spec tokens != the non-spec serve's at the "
      "verify's row count")
# against the unpadded [serve] stream, printed and not gated: 48 bf16
# layers turn a last-bit difference into logit gaps of order 1 (PERF.md,
# PR 12), so a parting need not sit at a near tie
sm_parts = [(r.rid, next(i for i, (x, y) in enumerate(
    zip(sm_toks[r.rid], mamba_toks[r.rid])) if x != y))
    for r in mamba_reqs if sm_toks[r.rid] != mamba_toks[r.rid]]
print(f"[spec] {MAMBA}: tokens == the non-spec serve's at the verify's row "
      "count, bitwise; (request, token) where they part from the [serve] "
      f"greedy tokens: {sm_parts}", flush=True)
m_pair = [Request(i, spec_rng.integers(1, mcfg.vocab, int(
    spec_rng.integers(64, 201))).astype(np.int32), 16) for i in range(2)]
g_srv, g_toks, g_launches, g_dt = serve(
    copies(m_pair), params=mparams, protocol="axle",
    stream=True, draft_arch="self:12", **SPEC, **M6)
graph_equals_eager(f"{M6_LABEL}, spec self:12", g_srv, g_toks, g_launches,
                   g_dt, m_pair, protocol="axle", stream=True,
                   draft_arch="self:12", **SPEC, **M6)
print(f"[spec] {MAMBA}: graph == eager phase {lap():.1f} s", flush=True)
del g_srv
profile(MAMBA, mparams, mcfg.vocab, cfg=mcfg6)
streamed_equals_per_token(MAMBA, mparams,
                          make_requests(2, 64, 200, 16, mcfg.vocab),
                          cfg=mcfg6)
# prompts of 64-200 tokens: the plain scan steps through every token
mprompts = [r.prompt for r in make_requests(4, 64, 200, 1, mcfg.vocab)]
# bf16: each layer's scan of the served model against the plain version
# on the same inputs (these comparison launches are outside any serve run)
held = []


def held_scan(*args):
    got = kssd.ssd_scan(*args)
    held.append(ssd_err(got, ref.ssd_reference(*args), args[0].dtype))
    return got


served_scan = ops.ssd_scan
ops.ssd_scan = held_scan
kern = logits_along(mprompts, 4, False, arch_cfg=mcfg6, weights=mparams)
ops.ssd_scan = served_scan
check(len(held) == len(mprompts) * mcfg6.n_layers,
      f"{len(held)} scans held")
plain = logits_along(mprompts, 4, True, arch_cfg=mcfg6, weights=mparams)
apart = max((a - b).abs().max().item() for a, b in zip(kern, plain))
print(f"[reference] {M6_LABEL} full width, bf16, {len(mprompts)} rows: each of "
      f"the {len(held)} prefill scans against the plain version on its own "
      f"inputs: max_abs_err {max(held):.3g} (<= 1e-3 + rtol |plain|); "
      f"logits after prefill + 4 decode steps part by {apart:.4g} "
      "(not gated: the random-weight stack amplifies one-unit bf16 "
      "differences)", flush=True)


kernels_against_plain(f"{M6_LABEL} in f32 arithmetic", mprompts,
                      atol=LOGIT_ATOL_F32,
                      arch_cfg=dataclasses.replace(mcfg6, dtype="float32"),
                      weights=as_f32(mparams))

# --------------------------------------------------------------------------
# 6b. the other dense attention archs at full width: gemma3_12b's
# sliding-window layers, mistral_nemo_12b through the ported serve_offload
# example, opt_2_7b, minitron_4b, qwen2_vl_2b; each phase frees its model
# before the next
# --------------------------------------------------------------------------

phase("6b")

ARCHS_T0 = time.perf_counter()


def arch_requests(vocab, lens, max_new, seed):
    r = np.random.default_rng(seed)
    return [Request(i, r.integers(1, vocab, n).astype(np.int32), max_new)
            for i, n in enumerate(lens)]


def attention_launches(label, srv, launches, n_layers, tc,
                       decode="decode_attention_fused", tag="[archs]"):
    """Every decode step ran one fused decode a layer (`decode`: the fp or
    the int8 one) and every prefill one flash call a layer, all on the
    tensor-core kernels (tc) or none; `n_layers` counts the attention
    layers."""
    for name, per in ((decode, srv.steps),
                      ("flash_attention", srv.prefill_forwards)):
        check(launches[name] == per * n_layers
              and launches[name + "_tc"] == launches[name] * int(tc),
              f"{tag} {label}: {name} launches {launches[name]} "
              f"({launches[name + '_tc']} on the tensor cores) != {per} x "
              f"{n_layers}, {'all' if tc else 'none'} on the tensor cores")


def arch_line(label, srv, toks, dt, parts, weights, t0, tag="[archs]"):
    """tok/s, the decode step's device time and kernels (one replay of
    the one-step greedy segment under the profiler), the weight-read bound
    of a step, peak memory, the phase's seconds."""
    n_tok = sum(len(t) for t in toks.values())
    step = parts["step_plain_fn"]
    bound = weights / HBM_BYTES_PER_S * 1e3
    print(f"{tag} {label}: {len(toks)} requests, {n_tok} tokens in "
          f"{dt:.3f} s = {n_tok / dt:.1f} tok/s, every segment a graph "
          f"replay; decode step {step['device_ms']:.3f} ms device, "
          f"{step['kernels']:.0f} kernels ({step['launches']} of ours) a "
          f"step; weight-read bound {bound:.3f} ms a step "
          f"({weights / 1e9:.3f} GB): {step['device_ms'] / bound:.2f}x it; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; phase {time.perf_counter() - t0:.1f} s", flush=True)


# gemma3_12b: 8 requests, two prompts past the 1024-token window (the
# prefill masks) and two that cross position 1024 while decoding 64 tokens
# (the decode window moves); 4 slots of 2048 positions
G3, G3_SEQ = "gemma3_12b", 2048
G3_LENS = (1500, 980, 600, 1100, 1000, 700, 1300, 800)
t0 = time.perf_counter()
torch.cuda.reset_peak_memory_stats()
g3_reqs = arch_requests(g3cfg.vocab, G3_LENS, 64, 20)
srv, g3_toks, g3_launches, dt = serve(g3_reqs, arch=G3, max_seq=G3_SEQ,
                                      protocol="axle", stream=True)
attention_launches(G3, srv, g3_launches, g3cfg.n_layers, True)
check(all(len(t) == 64 for t in g3_toks.values()), f"{G3}: short stream")
g3_params = srv.params
parts, weights = replay_profile(srv, f"{G3}, axle", steps_only=True)
arch_line(f"{G3} full width, axle, streamed, prompts {G3_LENS}, max_new 64, "
          f"4 slots, max_seq {G3_SEQ}, seg_len 8", srv, g3_toks, dt, parts,
          weights, t0)
del srv
# request 1 (980 tokens, decoding across position 1024) alone in a fresh
# server == its row in the batch
alone_srv = BatchedServer(G3, smoke=False, device="cuda", batch_slots=4,
                          max_seq=G3_SEQ, seg_len=8, params=g3_params,
                          protocol="axle", stream=True)
alone_srv.submit(copies(g3_reqs[1:2])[0])
alone_srv.run_until_drained()
check(alone_srv.completed[0].generated == g3_toks[1],
      f"[archs] {G3}: request 1 alone != its row in the batch")
del alone_srv
g3_pair = arch_requests(g3cfg.vocab, (1015, 1100), 16, 21)
srv, toks, launches, dt = serve(g3_pair, params=g3_params, arch=G3,
                                max_seq=G3_SEQ, protocol="axle", stream=True)
graph_equals_eager(f"{G3}, axle, prompts 1015 (decoding across 1024) and "
                   "1100", srv, toks, launches, dt, g3_pair, arch=G3,
                   max_seq=G3_SEQ, protocol="axle", stream=True)
del srv
# logits against the plain path: prompts of W - 2 and W + 76 tokens (W =
# 1024, the window), then 4 decode steps (row 0 at positions W - 2 ..
# W + 1, across the window's edge)
W = g3cfg.sliding_window
g3_prompts = [r.prompt for r in arch_requests(g3cfg.vocab, (W - 2, W + 76),
                                              1, 22)]
g3_kern, g3_feed = kernels_against_plain(
    f"{G3} (window {W})", g3_prompts, arch_cfg=g3cfg, weights=g3_params,
    max_seq=G3_SEQ)
# the window bites: the same weights and tokens with every layer "full"
# give the same bits while a row's positions lie inside the window (row 0's
# prefill and its steps at W - 2, W - 1) and other logits past it
nowin = logits_along(g3_prompts, 4, False, weights=g3_params,
                     arch_cfg=dataclasses.replace(
                         g3cfg, block_pattern=("full",) * 6),
                     max_seq=G3_SEQ, feed=g3_feed)
inside = [torch.equal(a[0], b[0]) for a, b in zip(g3_kern, nowin)]
apart = [(a[1] - b[1]).abs().max().item() for a, b in zip(g3_kern, nowin)]
apart0 = [(a[0] - b[0]).abs().max().item() for a, b in zip(g3_kern, nowin)]
check(inside == [True, True, True, False, False],
      f"[archs] {G3}: row 0 equal to the window-free run at (prefill, "
      f"{W - 2}, {W - 1}, {W}, {W + 1}): {inside}")
check(all(x > 0 for x in apart), f"[archs] {G3}: row 1 ({W + 76} tokens) "
      f"not changed by the window: {apart}")
print(f"[archs] {G3}: the window bites: with every layer \"full\" on the "
      f"same weights and tokens, row 0 ({W - 2} tokens) keeps its bits at "
      f"the prefill and at positions {W - 2}, {W - 1} and parts at {W}, "
      f"{W + 1} (by {apart0[3]:.4g}, {apart0[4]:.4g}); row 1 ({W + 76} "
      f"tokens) parts at the prefill and every step (by "
      f"{', '.join(f'{x:.4g}' for x in apart)}); "
      f"request 1 alone == its row in the batch, bitwise; "
      f"{G3} phase {time.perf_counter() - t0:.1f} s", flush=True)
# chunked admission across the window: two 1,500-token prompts x 16 in
# chunks of 512 (3 each; the later chunks resume over the restored rows
# under the window), against the one-shot serve of the same
G3_LONG, G3_CHUNK = 1500, 512
g3_long = arch_requests(g3cfg.vocab, (G3_LONG, G3_LONG), 16, 23)
t0 = time.perf_counter()
srv, g3c_toks, g3c_launches, g3c_dt = serve(
    g3_long, params=g3_params, arch=G3, max_seq=G3_SEQ, protocol="axle",
    stream=True, prefill_chunk=G3_CHUNK)
check(srv.prefill_chunks == 2 * -(-G3_LONG // G3_CHUNK)
      and g3c_launches["flash_attention"] == 2 * g3cfg.n_layers
      == g3c_launches["flash_attention_tc"],
      f"[archs] {G3} chunked: {srv.prefill_chunks} chunks, launches "
      f"{g3c_launches}")
g3c_host = srv.prefill_chunk_time / srv.prefill_chunks * 1e3
del srv
_, g3o_toks, _, g3o_dt = serve(copies(g3_long), params=g3_params, arch=G3,
                               max_seq=G3_SEQ, protocol="axle", stream=True)
g3c_vs = near_tie_agrees(f"[archs] {G3} chunked vs one-shot", g3c_toks,
                         g3o_toks, g3_long, arch_cfg=g3cfg,
                         weights=g3_params, max_seq=G3_SEQ)
print(f"[chunked] {G3}: two {G3_LONG}-token prompts x 16 in chunks of "
      f"{G3_CHUNK} ({2 * -(-G3_LONG // G3_CHUNK)} chunks, the first of each "
      f"through the flash kernel: "
      f"{g3c_launches['flash_attention']} launches, the rest resumed across "
      f"the {W}-token window): tokens {g3c_vs} the one-shot serve's "
      f"(near-tie gate {NEAR_TIE}); a chunk's host dispatch {g3c_host:.2f} "
      f"ms (mean); {g3c_dt:.3f} s chunked, {g3o_dt:.3f} s one-shot; phase "
      f"{time.perf_counter() - t0:.1f} s", flush=True)

# gemma3_12b through the routes no other serve runs at hd 256: an int8 KV
# cache (the int8 fused decode under the moving window, per-page scales),
# rp over the fp cache (the hd 256 partial) and over the int8 cache (the
# pools dequantized up front, q in f32: the CUDA-core partial), then
# prompts past 2,048 positions at max_seq 4096.  Four of the [archs]
# requests, 48 new tokens, so that the 980- and 1,000-token prompts both
# decode across position 1024
t0 = time.perf_counter()
G3_NEW = 48
g3_four = [Request(r.rid, r.prompt, G3_NEW) for r in g3_reqs
           if len(r.prompt) in (1500, 980, 600, 1000)]
G3_KW = dict(arch=G3, max_seq=G3_SEQ, stream=True)


def step_ops(replays=3, **kw):
    """A greedy decode step of a fresh gemma3_12b EagerServer (`kw`: its
    protocol and quant) run under the profiler: device ms by the PyTorch
    op that launched each kernel (a graph replay shows kernels, not ops;
    our kernels, launched through ctypes, have no op and are left out)."""
    e = EagerServer(G3, smoke=False, device="cuda", batch_slots=4,
                    max_seq=G3_SEQ, seg_len=8, params=g3_params, stream=True,
                    **kw)
    args = segment_args(e)
    with e.segment_scope():          # its protocol, as a segment runs
        e.step_plain_fn(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(replays):
                e.step_plain_fn(*args)
            torch.cuda.synchronize()
    del e
    return {ev.key: ev.self_device_time_total / (replays * 1e3)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CPU
            and ev.self_device_time_total > 0}


def step_delta(label, by_op, base):
    """The ops that add most to an eager step's device ms over `base`'s."""
    d = sorted(((by_op.get(k, 0.0) - base.get(k, 0.0), k)
                for k in set(by_op) | set(base)), reverse=True)
    print(f"[archs] {label}: an eager greedy step's PyTorch ops "
          f"{sum(by_op.values()):.3f} ms device against the fp axle "
          f"step's {sum(base.values()):.3f}; most added, by op: " + "; ".join(
              f"{k} {t:+.3f} ms" for t, k in d[:6]), flush=True)


_, g3_fp, _, _ = serve(copies(g3_four), params=g3_params, protocol="axle",
                       **G3_KW)
fp_by_op = step_ops(protocol="axle")
# 1. the int8 KV cache under axle, streamed
torch.cuda.reset_peak_memory_stats()
srv, g3_i8, i8_launches_g3, dt = serve(copies(g3_four), params=g3_params,
                                       protocol="axle", **INT8, **G3_KW)
attention_launches(f"{G3} int8 KV", srv, i8_launches_g3, g3cfg.n_layers,
                   True, decode="decode_attention_fused[int8]")
check(i8_launches_g3["decode_attention_fused"] == 0
      and srv.cache["k0"].dtype == torch.int8
      and all(len(t) == G3_NEW for t in g3_i8.values()),
      f"[archs] {G3} int8 KV: launches {i8_launches_g3}, cache "
      f"{srv.cache['k0'].dtype}")
i8_bytes = sum(nbytes(t) for k, t in srv.cache.items() if k[0] in "kv")
bf16_bytes = sum(t.numel() * 2 for k, t in srv.cache.items()
                 if k[0] in "kv" and k[1:].isdigit())
check(i8_bytes <= 0.55 * bf16_bytes, f"[archs] {G3} int8 KV: {i8_bytes} B "
      f"of pools and scales against {bf16_bytes} B of bf16 pools")
graph_equals_eager(f"{G3} int8 KV, axle", srv, g3_i8, i8_launches_g3, dt,
                   g3_four, protocol="axle", **INT8, **G3_KW)
parts, weights = replay_profile(srv, f"{G3} int8 KV, axle", steps_only=True)
step_delta(f"{G3} int8 KV", step_ops(protocol="axle", **INT8), fp_by_op)
arch_line(f"{G3} full width, int8 KV, axle, streamed, prompts "
          f"{tuple(len(r.prompt) for r in g3_four)}, max_new {G3_NEW}, 4 "
          f"slots, max_seq {G3_SEQ}, seg_len 8", srv, g3_i8, dt, parts,
          weights, t0)
del srv
_, g3_i8_pt, _, _ = serve(copies(g3_four), params=g3_params,
                          protocol="axle", **INT8,
                          **dict(G3_KW, stream=False))
check(g3_i8_pt == g3_i8, f"[archs] {G3} int8 KV: streamed != per-token")
# logits against the plain path over the int8 cache, across the window's
# edge, with each int8 fused decode of the kernel path held to its plain
# version on its own inputs (held_decode, section 5b)
held_q["decode_attention_fused[int8]"] = []
fa.decode_attention_fused = held_decode
try:
    kernels_against_plain(f"{G3} int8 KV (window {W})", g3_prompts,
                          arch_cfg=g3cfg, weights=g3_params,
                          max_seq=G3_SEQ, kv_quant="int8")
finally:
    fa.decode_attention_fused = served_kernels[1]
g3_held = held_q["decode_attention_fused[int8]"]
check(len(g3_held) == 4 * g3cfg.n_layers,
      f"[archs] {G3} int8 KV: {len(g3_held)} held decodes")
same = sum(g3_i8[r] == g3_fp[r] for r in g3_fp)
print(f"[archs] {G3} int8 KV: int8 fused launches "
      f"{routes_of(i8_launches_g3, 'decode_attention_fused[int8]')} = "
      f"{i8_launches_g3['decode_attention_fused[int8]'] // g3cfg.n_layers} "
      f"steps x {g3cfg.n_layers}, every one on the tensor-core split, no fp "
      f"fused decode; graphed == eager and streamed == per-token, bitwise; "
      f"each of the {len(g3_held)} int8 fused decodes of the logits run "
      f"within {max(g3_held):.3g} <= {ATOL_BF16} of its plain version; "
      f"pools and scales {i8_bytes / 1e9:.3f} GB against "
      f"{bf16_bytes / 1e9:.3f} GB of bf16 pools "
      f"({i8_bytes / bf16_bytes:.4f}x); {same} of {len(g3_fp)} streams "
      "equal to the fp cache's (not gated: int8 KV changes the logits)",
      flush=True)
# 2. rp over the fp cache: one chunk (chunks_per_shard 1), so its
# partials and merge give the fused route's bits (section 3a, rp vs bs)
t0 = time.perf_counter()
torch.cuda.reset_peak_memory_stats()
srv, g3_rp, rp_launches_g3, dt = serve(copies(g3_four), params=g3_params,
                                       protocol="rp", **G3_KW)
steps_g3 = srv.steps
check(rp_launches_g3["decode_attention_partial"] == steps_g3 * g3cfg.n_layers
      and rp_launches_g3["decode_attention_partial_tc"]
      == rp_launches_g3["decode_attention_partial"]
      and rp_launches_g3["decode_attention_fused"] == 0
      and rp_launches_g3["decode_attention_fused[int8]"] == 0,
      f"[archs] {G3} rp launches {rp_launches_g3}: not {steps_g3} steps x "
      f"{g3cfg.n_layers} partials on the tensor-core split")
rp_vs = near_tie_agrees(f"{G3} rp vs axle", g3_rp, g3_fp, g3_four,
                        arch_cfg=g3cfg, weights=g3_params, max_seq=G3_SEQ)
check(g3_rp == g3_fp, f"[archs] {G3}: rp tokens != axle's, {rp_vs}")
parts, weights = replay_profile(srv, f"{G3} rp", steps_only=True)
step_delta(f"{G3} rp", step_ops(protocol="rp"), fp_by_op)
arch_line(f"{G3} full width, rp (one chunk), fp KV, streamed, the same 4 "
          f"requests", srv, g3_rp, dt, parts, weights, t0)
del srv
print(f"[archs] {G3} rp: partial launches "
      f"{routes_of(rp_launches_g3, 'decode_attention_partial')} = "
      f"{steps_g3} steps x {g3cfg.n_layers}, all on the tensor-core split, "
      f"no fused decode; tokens {rp_vs} the axle serve's, bitwise",
      flush=True)
# 3. rp over the int8 cache: 2 of the requests x 16 tokens
g3_two = [Request(r.rid, r.prompt, 16) for r in g3_four
          if len(r.prompt) in (1500, 1000)]
_, g3_rp8, rp8_launches_g3, _ = serve(copies(g3_two), params=g3_params,
                                      protocol="rp", **INT8, **G3_KW)
check(rp8_launches_g3["decode_attention_partial"] > 0
      and rp8_launches_g3["decode_attention_partial_tc"] == 0
      and rp8_launches_g3["decode_attention_fused"] == 0
      and rp8_launches_g3["decode_attention_fused[int8]"] == 0,
      f"[archs] {G3} rp int8 launches {rp8_launches_g3}: the partials not "
      "all on the f32 CUDA-core split")
rp8_vs = near_tie_agrees(f"{G3} rp int8 vs axle int8", g3_rp8,
                         {r: g3_i8[r][:16] for r in g3_rp8}, g3_two,
                         arch_cfg=g3cfg, weights=g3_params, max_seq=G3_SEQ,
                         kv_quant="int8")
print(f"[archs] {G3} rp over the int8 cache (pools dequantized up front, q "
      f"in f32), 2 requests x 16 tokens: partial launches "
      f"{routes_of(rp8_launches_g3, 'decode_attention_partial')}, all on "
      f"the f32 CUDA-core split, no fused decode; tokens {rp8_vs} the int8 "
      f"axle serve's first 16 (near-tie gate {NEAR_TIE}); phase "
      f"{time.perf_counter() - t0:.1f} s", flush=True)
# 4. past 2,048 positions: 2 slots of 4096, prompts of 2,040 (decoding
# across 2,048) and 3,500 tokens x 16; the global layers' decode runs 64
# splits of 64 rows, flash_tc_kernel<256> prefills past S 2048
t0 = time.perf_counter()
torch.cuda.reset_peak_memory_stats()
G4_KW = dict(arch=G3, max_seq=G3_S4K, batch_slots=2, protocol="axle",
             stream=True)
g3_long4 = arch_requests(g3cfg.vocab, (2040, 3500), 16, 25)
srv, g3_4k, g3_4k_launches, dt = serve(g3_long4, params=g3_params, **G4_KW)
attention_launches(f"{G3} max_seq {G3_S4K}", srv, g3_4k_launches,
                   g3cfg.n_layers, True)
check(srv.prefill_forwards == 2
      and all(len(t) == 16 for t in g3_4k.values()),
      f"[archs] {G3} max_seq {G3_S4K}: {srv.prefill_forwards} prefills, "
      f"{ {r: len(t) for r, t in g3_4k.items()} } tokens")
graph_equals_eager(f"{G3} max_seq {G3_S4K}, prompts 2040 and 3500", srv,
                   g3_4k, g3_4k_launches, dt, g3_long4, **G4_KW)
del srv
alone_srv = BatchedServer(G3, smoke=False, device="cuda", batch_slots=2,
                          max_seq=G3_S4K, seg_len=8, params=g3_params,
                          protocol="axle", stream=True)
alone_srv.submit(copies(g3_long4[:1])[0])
alone_srv.run_until_drained()
check(alone_srv.completed[0].generated == g3_4k[0],
      f"[archs] {G3} max_seq {G3_S4K}: request 0 alone != its row")
del alone_srv
kernels_against_plain(f"{G3} max_seq {G3_S4K} (prompts 2040, 3500)",
                      [r.prompt for r in g3_long4], arch_cfg=g3cfg,
                      weights=g3_params, max_seq=G3_S4K)
print(f"[archs] {G3} max_seq {G3_S4K}, 2 slots, prompts 2040 and 3500 x 16: "
      f"flash launches {routes_of(g3_4k_launches, 'flash_attention')} (2 "
      f"prefills x {g3cfg.n_layers}), fused decodes "
      f"{routes_of(g3_4k_launches, 'decode_attention_fused')} "
      f"({g3_4k_launches['decode_attention_fused'] // g3cfg.n_layers} steps "
      f"x {g3cfg.n_layers}), all on the tensor cores; graphed == eager and "
      f"request 0 alone == its row, bitwise; peak device memory "
      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase "
      f"{time.perf_counter() - t0:.1f} s", flush=True)
del g3_params, g3_kern, nowin

# mistral_nemo_12b: the ported serve_offload example at full width (3
# slots, max_seq 128, chunks_per_shard 4, 6 requests x 12 tokens,
# per-token); bs and axle take the fused branch, rp the partials
t0 = time.perf_counter()
torch.cuda.reset_peak_memory_stats()
so_toks, so_launches, so_dt = {}, {}, {}
m_params = so_srv = None
for proto in ("bs", "axle", "rp"):
    kbuild.reset_launch_counts()     # the capture's warm-up steps count too
    so_toks[proto], srv, so_dt[proto] = serve_offload.serve_with(
        proto, device="cuda", full=True, params=m_params)
    so_launches[proto] = dict(kbuild.LAUNCHES)
    check(srv.graph_replays == srv.steps and len(so_toks[proto]) == 6
          and all(len(t) == 12 for t in so_toks[proto].values()),
          f"[archs] serve_offload {proto}: {srv.graph_replays} replays for "
          f"{srv.steps} steps, {len(so_toks[proto])} requests")
    fused, part = (so_launches[proto][k] for k in (
        "decode_attention_fused", "decode_attention_partial"))
    check((part == 0 and fused > 0
           and so_launches[proto]["decode_attention_fused_tc"] == fused)
          if proto != "rp" else
          (fused == 0 and part > 0
           and so_launches[proto]["decode_attention_partial_tc"] == part),
          f"[archs] serve_offload {proto}: launches {so_launches[proto]}")
    m_params = srv.params
    if proto == "axle":
        so_srv = srv
    del srv
check(so_toks["bs"] == so_toks["axle"],
      "[archs] serve_offload: bs != axle (the same fused branch)")
mcfg_m = get_config(serve_offload.ARCH)
rp_vs = near_tie_agrees("serve_offload rp vs bs", so_toks["rp"],
                        so_toks["bs"], so_srv.completed, arch_cfg=mcfg_m,
                        weights=m_params, max_seq=128)
parts, weights = replay_profile(so_srv, f"{serve_offload.ARCH}, axle "
                                "(serve_offload)", steps_only=True)
n_tok = sum(len(t) for t in so_toks["axle"].values())
print(f"[archs] {serve_offload.ARCH} full width, the serve_offload example "
      f"(3 slots, max_seq 128, chunks_per_shard 4, 6 requests x 12 tokens, "
      f"per-token): bs == axle bitwise; rp {rp_vs} bs; tok/s bs "
      f"{n_tok / so_dt['bs']:.1f}, axle {n_tok / so_dt['axle']:.1f}, rp "
      f"{n_tok / so_dt['rp']:.1f}; launches (the capture's warm-up steps "
      "included): " + "; ".join(
          f"{p} { {k: v for k, v in so_launches[p].items() if v} }"
          for p in ("bs", "axle", "rp")), flush=True)
arch_line(f"{serve_offload.ARCH} (serve_offload, axle)", so_srv,
          so_toks["axle"], so_dt["axle"], parts, weights, t0)
del so_srv, m_params

# opt_2_7b (MHA, hd 80), minitron_4b, qwen2_vl_2b (M-RoPE): 4 requests of
# 64-400 tokens, max_new 32, 4 slots, max_seq 1024; opt also 2 requests
# with its self:8 draft, under rp and with an int8 KV cache
arch_launches = {}
for arch, seed in (("opt_2_7b", 30), ("minitron_4b", 31),
                   ("qwen2_vl_2b", 32)):
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    acfg = get_config(arch)
    tc = acfg.head_dim_ in fa.TC_HEAD_DIMS
    lens = tuple(int(n) for n in np.random.default_rng(seed).integers(
        64, 401, 4))
    a_reqs = arch_requests(acfg.vocab, lens, 32, seed)
    srv, a_toks, launches, dt = serve(a_reqs, arch=arch, protocol="axle",
                                      stream=True)
    attention_launches(arch, srv, launches, acfg.n_layers, tc)
    check(all(len(t) == 32 for t in a_toks.values()), f"{arch}: short "
          "stream")
    arch_launches[arch] = launches
    a_params = srv.params
    parts, weights = replay_profile(srv, f"{arch}, axle", steps_only=True)
    arch_line(f"{arch} full width, axle, streamed, prompts {lens}, max_new "
              f"32, 4 slots, max_seq {S}, seg_len 8, the "
              f"{'tensor' if tc else 'CUDA'}-core attention kernels", srv,
              a_toks, dt, parts, weights, t0)
    del srv
    kernels_against_plain(arch, [r.prompt for r in a_reqs[:2]],
                          arch_cfg=acfg, weights=a_params)
    if arch == "opt_2_7b":
        # its own self:8 draft on 2 requests: the spec tokens == the
        # non-spec twin's whose decode runs at the verify's row count
        o_pair = arch_requests(acfg.vocab, (100, 200), 16, 33)
        sp_srv, sp_toks, sp_launches, sp_dt = serve(
            copies(o_pair), params=a_params, arch=arch, protocol="axle",
            stream=True, **SPEC)
        rounds = spec_rounds(sp_srv)
        d_layers = sp_srv.draft_cfg.n_layers
        own = int(acfg.draft_arch.split(":")[1]) * len(acfg.block_pattern)
        check(d_layers == own, f"[archs] {arch}: a draft of {d_layers} "
              f"layers, not its own {acfg.draft_arch}")
        check(sp_launches["decode_attention_fused"]
              == rounds * (SPEC_K + 1) * (d_layers + acfg.n_layers)
              and sp_launches["decode_attention_fused_tc"]
              == sp_launches["decode_attention_fused"] * int(tc),
              f"[archs] {arch} spec launches {sp_launches}")
        twin = padded_twin(o_pair, params=a_params, arch=arch,
                           protocol="axle", stream=True)
        check(sp_toks == twin, f"[archs] {arch}: spec tokens != the padded "
              "non-spec twin's")
        rate = sp_srv.draft_accepted / max(1, sp_srv.draft_proposed)
        print(f"[archs] {arch}, its self:{d_layers} draft, spec_k {SPEC_K}, 2 "
              f"requests x 16 tokens: {rounds} rounds, accept rate "
              f"{rate:.4f}, {sum(len(t) for t in sp_toks.values()) / sp_dt:.1f}"
              f" tok/s; tokens == the non-spec twin's at the verify's row "
              f"count, bitwise; fused launches "
              f"{sp_launches['decode_attention_fused']} = {rounds} x "
              f"{SPEC_K + 1} x ({d_layers} + {acfg.n_layers}), "
              f"{'all' if tc else 'none'} on the tensor cores", flush=True)
        del sp_srv
        # the hd 80 partial and int8 splits on a serve: the same 2
        # requests under rp (the partials) and with an int8 KV cache (the
        # int8 fused decode), beside the fp axle serve of them
        _, o_fp, _, _ = serve(copies(o_pair), params=a_params, arch=arch,
                              protocol="axle", stream=True)
        _, o_rp, rp_launches_o, _ = serve(
            copies(o_pair), params=a_params, arch=arch, protocol="rp",
            stream=True)
        check(rp_launches_o["decode_attention_partial"] > 0
              and rp_launches_o["decode_attention_partial_tc"]
              == rp_launches_o["decode_attention_partial"] * int(tc)
              and rp_launches_o["decode_attention_fused"] == 0,
              f"[archs] {arch} rp launches {rp_launches_o}")
        rp_vs = near_tie_agrees(f"{arch} rp vs axle", o_rp, o_fp, o_pair,
                                arch_cfg=acfg, weights=a_params)
        srv, o_i8, i8_launches_o, _ = serve(
            copies(o_pair), params=a_params, arch=arch, protocol="axle",
            stream=True, quant=QuantConfig(kv="int8"))
        attention_launches(f"{arch} int8 KV", srv, i8_launches_o,
                           acfg.n_layers, tc,
                           decode="decode_attention_fused[int8]")
        check(i8_launches_o["decode_attention_fused"] == 0
              and all(len(t) == 16 for t in o_i8.values()),
              f"[archs] {arch} int8 KV: launches {i8_launches_o}")
        del srv
        same = sum(o_i8[r] == o_fp[r] for r in o_fp)
        print(f"[archs] {arch}, the same 2 requests x 16 tokens: rp "
              f"{rp_vs} axle, partial launches "
              f"{routes_of(rp_launches_o, 'decode_attention_partial')}; "
              f"an int8 KV cache: int8 fused launches "
              f"{routes_of(i8_launches_o, 'decode_attention_fused[int8]')},"
              f" every one on the {'tensor' if tc else 'CUDA'}-core split; "
              f"{same} of 2 streams equal to fp KV's (not gated: int8 KV "
              "changes the logits)", flush=True)
    del a_params
print(f"[archs] the five archs took {time.perf_counter() - ARCHS_T0:.1f} s; "
      f"{time.perf_counter() - T_START:.0f} s into the script", flush=True)

# --------------------------------------------------------------------------
# 6c. Mixture-of-Experts serving: granite_moe_3b at full depth (32 layers,
# 40 experts, top-8, hd 64), then phi3_5_moe_42b and jamba_1_5_large at
# full width cut in depth to fit the card (their CARD configs); each model
# freed before the next.  The MoE FFN is plain torch, as the reference's
# is plain XLA: its dispatch multiplies every expert over its capacity
# slots, so a decode step reads every expert's weights
# --------------------------------------------------------------------------

phase("6c")

MOE_T0 = time.perf_counter()
# what the earlier phases still hold (mamba2_370m's weights, the KNN
# database under its first chunk's view): the phi3_5 cut needs the room
del mparams, knn_q, chunk
torch.cuda.empty_cache()
print(f"[moe] device memory held before the phase: "
      f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)


@contextlib.contextmanager
def moe_routes(record, force=None, margins=None):
    """Record every `layers.moe_route` call's (expert ids, router logits)
    in `record`, in call order.  With `force` (another run's record), each
    call routes to that run's experts instead, its gates from this run's
    own router, and each row whose own experts differ adds its margin
    (its own k-th best router logit less the lowest of the forced
    experts') to `margins`."""
    route = layers.moe_route
    forced = iter(force) if force is not None else None

    def spy(x, router, k):
        gates, ids = route(x, router, k)
        logits = x.float() @ router.float()
        record.append((ids, logits))
        if forced is None:
            return gates, ids
        want = next(forced)[0]
        other = (ids.sort(-1).values != want.sort(-1).values).any(-1)
        if bool(other.any()):
            low = logits.gather(1, want).min(-1).values
            kth = logits.gather(1, ids[:, -1:])[:, 0]
            margins.extend((kth - low)[other].tolist())
        probs = torch.softmax(logits, dim=-1).gather(1, want)
        return probs / probs.sum(-1, keepdim=True), want

    layers.moe_route = spy
    try:
        yield
    finally:
        layers.moe_route = route


def moe_against_plain(arch, prompts, arch_cfg, weights, atol=LOGIT_ATOL):
    """`kernels_against_plain` for an MoE model.  A router turns a one-unit
    difference of its input into another expert wherever two router
    logits nearly tie, and one swapped expert moves a whole logit row; a
    prefill routes every prompt row in every layer, thousands of choices.
    So the kernel path runs first, on its own greedy tokens, its routes
    recorded; the plain path then decodes the same tokens routed to the
    same experts (its gates from its own router), which leaves the
    kernels as the only difference: its logits are held within `atol`
    and its greedy tokens to the near-tie gate.  Each row the plain
    router would have sent elsewhere must be at a router near tie (its
    own k-th best router logit within NEAR_TIE of the forced experts')."""
    routes, forced, margins = [], [], []
    with moe_routes(routes):
        kern = logits_along(prompts, 4, False, arch_cfg=arch_cfg,
                            weights=weights)
    feed = [lg.argmax(-1).to(torch.int32)[:, None] for lg in kern[:-1]]
    with moe_routes(forced, force=routes, margins=margins):
        plain = logits_along(prompts, 4, True, arch_cfg=arch_cfg,
                             weights=weights, feed=feed)
    check(len(forced) == len(routes), f"[moe] {arch}: {len(forced)} routed "
          f"calls on the plain path, {len(routes)} on the kernel path")
    worst, flips = logits_agree(f"[moe] {arch}", kern, plain, len(prompts),
                                arch_cfg.padded_vocab, atol)
    check(all(m < NEAR_TIE for m in margins), f"[moe] {arch}: the plain "
          f"router parts from the kernel path's experts by "
          f"{max(margins, default=0.0)} "
          f"(gate {NEAR_TIE})")
    rows = sum(int(ids.shape[0]) for ids, _ in routes)
    print(f"[reference] {arch} full width, {len(prompts)} rows, prefill + 4 "
          f"decode steps, kernels vs plain versions, both routed by the "
          f"kernel path ({len(routes)} MoE calls, {rows} routed rows; the "
          f"plain router would send {len(margins)} of them elsewhere, each "
          f"at a router near tie, largest margin "
          f"{max(margins, default=0.0):.4g} < {NEAR_TIE}): logits "
          f"max_abs_err {worst:.4g} <= {atol}; greedy tokens agree (near-tie "
          f"gate {NEAR_TIE}; {flips} near-tie flips)", flush=True)


def server_replay(prompt, prefix, arch_cfg, weights, around):
    """A request's row as the server computes it, with its routes: the
    prefill of the prompt padded to its bucket (the rows past the prompt
    take expert capacity there), then one decode step per token of
    `prefix` in a batch of 4 rows (the server's; a decode step of 4 rows
    drops no pair, so the other rows change nothing of row 0), inside the
    context `around()` gives (the server's protocol, its row padding).
    Returns (row 0's last logits, the routes)."""
    padded = np.zeros((_prefill_bucket(len(prompt), S),), np.int32)
    padded[:len(prompt)] = prompt
    routes = []
    cache = transformer.init_cache(arch_cfg, 4, S, device=DEV)
    with moe_routes(routes), around():
        lg, cache = transformer.prefill_into_cache(
            arch_cfg, weights, cache, torch.from_numpy(padded).to(DEV), 0,
            len(prompt))
        pos = torch.full((4,), len(prompt), dtype=torch.int32, device=DEV)
        for tok in prefix:
            step, cache = transformer.decode_step(
                arch_cfg, weights, cache,
                torch.full((4, 1), tok, dtype=torch.int32, device=DEV),
                positions=pos)
            lg, pos = step[0, -1], pos + 1
    return lg.float(), routes


def first_route_split(a, b):
    """The first MoE call at which two runs' routes send rows to other
    experts: [(row, router margin)] (each row's smaller margin between its
    k-th and (k+1)-th router logits), or [] if they never part."""
    for (ia, la), (ib, lb) in zip(a, b):
        other = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        if bool(other.any()):
            k = ia.shape[-1]
            out = []
            for r in torch.nonzero(other)[:, 0].tolist():
                m = [float(v[k - 1] - v[k]) for v in
                     (la[r].sort(descending=True).values,
                      lb[r].sort(descending=True).values)]
                out.append((r, min(m)))
            return out
    return []


def moe_near_tie_agrees(what, toks, ref_toks, reqs, arch_cfg, weights,
                        ref_around, around=None):
    """`near_tie_agrees` for an MoE model, on replays of the parting
    stream as each server computed it (`server_replay`, under `ref_around`
    for the reference's server and `around` for `toks`' server; None when
    that server's tokens come from a verify, which no decode replays).  A
    stream may part where the two replays route alike and both choices
    lie within NEAR_TIE of the best logit of the reference's replay, or
    where the replays' routes first part only at router near ties.
    Returns what it found."""
    prompts = {r.rid: r.prompt for r in reqs}
    found = []
    for rid, got in toks.items():
        want = ref_toks[rid]
        if got == want:
            continue
        t = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        check(t is not None, f"{what}: request {rid}: {len(got)} tokens vs "
              f"{len(want)}, one stream a prefix of the other")
        lg, ref_routes = server_replay(prompts[rid], want[:t], arch_cfg,
                                       weights, ref_around)
        split = []
        if around is not None:
            _, routes = server_replay(prompts[rid], want[:t], arch_cfg,
                                      weights, around)
            split = first_route_split(routes, ref_routes)
        gaps = ((lg.max() - lg[want[t]]).item(),
                (lg.max() - lg[got[t]]).item())
        if split:
            check(all(m < NEAR_TIE for _, m in split), f"{what}: request "
                  f"{rid} parts at token {t} after routes part at rows "
                  f"{split}, not at router near ties (gate {NEAR_TIE})")
            found.append(f"request {rid} parts at token {t} ({want[t]} vs "
                         f"{got[t]}) after the routes part at router near "
                         f"ties {[round(m, 4) for _, m in split]}")
        else:
            check(max(gaps) < NEAR_TIE, f"{what}: request {rid} parts at "
                  f"token {t} ({want[t]} vs {got[t]}, {gaps[0]:.4f} and "
                  f"{gaps[1]:.4f} below the best logit), routed alike, not "
                  f"a near tie (gate {NEAR_TIE})")
            found.append(f"request {rid} parts at token {t} ({want[t]} vs "
                         f"{got[t]}, {gaps[0]:.4f} and {gaps[1]:.4f} below "
                         "the best logit, routed alike)")
    return ("equal to" if not found
            else f"near-tie equal to ({'; '.join(found)})")


def moe_serve(arch, arch_cfg, n_req, max_new, seed, **kw):
    """One streamed axle serve of `n_req` greedy requests of 64-400 tokens
    on the card config `arch_cfg`, the port's own weights from seed 0;
    checks every decode step and prefill took the tensor-core attention
    (and every mamba layer of a prefill the tensor-core scan)."""
    lens = tuple(int(n) for n in np.random.default_rng(seed).integers(
        64, 401, n_req))
    reqs = arch_requests(arch_cfg.vocab, lens, max_new, seed)
    srv, toks, launches, dt = serve(reqs, arch=arch, cfg=arch_cfg,
                                    protocol="axle", stream=True, **kw)
    n_attn = arch_cfg.attn_layers_per_block() * arch_cfg.n_blocks
    attention_launches(arch, srv, launches, n_attn,
                       arch_cfg.head_dim_ in fa.TC_HEAD_DIMS, tag="[moe]")
    n_mamba = arch_cfg.block_pattern.count("mamba") * arch_cfg.n_blocks
    check(launches["ssd_scan"] == srv.prefill_forwards * n_mamba
          and launches["ssd_scan_tc"] == launches["ssd_scan"],
          f"[moe] {arch}: ssd_scan launches {routes_of(launches, 'ssd_scan')}"
          f" != {srv.prefill_forwards} prefills x {n_mamba} mamba layers, "
          "all on the tensor-core scan")
    check(all(len(t) == max_new for t in toks.values()),
          f"[moe] {arch}: short stream")
    return reqs, lens, srv, toks, launches, dt


def moe_label(arch_cfg, lens, max_new):
    return (f"{arch_cfg.arch_id} full width, {arch_cfg.n_layers} layers "
            f"({arch_cfg.n_experts} experts, top-{arch_cfg.top_k}, MoE every "
            f"{arch_cfg.moe_every}), axle, streamed, prompts {lens}, max_new "
            f"{max_new}, 4 slots, max_seq {S}, seg_len 8")


# granite_moe_3b, all 32 layers: 8 greedy requests, graph == eager,
# request 1 alone == its row, the logits against the plain path, a self:8
# spec serve of 2 requests, and the same 2 under rp and with an int8 KV
# cache (the hd 64 partial and int8 decode on a serve)
GRANITE = "granite_moe_3b"
t0 = time.perf_counter()
torch.cuda.reset_peak_memory_stats()
gr_reqs, lens, srv, gr_toks, gr_launches, dt = moe_serve(GRANITE, gcfg, 8,
                                                          32, 40)
gr_params = srv.params
graph_equals_eager(f"{GRANITE}, axle", srv, gr_toks, gr_launches, dt,
                   gr_reqs, arch=GRANITE, cfg=gcfg, protocol="axle",
                   stream=True)
parts, weights = replay_profile(srv, f"{GRANITE}, axle", steps_only=True)
arch_line(moe_label(gcfg, lens, 32), srv, gr_toks, dt, parts, weights, t0,
          tag="[moe]")
del srv
alone_srv = BatchedServer(GRANITE, smoke=False, device="cuda", batch_slots=4,
                          max_seq=S, seg_len=8, params=gr_params,
                          protocol="axle", stream=True)
alone_srv.submit(copies(gr_reqs[1:2])[0])
alone_srv.run_until_drained()
check(alone_srv.completed[0].generated == gr_toks[1],
      f"[moe] {GRANITE}: request 1 alone != its row in the batch")
del alone_srv
moe_against_plain(GRANITE, [r.prompt for r in gr_reqs[:2]], gcfg, gr_params)
g_pair = arch_requests(gcfg.vocab, (100, 200), 16, 43)
# the pair's serves (spec, its padded twin, rp, int8 KV) run the first 8
# of the 32 layers, views of the served weights: the routes and widths of
# the full depth at a quarter of its time
g8cfg = dataclasses.replace(gcfg, arch_id=f"{gcfg.arch_id}_first8",
                            n_layers=8)
g8_params = self_draft_params(gcfg, gr_params, 8)
G8 = dict(params=g8_params, arch=GRANITE, cfg=g8cfg, protocol="axle",
          stream=True)
sp_srv, sp_toks, sp_launches, sp_dt = serve(copies(g_pair), **G8,
                                            draft_arch="self:2", **SPEC)
rounds = spec_rounds(sp_srv)
d_layers = sp_srv.draft_cfg.n_layers
check(sp_launches["decode_attention_fused"]
      == rounds * (SPEC_K + 1) * (d_layers + g8cfg.n_layers)
      and sp_launches["decode_attention_fused_tc"]
      == sp_launches["decode_attention_fused"]
      and sp_launches["flash_attention_tc"] == sp_launches["flash_attention"]
      == sp_srv.prefill_forwards * (g8cfg.n_layers + d_layers),
      f"[moe] {GRANITE} spec launches {sp_launches}")
rate = sp_srv.draft_accepted / max(1, sp_srv.draft_proposed)
del sp_srv
# the verify routes 4 x (k + 1) rows together, the decode step 4, so its
# capacity can drop pairs the decode keeps: the spec tokens are held to
# the non-spec twin at the verify's row count by the near-tie gate
twin = padded_twin(g_pair, **G8)
spec_vs = moe_near_tie_agrees(
    f"[moe] {GRANITE} spec vs the padded twin", sp_toks, twin, g_pair, g8cfg,
    g8_params, lambda: padded_rows(4 * (SPEC_K + 1)))
print(f"[moe] {GRANITE}, its first {g8cfg.n_layers} layers with their "
      f"self:{d_layers} draft, spec_k {SPEC_K}, 2 "
      f"requests x 16 tokens: {rounds} rounds, accept rate {rate:.4f}, "
      f"{sum(len(t) for t in sp_toks.values()) / sp_dt:.1f} tok/s; tokens "
      f"{spec_vs} the non-spec twin's at the verify's row count; fused "
      f"launches {sp_launches['decode_attention_fused']} = {rounds} x "
      f"{SPEC_K + 1} x ({d_layers} + {g8cfg.n_layers}), all on the tensor "
      "cores", flush=True)
_, g_fp, _, _ = serve(copies(g_pair), **G8)
_, g_rp, g_rp_launches, _ = serve(copies(g_pair),
                                  **dict(G8, protocol="rp"))
check(g_rp_launches["decode_attention_partial"] > 0
      and g_rp_launches["decode_attention_partial_tc"]
      == g_rp_launches["decode_attention_partial"]
      and g_rp_launches["decode_attention_fused"] == 0,
      f"[moe] {GRANITE} rp launches {g_rp_launches}")
rp_vs = moe_near_tie_agrees(
    f"[moe] {GRANITE} rp vs axle", g_rp, g_fp, g_pair, g8cfg, g8_params,
    lambda: use_offload(OffloadConfig(protocol=OffloadProtocol.AXLE)),
    lambda: use_offload(OffloadConfig(protocol=OffloadProtocol.RP)))
srv, g_i8, g_i8_launches, _ = serve(copies(g_pair), **G8,
                                    quant=QuantConfig(kv="int8"))
attention_launches(f"{GRANITE} int8 KV", srv, g_i8_launches, g8cfg.n_layers,
                   True, decode="decode_attention_fused[int8]", tag="[moe]")
check(g_i8_launches["decode_attention_fused"] == 0
      and all(len(t) == 16 for t in g_i8.values()),
      f"[moe] {GRANITE} int8 KV: launches {g_i8_launches}")
del srv
same = sum(g_i8[r] == g_fp[r] for r in g_fp)
print(f"[moe] {GRANITE}, its first {g8cfg.n_layers} layers, the same 2 "
      f"requests x 16 tokens: rp {rp_vs} axle, "
      f"partial launches "
      f"{routes_of(g_rp_launches, 'decode_attention_partial')}; an int8 KV "
      f"cache: int8 fused launches "
      f"{routes_of(g_i8_launches, 'decode_attention_fused[int8]')}, every "
      f"one on the tensor-core split; {same} of 2 streams equal to fp KV's "
      f"(not gated: int8 KV changes the logits); request 1 alone == its row "
      f"in the batch, bitwise; {GRANITE} phase "
      f"{time.perf_counter() - t0:.1f} s", flush=True)
del gr_params, g8_params, G8
torch.cuda.empty_cache()

# phi3_5_moe_42b (24 of 32 layers) and jamba_1_5_large (its first 5
# layers: four mamba, one attention, MoE at 0, 2 and 4): 4 greedy requests
# x 16 tokens and the logits against the plain path on 2 prompts
for arch, seed in (("phi3_5_moe_42b", 44), ("jamba_1_5_large", 45)):
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    acfg = get_card_config(arch)
    a_reqs, lens, srv, a_toks, launches, dt = moe_serve(arch, acfg, 4, 16,
                                                        seed)
    a_params = srv.params
    parts, weights = replay_profile(srv, f"{acfg.arch_id}, axle",
                                    steps_only=True)
    arch_line(moe_label(acfg, lens, 16) + f" (CARD: the first "
              f"{acfg.n_layers} of {get_config(arch).n_layers} layers)", srv,
              a_toks, dt, parts, weights, t0, tag="[moe]")
    del srv
    moe_against_plain(acfg.arch_id, [r.prompt for r in a_reqs[:2]], acfg,
                      a_params)
    del a_params
    torch.cuda.empty_cache()
print(f"[moe] the three archs took {time.perf_counter() - MOE_T0:.1f} s; "
      f"{time.perf_counter() - T_START:.0f} s into the script", flush=True)

# --------------------------------------------------------------------------
# 6d. encoder-decoder serving: whisper_large_v3 at full width (32 encoder
# and 32 decoder layers, d 1280, 20 heads of 64 on 20 KV heads, vocab
# 51,866, enc_len 1500).  The encoder runs plain torch, as the reference's
# is plain XLA; each admission writes its slot's cross-K/V, and every
# decode step reads it in one dense cross-attention decode over the clip's
# frames.  First the attention kernels at its shapes
# --------------------------------------------------------------------------

phase("6d")

ENCDEC_T0 = time.perf_counter()
WHISPER = "whisper_large_v3"
wcfg = get_config(WHISPER)
WH, WKH, WHD, WE = (wcfg.n_heads, wcfg.n_kv_heads, wcfg.head_dim_,
                    wcfg.enc_len)
W_TEXT = 448                     # the decoder's text context: its max_seq
E_POS = [0, 599, 1498, 1499]     # the last frames of clips of 1, 600,
#                                  1499 and 1500 frames

# decode_attention_fused[enc1500]: a decode step's cross read, q (4, 1, 20,
# 64) against the dense cross-K/V (4, 20, 1500, 64), each row up to its
# clip's last frame, no extra, no pages, as `decode_attention_combined(...,
# n_chunks=1)` calls it (blk_c 128 -> a dense chunk of 125, at hd 64 one
# split a chunk: 12 of 125 rows, each walked in tiles of 64 and 61)
q = randn(B, 1, WH, WHD)
k_enc, v_enc = randn(B, WKH, WE, WHD), randn(B, WKH, WE, WHD)
pos_e = torch.tensor(E_POS, dtype=torch.int32, device=DEV)
blk = fa.dense_chunk(WE, 128)
split, n_split = fa.decode_split(WE, blk, WHD)
check((blk, split, n_split) == (125, 125, 12),
      f"[kernel] enc1500: chunk {blk}, splits {n_split} of {split}")
kbuild.reset_launch_counts()
got = fa.decode_attention_fused(q, k_enc, v_enc, pos_e, blk_c=128)
variants = routes("decode_attention_fused")
with use_offload(OffloadConfig(protocol=OffloadProtocol.AXLE)):
    combined = decode_attention_combined(q, k_enc, v_enc, pos_e, n_chunks=1)
plain = ref.decode_fused_reference(q, k_enc, v_enc, pos_e)
torch.cuda.synchronize()
err = (got.float() - plain.float()).abs().max().item()
check(err <= ATOL_BF16, f"decode_attention_fused[enc1500]: err {err}")
# the limit scaled to the output (std 0.04-0.07 here), against the plain
# version in f32; a planted fault of one split must break it on every row
# of two splits or more
e_valid = ref.decode_valid_mask(pos_e, WE, 0)
multi = e_valid.sum(dim=1) > split
plain32 = ref.normalize_fused_partial(
    *ref.decode_partial_reference(q, k_enc, v_enc, e_valid)[::2],
    torch.float32)
excess = bf16_out_excess(got, plain32)
check(bool((excess <= 1).all()), f"decode_attention_fused[enc1500]: "
      f"err past 5e-4 + 2^-8|plain|, by {excess.tolist()}")
fault_excess = {}
for fault, (acc_f, _, l_f) in split_faults(q, k_enc, v_enc, e_valid,
                                           split).items():
    fault_excess[fault] = bf16_out_excess(
        ref.normalize_fused_partial(acc_f, l_f, q.dtype), plain32)[multi]
    check(bool((fault_excess[fault] > 1).all()),
          f"decode_attention_fused[enc1500]: a split {fault} passes the "
          f"limit ({fault_excess[fault].tolist()} of it)")
check(torch.equal(combined, got), "decode_attention_fused[enc1500]: "
      "decode_attention_combined(n_chunks=1) != the wrapper's call")
check(variants == {"decode_attention_fused": 1,
                   "decode_attention_fused_tc": 1},
      f"decode_attention_fused[enc1500]: launches {variants}, not the "
      "tensor-core split")
rows_alone(lambda b: fa.decode_attention_fused(
    *one_row(b, q, k_enc, v_enc, pos_e), blk_c=128), got,
    "decode_attention_fused[enc1500]")
n_valid = int(e_valid.sum())
bnd, by = kernel_bound("decode_attention_fused", q, k_enc, v_enc, pos_e,
                       blk_c=128, n_valid=n_valid)


def sdpa_cross():
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k_enc, v_enc, attn_mask=e_valid[:, None, None])


rec = records["decode_attention_fused[enc1500]"] = dict(
    name="decode_attention_fused[enc1500]", route="cuda",
    source="src/repro_torch/kernels/csrc/attention.cu",
    replaces="src/repro/kernels/flash_attention.py:313",
    max_abs_err=err, bound_ms=bnd, bound_by=by,
    **timings(lambda: fa.decode_attention_fused(q, k_enc, v_enc, pos_e,
                                                blk_c=128),
              lambda: ref.decode_fused_reference(q, k_enc, v_enc, pos_e),
              sdpa_cross))
backend = sdpa_backend(sdpa_cross)
enc_parts = split_parts(lambda: fa.decode_attention_fused(
    q, k_enc, v_enc, pos_e, blk_c=128), split, n_split)
q32, k32, v32 = q.float(), k_enc.float(), v_enc.float()
got32, var32 = on_cuda_cores(
    "decode_attention_fused[enc1500]",
    lambda: fa.decode_attention_fused(q32, k32, v32, pos_e, blk_c=128),
    "decode_attention_fused")
err32 = f32_err(got32, ref.decode_fused_reference(q32, k32, v32, pos_e),
                "decode_attention_fused[enc1500]")
print(f"[kernel] decode_attention_fused[enc1500] {WHISPER} cross-attention: "
      f"B={B} H={WH} KH={WKH} hd={WHD} dense S={WE}, pos={E_POS} (clips of "
      f"{[p + 1 for p in E_POS]} frames; {n_valid} valid rows): max_abs_err "
      f"{err:.3g} <= {ATOL_BF16}; against the f32 plain version, "
      f"{excess.max().item():.3f} of 5e-4 + 2^-8|plain| (a split dropped: "
      f"{fault_excess['dropped'].min().item():.1f}x it at least, read "
      f"twice: {fault_excess['read twice'].min().item():.1f}x, on the rows "
      f"of two splits or more); == decode_attention_combined(n_chunks=1) "
      f"bitwise; each row alone == its row in the batch bitwise; launches "
      f"{variants} ({n_split} splits of {split} rows of a dense chunk of "
      f"{blk}, the tensor-core split); {rec['ms']:.4f} ms, bound "
      f"{bnd:.6f} ms ({by}; every row valid: "
      f"{2 * B * WE * WKH * WHD * 2 / HBM_BYTES_PER_S * 1e3:.6f} ms), plain "
      f"{rec['plain_ms']:.4f} ms, SDPA with the boolean mask "
      f"{rec['library_ms']:.4f} ms; device {show(rec['device_ms'])} ms "
      f"({show(div(bnd, rec['device_ms']), '.2f')} of the bound), SDPA's "
      f"{show(rec['library_device_ms'])} ms on its {backend[0]} backend "
      f"({backend[1]}): "
      f"{show(div(rec['device_ms'], rec['library_device_ms']), '.2f')}x it "
      f"({enc_parts}); f32 copies on the CUDA-core split: max_abs_err "
      f"{err32:.3g} <= 1e-5, launches {var32}", flush=True)

# decode_attention_partial[enc1500]: the rp schedule's one chunk over the
# whole encoder output (n_chunks=1), its (B, C) mask from enc_pos
kbuild.reset_launch_counts()
part = fa.decode_attention_partial(q, k_enc, v_enc, e_valid)
variants = routes("decode_attention_partial")
torch.cuda.synchronize()
errp = partial_err(part, ref.decode_partial_reference(q, k_enc, v_enc,
                                                      e_valid),
                   "decode_attention_partial[enc1500]", empty=None)
check(variants == {"decode_attention_partial": 1,
                   "decode_attention_partial_tc": 1},
      f"decode_attention_partial[enc1500]: launches {variants}")
p_split, p_n = fa.decode_split(WE, fa.PARTIAL_CHUNK, WHD)
plain_p = ref.decode_partial_reference(q, k_enc, v_enc, e_valid)
p_multi = e_valid.sum(dim=1) > p_split
p_fault = {}
for fault, faulty in split_faults(q, k_enc, v_enc, e_valid,
                                  p_split).items():
    p_fault[fault] = partial_excess(faulty, plain_p)[p_multi]
    check(bool((p_fault[fault] > 1).all()),
          f"decode_attention_partial[enc1500]: a split {fault} passes the "
          f"limit ({p_fault[fault].tolist()} of it)")
rows_alone(lambda b: fa.decode_attention_partial(
    *one_row(b, q, k_enc, v_enc, e_valid)), part,
    "decode_attention_partial[enc1500]")
bndp, byp = kernel_bound("decode_attention_partial", q, k_enc, v_enc,
                         e_valid, n_valid=n_valid)
recp = records["decode_attention_partial[enc1500]"] = dict(
    name="decode_attention_partial[enc1500]", route="cuda",
    source="src/repro_torch/kernels/csrc/attention.cu",
    replaces="src/repro/kernels/flash_attention.py:192",
    max_abs_err=errp, bound_ms=bndp, bound_by=byp,
    **timings(lambda: fa.decode_attention_partial(q, k_enc, v_enc, e_valid),
              lambda: ref.decode_partial_reference(q, k_enc, v_enc,
                                                   e_valid)))
encp_parts = split_parts(
    lambda: fa.decode_attention_partial(q, k_enc, v_enc, e_valid), p_split,
    p_n)
got32, var32 = on_cuda_cores(
    "decode_attention_partial[enc1500]",
    lambda: fa.decode_attention_partial(q32, k32, v32, e_valid),
    "decode_attention_partial")
err32 = partial_err(got32, ref.decode_partial_reference(q32, k32, v32,
                                                        e_valid),
                    "decode_attention_partial[enc1500] f32", empty=None)
print(f"[kernel] decode_attention_partial[enc1500] {WHISPER}: B={B} C={WE}, "
      f"the enc_pos mask of pos={E_POS}: max_abs_err {errp:.3g} (<= 1e-3 + "
      f"1e-4|plain|; a split dropped: "
      f"{p_fault['dropped'].min().item():.1f}x that limit at least, read "
      f"twice: {p_fault['read twice'].min().item():.1f}x, on the rows of "
      f"two splits or more); each row alone == its row in the batch "
      f"bitwise; "
      f"launches {variants} ({p_n} splits of {p_split} rows, the last "
      f"ragged, the tensor-core split); {recp['ms']:.4f} ms, bound "
      f"{bndp:.6f} ms ({byp}), plain {recp['plain_ms']:.4f} ms, device "
      f"{show(recp['device_ms'])} ms ({encp_parts}); no library call; f32 "
      f"copies on the CUDA-core split: max_abs_err {err32:.3g}, launches "
      f"{var32}", flush=True)
del q, k_enc, v_enc, q32, k32, v32, got, got32, combined, plain, part, \
    plain32, plain_p

# flash_attention[hd64mha]: the decoder's prompt prefill, MHA (20 heads on
# 20 KV heads) at hd 64, causal: at the prompt buckets this phase serves (8,
# 16 and 32 tokens; the row at 32) and at the text context of 448
for s_w in (8, 32, W_TEXT):
    qf, kf, vf = (randn(1, s_w, WH, WHD) for _ in range(3))
    kbuild.reset_launch_counts()
    got = fa.flash_attention(qf, kf, vf, causal=True)
    variants = routes("flash_attention")
    plain = ref.mha_reference(qf, kf, vf, causal=True)
    torch.cuda.synchronize()
    errf = (got.float() - plain.float()).abs().max().item()
    check(errf <= ATOL_BF16, f"flash_attention[hd64mha] S={s_w}: err {errf}")
    check(variants == {"flash_attention": 1, "flash_attention_tc": 1},
          f"flash_attention[hd64mha] S={s_w}: launches {variants}")
    bndf, byf = kernel_bound("flash_attention", qf, kf, vf, causal=True)

    def sdpa_prefill():
        return torch.nn.functional.scaled_dot_product_attention(
            qf.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2),
            is_causal=True)

    recf = dict(
        name="flash_attention[hd64mha]", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        max_abs_err=errf, bound_ms=bndf, bound_by=byf,
        **timings(lambda: fa.flash_attention(qf, kf, vf, causal=True),
                  lambda: ref.mha_reference(qf, kf, vf, causal=True),
                  sdpa_prefill))
    backend = sdpa_backend(sdpa_prefill)
    q32, k32, v32 = qf.float(), kf.float(), vf.float()
    got32, var32 = on_cuda_cores(
        f"flash_attention[hd64mha] S={s_w}",
        lambda: fa.flash_attention(q32, k32, v32, causal=True),
        "flash_attention")
    err32 = f32_err(got32, ref.mha_reference(q32, k32, v32, causal=True),
                    f"flash_attention[hd64mha] S={s_w}")
    if s_w == 32:
        records["flash_attention[hd64mha]"] = recf
    print(f"[kernel] flash_attention[hd64mha] {WHISPER} decoder prefill: "
          f"B=1 S={s_w} H={WH} KH={WKH} hd={WHD} causal: max_abs_err "
          f"{errf:.3g} <= {ATOL_BF16}; launches {variants} (the tensor-core "
          f"kernel); {recf['ms']:.4f} ms, bound {bndf:.6f} ms ({byf}), plain "
          f"{recf['plain_ms']:.4f} ms, SDPA causal "
          f"{recf['library_ms']:.4f} ms; device {show(recf['device_ms'])} "
          f"ms, SDPA's {show(recf['library_device_ms'])} ms on its "
          f"{backend[0]} backend ({backend[1]}); f32 copies on the CUDA-core "
          f"kernel: max_abs_err {err32:.3g} <= 1e-5, launches {var32}"
          + ("; the JSON record" if s_w == 32 else ""), flush=True)
    del qf, kf, vf, got, plain, q32, k32, v32, got32
torch.cuda.empty_cache()


def whisper_requests(n, max_new, seed, prompt_lo=4):
    """`n` greedy requests: prompts of prompt_lo-32 tokens, clips of 1500
    frames (even ids) and of 600-1400 (odd ids), frames N(0, 1) f32."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = WE if i % 2 == 0 else int(r.integers(600, 1401))
        emb = r.standard_normal((e, wcfg.d_model)).astype(np.float32)
        prompt = r.integers(1, wcfg.vocab, int(r.integers(prompt_lo, 33)))
        out.append(Request(i, prompt.astype(np.int32), max_new, embeds=emb))
    return out


def encdec_launches(label, srv, launches, n_layers, decode):
    """Every decode step ran two fused decodes a layer on the tensor
    cores, the self-attention's (`decode`: the fp or the int8 one) and the
    cross read's (fp, counted at its site); every prefill one flash call a
    layer; one encoder pass an admission."""
    want = {"decode_attention_fused": srv.steps * n_layers,   # cross
            "flash_attention": srv.prefill_forwards * n_layers}
    want[decode] = want.get(decode, 0) + srv.steps * n_layers  # self
    for name, n in want.items():
        check(launches[name] == n and launches[name + "_tc"] == n,
              f"[encdec] {label}: {name} launches {launches[name]} "
              f"({launches[name + '_tc']} on the tensor cores) != {n}")
    check(launches["decode_attention_fused@cross"] == srv.steps * n_layers
          and launches["decode_attention_partial@cross"] == 0,
          f"[encdec] {label}: cross reads {launches}")
    check(launches["decode_attention_partial"] == 0,
          f"[encdec] {label}: partial launches {launches}")
    check(srv.encoder_passes == srv.prefill_forwards,
          f"[encdec] {label}: {srv.encoder_passes} encoder passes for "
          f"{srv.prefill_forwards} admissions")


# the 8 requests: 4 full clips, 4 of 600-1400 frames, so the cross reads of
# one batch end at different frames; 4 slots, two admissions each
t0 = time.perf_counter()
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
w_reqs = whisper_requests(8, 64, 50)
W_LENS = tuple(len(r.embeds) for r in w_reqs)
W_PROMPTS = tuple(len(r.prompt) for r in w_reqs)
W_SRV = dict(arch=WHISPER, max_seq=W_TEXT, protocol="axle", stream=True)
srv, w_toks, w_launches, w_dt = serve(w_reqs, **W_SRV)
n_wl = wcfg.n_layers
encdec_launches(WHISPER, srv, w_launches, n_wl, "decode_attention_fused")
check(all(len(t) == 64 for t in w_toks.values()), f"{WHISPER}: short stream")
check(srv.cfg.n_enc_layers == 32 and srv.cfg.d_model == 1280
      and srv.cache["cross_k"].shape == (n_wl, 4, WKH, WE, WHD),
      f"{WHISPER}: not the full config")
w_params = srv.params
parts, _ = replay_profile(srv, f"{WHISPER}, axle", steps_only=True)
# a decode step reads the decoder's weights (not the encoder's, nor the
# cross-attention's wk / wv, which only an admission reads), each row's
# cross-K/V up to its clip's end and its self-K/V up to its clock
dec_bytes = sum(t.numel() * t.element_size() for t in leaves(
    [w_params[k] for k in ("embed", "dec_blocks", "final_ln")]
    + [w_params["cross"][k] for k in ("ln", "wq", "wo")]))
row_bytes = n_wl * WKH * WHD * 2 * 2                 # K and V, bf16
cross_bytes = int(srv.cache["enc_pos"].sum()) * row_bytes
self_bytes = int(srv.state.positions.sum()) * row_bytes
step_bound = (dec_bytes + cross_bytes + self_bytes) / HBM_BYTES_PER_S * 1e3
clip = torch.from_numpy(w_reqs[0].embeds).to(DEV)[None]
encode_ms = time_ms(lambda: encdec.encode(wcfg, w_params, clip), iters=5)
admit_ms = time_ms(lambda: srv._prefill(0, w_reqs[0]), iters=5)


def busy_ms(fn):
    """Device time of one call under torch.profiler, and its kernels by
    device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted(((e.self_device_time_total, e.count, e.key)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                reverse=True)
    return sum(t for t, _, _ in ev) / 1e3, ev


enc_busy, _ = busy_ms(lambda: encdec.encode(wcfg, w_params, clip))
adm_busy, adm_ev = busy_ms(lambda: srv._prefill(0, w_reqs[0]))
print(f"[encdec] {WHISPER}, one admission under the profiler: device busy "
      f"{adm_busy:.2f} ms of its {admit_ms:.2f} ms "
      f"({100 * adm_busy / admit_ms:.1f}%), the encode {enc_busy:.2f} ms of "
      f"{encode_ms:.2f} ms; kernels by device time: " + "; ".join(
          f"{k[:48]} x{n} {t / 1e3:.2f} ms" for t, n, k in adm_ev[:8]),
      flush=True)
step = parts["step_plain_fn"]
n_tok = sum(len(t) for t in w_toks.values())
print(f"[encdec] {WHISPER} full width ({wcfg.n_enc_layers} + {n_wl} layers, "
      f"d {wcfg.d_model}, H {WH} on KH {WKH}, hd {WHD}, vocab {wcfg.vocab}, "
      f"enc_len {WE}), axle, streamed, 8 requests: prompts "
      f"{W_PROMPTS}, clips {W_LENS} frames, max_new 64, 4 slots, max_seq "
      f"{W_TEXT} (pages of {srv.page_size}), seg_len 8: {n_tok} tokens in "
      f"{w_dt:.3f} s = {n_tok / w_dt:.1f} tok/s, every segment a graph "
      f"replay; launches {routes_of(w_launches, 'decode_attention_fused', 'flash_attention')} "
      f"(a step: {n_wl} self + {n_wl} cross fused decodes; at the cross "
      f"site {w_launches['decode_attention_fused@cross']}); decode step "
      f"{step['device_ms']:.3f} ms device, {step['kernels']:.0f} kernels "
      f"({step['launches']} of ours); its bound {step_bound:.3f} ms at the "
      f"HBM rate (decoder weights {dec_bytes / 1e9:.3f} GB + cross-K/V "
      f"{cross_bytes / 1e9:.3f} GB + self-K/V {self_bytes / 1e9:.4f} GB): "
      f"{step['device_ms'] / step_bound:.2f}x it; one admission (encode "
      f"{WE} frames + prefill {_prefill_bucket(len(w_reqs[0].prompt), W_TEXT)}"
      f" tokens) {admit_ms:.2f} ms, the encode alone {encode_ms:.2f} ms; "
      f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB;"
      f" phase {time.perf_counter() - t0:.1f} s", flush=True)
del srv, clip

# request 1 (a short clip) alone in a fresh server == its row in the batch
alone_srv = BatchedServer(WHISPER, smoke=False, device="cuda", batch_slots=4,
                          max_seq=W_TEXT, seg_len=8, params=w_params,
                          protocol="axle", stream=True)
alone_srv.submit(copies(w_reqs[1:2])[0])
alone_srv.run_until_drained()
check(alone_srv.completed[0].generated == w_toks[1],
      f"[encdec] {WHISPER}: request 1 alone != its row in the batch")
del alone_srv

# two admissions in one slot (a full clip, then a short one over it):
# graphed == eager bitwise, so the prefill writes the cross-K/V and enc_pos
# the captured graphs read in place
w_pair = whisper_requests(2, 16, 51, prompt_lo=17)
srv, toks, launches, dt = serve(w_pair, params=w_params, batch_slots=1,
                                **W_SRV)
check(srv.prefill_forwards == 2 and srv.batch == 1,
      f"[encdec] {WHISPER}: {srv.prefill_forwards} admissions")
encdec_launches(f"{WHISPER} 1 slot", srv, launches, n_wl,
                "decode_attention_fused")
graph_equals_eager(f"{WHISPER}, axle, 1 slot, two admissions (clips "
                   f"{len(w_pair[0].embeds)} then {len(w_pair[1].embeds)} "
                   "frames)", srv, toks, launches, dt, w_pair, batch_slots=1,
                   **W_SRV)
del srv

# the kernel path's logits against the plain path's: a full clip and a
# short one, prefill + 4 decode steps
kernels_against_plain(f"{WHISPER} (clips {W_LENS[0]} and {W_LENS[1]})",
                      [r.prompt for r in w_reqs[:2]], arch_cfg=wcfg,
                      weights=w_params, max_seq=W_TEXT,
                      frames=[r.embeds for r in w_reqs[:2]])

# the pair's spec, rp and int8 KV serves run the first 8 of the 32
# decoder layers (views of the served weights; the whole encoder): the
# routes and widths of the full depth at a quarter of its decode.  A
# self:2 draft (prompts of 17-32 tokens, so no prefill of the twin's pads
# to the verify's rows): one encoder pass an admission, the spec tokens
# == the non-spec twin's at the verify's row count
w8cfg = dataclasses.replace(wcfg, arch_id=f"{wcfg.arch_id}_first8",
                            n_layers=8)
W8 = dict(W_SRV, params=self_draft_params(wcfg, w_params, 8), cfg=w8cfg)
n_w8 = w8cfg.n_layers
sp_srv, sp_toks, sp_launches, sp_dt = serve(copies(w_pair), **W8,
                                            draft_arch="self:2", **SPEC)
rounds = spec_rounds(sp_srv)
d_layers = sp_srv.draft_cfg.n_layers
check(d_layers == 2 and sp_srv.draft_shares_encoder
      and sp_srv.encoder_passes == sp_srv.prefill_forwards == 2,
      f"[encdec] {WHISPER} spec: a draft of {d_layers} layers, "
      f"{sp_srv.encoder_passes} encoder passes for "
      f"{sp_srv.prefill_forwards} admissions")
check(sp_launches["decode_attention_fused"]
      == rounds * (SPEC_K + 1) * 2 * (d_layers + n_w8)
      and sp_launches["decode_attention_fused_tc"]
      == sp_launches["decode_attention_fused"]
      and sp_launches["decode_attention_fused@cross"]
      == rounds * (SPEC_K + 1) * (d_layers + n_w8)
      and sp_launches["flash_attention_tc"] == sp_launches["flash_attention"]
      == sp_srv.prefill_forwards * (n_w8 + d_layers),
      f"[encdec] {WHISPER} spec launches {sp_launches}")
rate = sp_srv.draft_accepted / max(1, sp_srv.draft_proposed)
del sp_srv
twin = padded_twin(w_pair, **W8)
check(sp_toks == twin, f"[encdec] {WHISPER}: spec tokens != the padded "
      "non-spec twin's")
print(f"[encdec] {WHISPER}, its first {n_w8} decoder layers with their "
      f"self:{d_layers} draft, spec_k {SPEC_K}, 2 "
      f"requests x 16 tokens: {rounds} rounds, accept rate {rate:.4f}, "
      f"{sum(len(t) for t in sp_toks.values()) / sp_dt:.1f} tok/s; one "
      f"encoder pass an admission (the draft's prefill shares it); tokens == "
      f"the non-spec twin's at the verify's row count, bitwise; fused "
      f"launches {sp_launches['decode_attention_fused']} = {rounds} x "
      f"{SPEC_K + 1} x 2 x ({d_layers} + {n_w8}), all on the tensor cores",
      flush=True)

# the pair under rp (self and cross reads each one partial a layer: the
# cross one over all 1500 frames) and with an int8 KV cache (the self
# reads int8, the cross reads fp)
_, w_fp, _, _ = serve(copies(w_pair), **W8)
srv, w_rp, w_rp_launches, _ = serve(copies(w_pair),
                                    **dict(W8, protocol="rp"))
check(w_rp_launches["decode_attention_partial"]
      == w_rp_launches["decode_attention_partial_tc"]
      == 2 * srv.steps * n_w8
      and w_rp_launches["decode_attention_partial@cross"] == srv.steps * n_w8
      and w_rp_launches["decode_attention_fused"] == 0,
      f"[encdec] {WHISPER} rp launches {w_rp_launches} for {srv.steps} "
      "steps")
del srv
rp_vs = near_tie_agrees(f"{WHISPER} rp vs axle", w_rp, w_fp, w_pair,
                        arch_cfg=w8cfg, weights=W8["params"],
                        max_seq=W_TEXT)
srv, w_i8, w_i8_launches, _ = serve(copies(w_pair),
                                    quant=QuantConfig(kv="int8"), **W8)
encdec_launches(f"{WHISPER} int8 KV", srv, w_i8_launches, n_w8,
                "decode_attention_fused[int8]")
check(all(len(t) == 16 for t in w_i8.values()),
      f"[encdec] {WHISPER} int8 KV: short stream")
del srv
same = sum(w_i8[r] == w_fp[r] for r in w_fp)
print(f"[encdec] {WHISPER}, its first {n_w8} decoder layers, the same 2 "
      f"requests x 16 tokens: rp {rp_vs} "
      f"axle, partial launches "
      f"{routes_of(w_rp_launches, 'decode_attention_partial')} (a step: "
      f"{n_w8} self + {n_w8} cross partials of one chunk; at the cross site "
      f"{w_rp_launches['decode_attention_partial@cross']}); an int8 KV "
      f"cache: "
      f"launches "
      f"{routes_of(w_i8_launches, 'decode_attention_fused[int8]', 'decode_attention_fused')}"
      f" ({n_w8} int8 self + {n_w8} fp cross a step), every one on the "
      f"tensor-core "
      f"split; {same} of 2 streams equal to fp KV's (not gated: int8 KV "
      f"changes the logits); request 1 alone == its row in the batch, "
      f"bitwise; {WHISPER} phase {time.perf_counter() - ENCDEC_T0:.1f} s "
      f"(the kernel rows included); {time.perf_counter() - T_START:.0f} s "
      "into the script", flush=True)
# --------------------------------------------------------------------------
# 6e. the host tier and the prefix cache at full width, under axle, seg_len
# 8, streamed: slots evicted to pinned host memory and restored (evict_after
# 1, 2 chunks a leaf), and prompts' pages reused, each serve held to a
# non-evicting (or no-cache) twin of the same run.  whisper first, on the
# weights 6d holds; then starcoder2_3b (fp, q8_0 + int8 KV, self:7 spec,
# the prefix cache) and mamba2_370m (its first 24 layers), each from seed 0
# --------------------------------------------------------------------------

phase("6e")

TIER_T0 = time.perf_counter()
PCIE_GB_S = 64.0         # PCIe Gen5 x16, one direction: the data sheet's
TIER = dict(host_offload=True, evict_after=1, offload_chunks=2)
tier_peak = {"snapshots": 0, "prefix": 0}


# the parts of an eviction's and a restore's host time, by the functions
# the server calls for them (host seconds, summed)
TIER_CALLS = ((serve_mod, "stream_offload_to_host"),
              (serve_mod, "stream_offload_to_device"),
              (serve_mod.steps_lib, "save_slot_state"),
              (serve_mod.steps_lib, "restore_slot"),
              (backstream.HostSnapshot, "materialize"))


def timed_call(parts, name, fn):
    """fn, adding its host seconds to parts[name] (a closure over the
    dict alone: a server that held a closure over itself would be freed
    only by the cycle collector, whose pass could fall inside another
    server's graph capture, where freeing a CUDA graph is not allowed)."""
    def call(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t
    return call


class TierServer(BatchedServer):
    """The server with its host-tier moves recorded: where each request
    left and where it came back, the fills that admitted into a slot they
    had just evicted, each eviction's bytes and the timing events of its
    start (on the serving stream, just before the gather) and of its
    snapshot's landing (on the side stream), and the host seconds of the
    functions an eviction and a restore call (`parts`)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.moves, self.same_fill, self.snaps = [], 0, []
        self._evicted_now = set()
        self.parts = {}
        for name in ("extract_fn", "insert_fn"):
            setattr(self, name, timed_call(self.parts, name,
                                           getattr(self, name)))

    @contextlib.contextmanager
    def _timing(self):
        saved = [(owner, name, getattr(owner, name))
                 for owner, name in TIER_CALLS]
        for owner, name, fn in saved:
            setattr(owner, name, timed_call(self.parts, name, fn))
        try:
            yield
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)

    def _fill_slots(self):
        self._evicted_now = set()
        super()._fill_slots()

    def suspend_slot(self, slot):
        rid = self.active[slot].rid
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        with self._timing():
            super().suspend_slot(slot)
        snap = self.host_tier._store[rid][0]
        self.snaps.append((start, snap.event, snap.nbytes))
        self.moves.append(("out", rid, slot))
        self._evicted_now.add(slot)

    def _restore(self, slot, req):
        self.moves.append(("in", req.rid, slot))
        with self._timing():
            return super()._restore(slot, req)

    def _admit(self, slot, req):
        self.same_fill += slot in self._evicted_now
        return super()._admit(slot, req)


def restored_elsewhere(srv):
    left, n = {}, 0
    for way, rid, slot in srv.moves:
        if way == "out":
            left[rid] = slot
        else:
            n += left[rid] != slot
    return n


def tier_checks(label, srv, toks, base_toks, n_req, min_evictions=1):
    """An evicting run against its non-evicting twin: tokens bitwise,
    every eviction restored or found dead, the tier drained and its bytes
    closed, one decode sync a consumed segment and one more an admission
    or a restore (the ledger is closed by `serve`)."""
    check(toks == base_toks, f"[tier] {label}: evicting tokens != the "
          "non-evicting twin's")
    check(srv.evictions >= min_evictions
          and srv.restores + srv.restored_dead == srv.evictions,
          f"[tier] {label}: {srv.evictions} evictions, {srv.restores} "
          f"restores, {srv.restored_dead} found dead")
    tier = srv.host_tier
    check(len(tier) == 0 and tier.bytes_evicted == tier.bytes_restored > 0,
          f"[tier] {label}: host tier not drained")
    check(srv.decode_syncs == dispatches(srv)
          and srv.host_syncs - srv.decode_syncs == n_req + srv.evictions,
          f"[tier] {label}: syncs {srv.host_syncs} host, "
          f"{srv.decode_syncs} decode, {dispatches(srv)} segments, "
          f"{n_req} admissions, {srv.evictions} restores")
    tier_peak["snapshots"] = max(tier_peak["snapshots"], tier.resident_peak)


def tier_numbers(srv):
    """Bytes a slot, host dispatch ms of an evict and of a restore, and
    the median ms from an eviction's gather to its snapshot's landing
    (events on the serving and the side stream) with its GB/s."""
    torch.cuda.synchronize()
    n = srv.evictions
    per_slot = srv.host_tier.bytes_evicted / n
    land = statistics.median(start.elapsed_time(done)
                             for start, done, _ in srv.snaps)
    return dict(
        mb=per_slot / 1e6, evict_ms=srv.evict_dispatch_time / n * 1e3,
        restore_ms=srv.restore_dispatch_time / n * 1e3, land_ms=land,
        gb_s=per_slot / land / 1e6)


def tier_line(label, srv, base_srv, dt, base_dt):
    nums = tier_numbers(srv)
    n_tok = sum(len(r.generated) for r in srv.completed)
    parts = ", ".join(f"{k} {v * 1e3 / srv.evictions:.3f}"
                      for k, v in sorted(srv.parts.items(),
                                         key=lambda kv: -kv[1]))
    print(f"[tier] {label}: tokens == the non-evicting twin's bitwise; "
          f"{srv.evictions} evictions ({srv.restores} restored, "
          f"{srv.restored_dead} found dead at restore; "
          f"{restored_elsewhere(srv)} restored into another slot, "
          f"{srv.same_fill} slots admitted into in the fill that evicted "
          f"them); {nums['mb']:.2f} MB a slot each way; host dispatch "
          f"{nums['evict_ms']:.3f} ms an evict, {nums['restore_ms']:.3f} ms "
          f"a restore; gather + copy to pinned host memory lands in "
          f"{nums['land_ms']:.3f} ms (median) = {nums['gb_s']:.1f} GB/s "
          f"beside the link's {PCIE_GB_S:.0f} GB/s data-sheet figure; "
          f"syncs: {srv.decode_syncs} decode = the segments, "
          f"{srv.host_syncs - srv.decode_syncs} more = admissions + "
          f"restores; {n_tok / dt:.1f} tok/s ({n_tok / base_dt:.1f} "
          f"without eviction); host ms an eviction by call (evict and "
          f"restore together, the prefix calls none here): {parts}; peak "
          f"{srv.host_tier.resident_peak / 1e6:.1f} "
          f"MB of snapshots in pinned memory; {SMI_LINE}", flush=True)


def tier_serve(reqs, **kw):
    """The non-evicting twin, then the evicting run, on the same requests
    and weights."""
    base = serve(copies(reqs), **kw)
    kw["params"] = base[0].params
    return base, serve(copies(reqs), cls=TierServer, **kw, **TIER)


# whisper_large_v3: 4 requests x 16 tokens on clips of 600-1500 frames, 2
# slots: its slot carries the self-K/V, the cross-K/V over 1500 frames and
# enc_pos
t_w = whisper_requests(4, 16, 52)
(wb, wb_toks, _, wb_dt), (wo, wo_toks, wo_launches, wo_dt) = tier_serve(
    t_w, params=w_params, batch_slots=2, **W_SRV)
tier_checks(WHISPER, wo, wo_toks, wb_toks, 4)
encdec_launches(f"{WHISPER} evicting", wo, wo_launches, n_wl,
                "decode_attention_fused")
tier_line(f"{WHISPER}, 2 slots, 4 requests x 16 (clips "
          f"{sorted(len(r.embeds) for r in t_w)} frames)", wo, wb, wo_dt,
          wb_dt)
del wb, wo, w_params, W8
torch.cuda.empty_cache()

# starcoder2_3b fp: 12 requests (prompts 64-400, max_new 64, odd ids
# sampled) over 4 slots, 3x oversubscribed
t_reqs = make_requests(12, 64, 400, 64)
for r in t_reqs[1::2]:
    r.sampling = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                seed=2000 + r.rid)
(sb, sb_toks, _, sb_dt), (so, so_toks, so_launches, so_dt) = tier_serve(
    t_reqs, protocol="axle", stream=True)
t_params = so.params
tier_checks(f"{ARCH} fp", so, so_toks, sb_toks, 12, min_evictions=8)
check(so.same_fill > 0, f"[tier] {ARCH}: no slot admitted into in the fill "
      "that evicted it")
check(so_launches["decode_attention_fused"] == so.steps * n_layers
      == so_launches["decode_attention_fused_tc"]
      and so_launches["flash_attention"] == 12 * n_layers
      == so_launches["flash_attention_tc"],
      f"[tier] {ARCH}: launches {so_launches} for {so.steps} steps")
tier_line(f"{ARCH} fp, 4 slots, 12 requests x 64 (half sampled)", so, sb,
          so_dt, sb_dt)
del sb
# the per-token loop (evict_after 8 steps: the streamed run's quantum of
# one segment) gives the same tokens
pt, pt_toks, _, _ = serve(copies(t_reqs), params=t_params, cls=TierServer,
                          protocol="axle", stream=False,
                          **dict(TIER, evict_after=8))
tier_checks(f"{ARCH} fp per-token", pt, pt_toks, so_toks, 12)
print(f"[tier] {ARCH} fp per-token (evict_after 8 steps): tokens == the "
      f"streamed evicting run's bitwise; {pt.evictions} evictions, "
      f"{pt.decode_syncs} decode syncs = its steps", flush=True)
del pt

# one slot's pages alone: gather them, then time the copy to pinned memory
# and back on the side stream; and the graphed decode step of the drained
# server with and without one slot's copy to the host running beside it
leaves_0 = so.extract_fn(so.cache, 0)
torch.cuda.synchronize()
slot_bytes = nbytes(*leaves_0.values())
d2h, h2d = [], []
for _ in range(5):
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    snap = stream_offload_to_host(leaves_0, chunks=2)
    host = snap.materialize()
    d2h.append(start.elapsed_time(snap.event))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    back = stream_offload_to_device(host, DEV, chunks=2)
    end.record()
    end.synchronize()
    h2d.append(start.elapsed_time(end))
    check(all(torch.equal(back[k], leaves_0[k]) for k in leaves_0),
          "[tier] a slot's pages changed on their way through host memory")
step_args = segment_args(so)
so.step_plain_fn(*step_args)
torch.cuda.synchronize()


def timed_step(concurrent):
    snap = (stream_offload_to_host(leaves_0, chunks=2) if concurrent
            else None)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    so.step_plain_fn(*step_args)
    b.record()
    b.synchronize()
    overlap = snap is not None and a.elapsed_time(snap.event) \
        < a.elapsed_time(b)
    return a.elapsed_time(b), overlap


alone, beside, overlaps = [], [], 0
for _ in range(5):
    for conc in (False, True, True, False):
        ms, ov = timed_step(conc)
        (beside if conc else alone).append(ms)
        overlaps += ov
print(f"[tier] {ARCH} one slot's pages ({slot_bytes / 1e6:.2f} MB: 30 "
      f"layers x K, V x 2 KV heads x {S} rows x 128 x bf16), 2 chunks a "
      f"leaf: to pinned host memory {statistics.median(d2h):.3f} ms = "
      f"{slot_bytes / statistics.median(d2h) / 1e6:.1f} GB/s, back "
      f"{statistics.median(h2d):.3f} ms = "
      f"{slot_bytes / statistics.median(h2d) / 1e6:.1f} GB/s (the link's "
      f"data sheet: {PCIE_GB_S:.0f} GB/s each way), bitwise both ways; the "
      f"graphed decode step (4 slots) {statistics.median(alone):.3f} ms "
      f"device alone, {statistics.median(beside):.3f} ms with the slot's "
      f"copy to the host beside it ({overlaps} of {len(beside)} copies "
      f"landed inside the step); {SMI_LINE}", flush=True)
del so, leaves_0, back, host, snap
torch.cuda.empty_cache()

# starcoder2_3b q8_0 weights + int8 KV: 2 slots, 6 requests x 32
q_params = quantize_params(t_params, "q8_0")
q_reqs = make_requests(6, 64, 400, 32)
(qb, qb_toks, _, qb_dt), (qo, qo_toks, qo_launches, qo_dt) = tier_serve(
    q_reqs, params=q_params, batch_slots=2, protocol="axle", stream=True,
    quant=QuantConfig(kv="int8"))
tier_checks(f"{ARCH} q8_0 + int8 KV", qo, qo_toks, qb_toks, 6)
check(qo_launches["decode_attention_fused[int8]"] == qo.steps * n_layers
      and qo_launches["quant_matmul[q8_0]_skinny"] > 0,
      f"[tier] {ARCH} q8_0 + int8 KV: launches {qo_launches}")
tier_line(f"{ARCH} q8_0 + int8 KV, 2 slots, 6 requests x 32", qo, qb,
          qo_dt, qb_dt)
del qb, qo, q_params
torch.cuda.empty_cache()

# starcoder2_3b under self:7 speculation: the draft cache's row travels
# with the target's (one paired page set); 2 slots, 6 greedy requests x 32
s_reqs = make_requests(6, 64, 400, 32)
(spb, spb_toks, _, spb_dt), (spo, spo_toks, spo_launches, spo_dt) = \
    tier_serve(s_reqs, params=t_params, batch_slots=2, protocol="axle",
               stream=True, draft_arch="self:7", **SPEC)
tier_checks(f"{ARCH} spec self:7", spo, spo_toks, spb_toks, 6)
check((spo.draft_accepted, spo.draft_proposed)
      == (spb.draft_accepted, spb.draft_proposed)
      and [r.spec_proposed for r in spo.completed if r.rid == 0]
      == [r.spec_proposed for r in spb.completed if r.rid == 0],
      f"[tier] {ARCH} spec: accept counts differ from the non-evicting "
      "twin's")
pair_bytes = nbytes(*spo.extract_fn(spo.cache, 0).values(),
                    *spo.draft_extract_fn(spo.draft_cache, 0).values())
check(all(n == pair_bytes for _, _, n in spo.snaps),
      f"[tier] {ARCH} spec: a snapshot is not the target's and the draft's "
      f"row ({pair_bytes} bytes)")
tier_line(f"{ARCH} self:7 spec (k {SPEC_K}), 2 slots, 6 greedy requests "
          "x 32, the draft's row in the same snapshot", spo, spb, spo_dt,
          spb_dt)
del spb, spo

# the prefix cache on starcoder2_3b: a 384-token shared head alone (a
# miss), 8 requests of that head + a distinct 16-64-token tail (partial
# hits: the head's pages, then the tail's resume prefill), and exact
# repeats of the last two (full hits: no forward, the first token from the
# stored logits); 4 slots, max_new 16, against the no-cache twin
HEAD = 384


def prefix_requests(vocab, seed):
    r = np.random.default_rng(seed)
    head = r.integers(1, vocab, HEAD).astype(np.int32)
    out = [Request(0, head.copy(), 16)]
    for i in range(1, 9):
        tail = r.integers(1, vocab, int(r.integers(16, 65)))
        out.append(Request(i, np.concatenate([head, tail.astype(np.int32)]),
                           16))
    out += [Request(9, out[0].prompt.copy(), 16),
            Request(10, out[8].prompt.copy(), 16)]
    return out


PREFIX_COUNTS = (2, 8, 1)                        # (full, partial, miss)
RESUMED = list(range(1, 9)) + [10]  # their first token through a resume


def prefix_checks(label, pc, base, reqs, arch_cfg):
    """The counts as predicted, the tokens skipped and the forwards; the
    miss and the full hit of its prompt bitwise the no-cache twin's, the
    full hit of request 8's prompt (its pages and logits made by a resume)
    bitwise request 8's own stream."""
    counts = (pc.prefix_hits_full, pc.prefix_hits_partial, pc.prefix_misses)
    skipped = 9 * HEAD + len(reqs[10].prompt)
    check(counts == PREFIX_COUNTS and pc.prefill_tokens_skipped == skipped
          and (pc.prefill_forwards, base.prefill_forwards) == (9, 11),
          f"[tier] {label}: prefix counts {counts}, skipped "
          f"{pc.prefill_tokens_skipped}, forwards {pc.prefill_forwards} vs "
          f"{base.prefill_forwards}")
    got = {r.rid: r.generated for r in pc.completed}
    want = {r.rid: r.generated for r in base.completed}
    check(got[0] == want[0] and got[9] == want[9],
          f"[tier] {label}: the miss or its full hit differs from the "
          "no-cache twin")
    check(got[10] == got[8], f"[tier] {label}: the full hit of request 8's "
          "prompt differs from request 8's stream")
    tier_peak["prefix"] = max(tier_peak["prefix"], pc.prefix.bytes_stored_peak)
    return got, want


def admission_ms(srv, reqs, admit):
    out = []
    for r in reqs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        admit(r)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


p_reqs = prefix_requests(cfg.vocab, 60)
pb, pb_toks, _, _ = serve(p_reqs, params=t_params, protocol="axle",
                          stream=True)
pc, pc_toks, pc_launches, _ = serve(copies(p_reqs), params=t_params,
                                    protocol="axle", stream=True,
                                    prefix_cache=True)
prefix_checks(ARCH, pc, pb, p_reqs, cfg)
check(pc_launches["flash_attention"] == pc.prefix_misses * n_layers
      and pc_launches["decode_attention_fused"] == pc.steps * n_layers,
      f"[tier] {ARCH} prefix: launches {pc_launches}")
part_vs = near_tie_agrees(f"[tier] {ARCH} prefix partial hits",
                          {i: pc_toks[i] for i in RESUMED},
                          {i: pb_toks[i] for i in RESUMED},
                          [p_reqs[i] for i in RESUMED], weights=t_params)
pc_counts = (pc.prefill_tokens_skipped, pc.prefill_forwards)
# admissions on the drained server (slot 0): a full hit (a stored prompt),
# a partial hit (the head + a fresh 48-token tail, a new one each time)
# and the full prefill of such a prompt
fresh = prefix_requests(cfg.vocab, 61)[1:9]
for r in fresh:
    r.prompt = np.concatenate([p_reqs[0].prompt, r.prompt[HEAD:]])
full_ms = admission_ms(pc, p_reqs[9:11] * 3,
                       lambda r: pc._admit_prefill(0, r))
part_ms = admission_ms(pc, fresh[:5], lambda r: pc._admit_prefill(0, r))
miss_ms = admission_ms(pc, fresh[:5], lambda r: pc._prefill(0, r))
# where a partial hit's admission goes: its device time under the profiler
# (two more fresh prompts: a warm-up, then the profiled one)
part_busy, part_ev = busy_ms(lambda: pc._admit_prefill(0, fresh.pop()))
miss_busy, _ = busy_ms(lambda: pc._prefill(0, fresh[0]))
print(f"[tier] {ARCH} prefix cache, 4 slots, 11 requests x 16 (a {HEAD}-"
      f"token head alone, 8 x head + a 16-64-token tail, repeats of the "
      f"head and of request 8): "
      f"(full, partial, miss) = {PREFIX_COUNTS} as predicted; prefill "
      f"tokens skipped {pc_counts[0]}, prefill forwards "
      f"{pc_counts[1]} (no-cache {pb.prefill_forwards}); flash "
      f"launches {pc_launches['flash_attention']} = the miss x {n_layers}; "
      f"the miss and the head's full hit (first token included) == the "
      f"no-cache twin bitwise, request 8's full hit == request 8 bitwise; "
      f"the partial hits and request 8's full hit {part_vs} the no-cache "
      f"twin (near-tie gate "
      f"{NEAR_TIE}); an admission {full_ms:.2f} ms with a full hit, "
      f"{part_ms:.2f} ms with a partial hit (storing its own pages "
      f"included; device busy {part_busy:.2f} ms of it, top kernels: "
      + "; ".join(f"{k[:40]} x{n} {t / 1e3:.2f} ms"
                  for t, n, k in part_ev[:5])
      + f"), {miss_ms:.2f} ms without (the full prefill, device busy "
      f"{miss_busy:.2f} ms); "
      f"{pc.prefix.bytes_stored_peak / 1e6:.1f} MB of "
      f"prefix pages at peak; {SMI_LINE}", flush=True)
del pb, pc, t_params
torch.cuda.empty_cache()

# mamba2_370m on its first 24 of 48 layers (section 6's cut of depth):
# the evicting serve (2 slots, 8 requests x 32; a slot is the conv windows
# and the f32 SSD states), then the prefix run (its resume starts the scan
# kernel from the restored state: init_state)
m_reqs = make_requests(8, 64, 400, 32, mcfg.vocab)
(mb, mb_toks, _, mb_dt), (mo, mo_toks, mo_launches, mo_dt) = tier_serve(
    m_reqs, batch_slots=2, protocol="axle", stream=True, **M6)
m_params = mo.params
tier_checks(MAMBA, mo, mo_toks, mb_toks, 8)
tier_line(f"{MAMBA}, 2 slots, 8 requests x 32", mo, mb, mo_dt, mb_dt)
del mb, mo
mp_reqs = prefix_requests(mcfg.vocab, 62)
mpb, mpb_toks, _, _ = serve(mp_reqs, params=m_params, protocol="axle",
                            stream=True, **M6)
mpc, mpc_toks, mpc_launches, _ = serve(copies(mp_reqs), params=m_params,
                                       protocol="axle", stream=True,
                                       prefix_cache=True, **M6)
prefix_checks(MAMBA, mpc, mpb, mp_reqs, mcfg6)
n_ml = mcfg6.n_layers
check(mpc_launches["ssd_scan_init"] == mpc.prefix_hits_partial * n_ml
      and mpc_launches["ssd_scan"] == (mpc.prefix_misses
                                       + mpc.prefix_hits_partial) * n_ml
      and mpc_launches["ssd_scan_tc"] == mpc_launches["ssd_scan"],
      f"[tier] {MAMBA} prefix: launches {mpc_launches}")
# the bf16 partial hits against the no-cache twin, printed and not gated:
# 24 bf16 layers turn a last-bit difference into logit gaps of order 1
# (PERF.md); in f32 arithmetic (the same weights) they are gated
m_parts = [(r.rid, next(i for i, (x, y) in enumerate(
    zip(mpc_toks[r.rid], mpb_toks[r.rid])) if x != y))
    for r in mp_reqs if r.rid in RESUMED
    and mpc_toks[r.rid] != mpb_toks[r.rid]]
del mpb, mpc
m32 = dataclasses.replace(mcfg6, dtype="float32")
m32_params = as_f32(m_params)
del m_params
torch.cuda.empty_cache()
m32b, m32b_toks, _, _ = serve(copies(mp_reqs), params=m32_params, arch=MAMBA,
                              cfg=m32, protocol="axle", stream=True)
m32c, m32c_toks, m32_launches, _ = serve(
    copies(mp_reqs), params=m32_params, arch=MAMBA, cfg=m32,
    protocol="axle", stream=True, prefix_cache=True)
prefix_checks(f"{MAMBA} f32", m32c, m32b, mp_reqs, m32)
check(m32_launches["ssd_scan_init"] == 8 * n_ml,
      f"[tier] {MAMBA} f32 prefix: launches {m32_launches}")
m32_vs = near_tie_agrees(f"[tier] {MAMBA} f32 prefix partial hits",
                         {i: m32c_toks[i] for i in RESUMED},
                         {i: m32b_toks[i] for i in RESUMED},
                         [mp_reqs[i] for i in RESUMED], arch_cfg=m32,
                         weights=m32_params)
print(f"[tier] {MAMBA} prefix cache, the same shape of 11 requests: (full, "
      f"partial, miss) = {PREFIX_COUNTS} as predicted, the miss and the "
      f"head's full hit == the no-cache twin bitwise, request 8's full hit "
      f"== request 8; ssd_scan launches "
      f"{mpc_launches['ssd_scan']} ({mpc_launches['ssd_scan_init']} from "
      f"the restored state on the resume path, all on the tensor-core "
      f"route); the 9 streams through a resume vs the no-cache twin in "
      f"bf16 (not gated): {len(m_parts)} part ({m_parts}); in f32 "
      f"arithmetic (the CUDA-core scan, "
      f"{m32_launches['ssd_scan_init']} launches from the restored state) "
      f"they are {m32_vs} the no-cache twin "
      f"(near-tie gate {NEAR_TIE}); {SMI_LINE}", flush=True)
del m32b, m32c, m32_params
torch.cuda.empty_cache()
print(f"[tier] peak pinned host memory held: {tier_peak['snapshots'] / 1e6:.1f}"
      f" MB of evicted snapshots (one serve), "
      f"{tier_peak['prefix'] / 1e6:.1f} MB of prefix pages; phase "
      f"{time.perf_counter() - TIER_T0:.1f} s; "
      f"{time.perf_counter() - T_START:.0f} s into the script; {SMI_LINE}",
      flush=True)

# --------------------------------------------------------------------------
# 6f. chunked admission prefill at full width, under axle, seg_len 8,
# streamed: a long prompt admitted in chunks, one between two decode
# segments, while greedy requests decode; each run against a twin without
# the long request and one that admits it in one shot.  starcoder2_3b fp
# (5,000 tokens in chunks of 512) and q8_0 + int8 KV (2,000 in chunks of
# 192), mamba2_370m's first 24 layers (5,000 in chunks of 512), each from
# seed 0; then the
# ported quickstart
# --------------------------------------------------------------------------

phase("6f")

CHUNK_T0 = time.perf_counter()
LONG_RID = 99


class ChunkServer(BatchedServer):
    """The server with its chunked admissions recorded: each chunk's host
    dispatch seconds and timing events on the serving stream around it,
    each segment's end (a timing event), its rows, its variant and
    whether a slot was reserved then, and each request's decode syncs and
    host time at retirement.  The long request (rid LONG_RID) waits
    outside the queue until 2 segments have been dispatched (or nothing
    else is left), so that it arrives while the others decode."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.held, self.t_start = [], None
        self.chunk_host, self.chunk_events, self.segs = [], [], []
        self.retire_syncs, self.retire_t = {}, {}
        self._rows = ()

    def submit(self, req):
        if req.rid == LONG_RID and self.segments_dispatched < 2:
            req.generated = []
            self.held.append(req)
            return
        super().submit(req)

    def _fill_slots(self):
        if self.t_start is None:
            self.t_start = time.perf_counter()
        if self.held and (self.segments_dispatched >= 2 or not (
                self.queue or any(r is not None for r in self.active))):
            self.queue.extend(self.held)
            self.held = []
        super()._fill_slots()

    def _dispatch_rows(self, seg_len):
        rows, plain = super()._dispatch_rows(seg_len)
        self._rows = {req.rid for req, _ in rows.values()}
        return rows, plain

    def _run_segment(self, fn):
        out = super()._run_segment(fn)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.segs.append((end, self._rows, fn is self.segment_plain_fn,
                          bool(self.prefilling)))
        return out

    def _consume_segment(self, *a, **kw):
        super()._consume_segment(*a, **kw)
        for r in self.completed:
            if r.rid not in self.retire_syncs:
                self.retire_syncs[r.rid] = self.decode_syncs
                self.retire_t[r.rid] = time.perf_counter()

    def _pump_prefill(self):
        if not self.prefilling:
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        host = self.prefill_chunk_time
        a.record()
        super()._pump_prefill()
        b.record()
        self.chunk_host.append((self.prefill_chunk_time - host) * 1e3)
        self.chunk_events.append((a, b))


def chunk_serve(reqs, chunk, **kw):
    """Three drained runs on the same weights: the in-flight requests
    alone, then with the long one admitted in chunks of `chunk`, then in
    one shot.  Returns the three (server, tokens, launches, dt)."""
    short = [r for r in reqs if r.rid != LONG_RID]
    base = serve(copies(short), cls=ChunkServer, **kw)
    kw["params"] = base[0].params
    torch.cuda.reset_peak_memory_stats()
    chunked = serve(copies(reqs), cls=ChunkServer, prefill_chunk=chunk, **kw)
    chunked[0].peak_gb = torch.cuda.max_memory_allocated() / 1e9
    one = serve(copies(reqs), cls=ChunkServer, **kw)
    return base, chunked, one


def inflight(srv, rids):
    """tok/s of the in-flight requests (their tokens over the host time
    from the run's first fill to the last one's retirement) and the
    longest gap between two consecutive segments that carried one of
    them (timing events at each segment's end)."""
    n_tok = sum(len(r.generated) for r in srv.completed if r.rid in rids)
    span = max(srv.retire_t[r] for r in rids) - srv.t_start
    ends = [e for e, rows, _, _ in srv.segs if rows & rids]
    gap = max(a.elapsed_time(b) for a, b in zip(ends, ends[1:]))
    return n_tok / span, gap


def chunk_checks(label, base, chunked, one, n_chunks, long_len):
    """In-flight tokens bitwise the no-admission twin's and retired at
    the same decode syncs; the chunks counted; every segment while a slot
    was reserved the write-masked variant (the plain one ran before and
    after); the long request served in full."""
    (b, b_toks, _, _), (c, c_toks, _, _), (o, o_toks, _, _) = \
        base, chunked, one
    rids = set(b_toks)
    check({r: c_toks[r] for r in rids} == b_toks
          and {r: o_toks[r] for r in rids} == b_toks,
          f"[chunked] {label}: in-flight tokens differ from the "
          "no-admission twin's")
    check({r: c.retire_syncs[r] for r in rids} == b.retire_syncs,
          f"[chunked] {label}: in-flight rows retired at decode syncs "
          f"{ {r: c.retire_syncs[r] for r in rids} } vs {b.retire_syncs}")
    check(c.prefill_chunks == n_chunks and o.prefill_chunks == 0,
          f"[chunked] {label}: {c.prefill_chunks} chunks, want {n_chunks}")
    reserved = [plain for _, _, plain, res in c.segs if res]
    check(reserved and not any(reserved)
          and any(plain for _, _, plain, res in c.segs if not res),
          f"[chunked] {label}: segment variants while reserved {reserved}")
    check(len(c_toks[LONG_RID]) == len(o_toks[LONG_RID])
          and len(c.chunk_host) == n_chunks,
          f"[chunked] {label}: the long request was not served in full")
    torch.cuda.synchronize()
    stream_ms = [a.elapsed_time(b) for a, b in c.chunk_events]
    return rids, stream_ms


def chunk_device_ms(srv, prompt, chunk):
    """Each chunk's device time under the profiler, replayed into slot 0
    of the drained server at the serve's shapes."""
    toks = torch.from_numpy(np.concatenate([prompt, np.zeros(
        (-len(prompt)) % chunk, np.int32)])).to(DEV)
    out = []
    with use_offload(srv.offload):
        for start, size in srv.chunked.plan(len(prompt), chunk):
            part = toks[start:start + chunk]
            if start == 0:
                fn = functools.partial(srv.chunked.first, srv.params,
                                       srv.cache, part, 0, size)
            else:
                fn = functools.partial(srv.chunked.resume, srv.params,
                                       srv.cache, part, 0, start + size,
                                       start)
            out.append(busy_ms(fn)[0])
    return out


def spread(xs):
    return (f"first {xs[0]:.2f}, mean {statistics.mean(xs):.2f}, max "
            f"{max(xs):.2f}")


def chunk_line(label, base, chunked, one, rids, stream_ms, device, extra):
    (b, _, _, _), (c, _, c_launches, _), (o, _, _, _) = base, chunked, one
    tps = {k: inflight(s, rids) for k, s in (("base", b), ("chunked", c),
                                             ("one-shot", o))}
    print(f"[chunked] {label}: in-flight tokens == the no-admission twin's "
          f"bitwise, retired at the same decode syncs; {c.prefill_chunks} "
          f"chunks, every segment while the slot was reserved the "
          f"write-masked graph, all {c.graph_replays} segments replays; "
          f"a chunk's host dispatch ms {spread(c.chunk_host)}, its span on "
          f"the serving stream ms {spread(stream_ms)}, its device ms "
          f"(profiler, replayed) {spread(device)}; the in-flight rows' "
          f"longest gap between segments: "
          + ", ".join(f"{k} {v[1]:.2f} ms" for k, v in tps.items())
          + "; in-flight tok/s: "
          + ", ".join(f"{k} {v[0]:.1f}" for k, v in tps.items())
          + f"; launches {routes_of(c_launches, 'flash_attention', 'decode_attention_fused', 'decode_attention_fused[int8]', 'ssd_scan', 'quant_matmul[q8_0]')}"
          + f"; {extra}peak device memory {c.peak_gb:.2f} GB; "
          f"{SMI_LINE}", flush=True)


# starcoder2_3b fp: 5 slots of 10,240 rows, 4 greedy requests of 64-400
# tokens x 64 in flight (no stop tokens: only the reservation keeps the
# plain graph away), then a 5,000-token prompt x 32 in 10 chunks of 512
# (10,000 tokens in 20 chunks before [dryrun] took its time)
LONG, CHUNK, LONG_SEQ = 5_000, 512, 5_120
c_reqs = make_requests(4, 64, 400, 64) + [Request(LONG_RID, rng.integers(
    1, cfg.vocab, LONG).astype(np.int32), 32)]
cb, cc, co = chunk_serve(c_reqs, CHUNK, batch_slots=5, max_seq=LONG_SEQ,
                         protocol="axle", stream=True)
N_CHUNKS = -(-LONG // CHUNK)                                    # 10
c_rids, c_stream = chunk_checks(f"{ARCH} fp", cb, cc, co, N_CHUNKS, LONG)
c_launches = cc[2]
check(c_launches["flash_attention"] == 5 * n_layers
      == c_launches["flash_attention_tc"]
      and c_launches["decode_attention_fused"] == cc[0].steps * n_layers,
      f"[chunked] {ARCH}: launches {c_launches}")
c_vs = near_tie_agrees(f"[chunked] {ARCH} long request vs one-shot",
                       {LONG_RID: cc[1][LONG_RID]},
                       {LONG_RID: co[1][LONG_RID]}, c_reqs[-1:],
                       weights=cc[0].params, max_seq=LONG_SEQ)
c_dev = chunk_device_ms(cc[0], c_reqs[-1].prompt, CHUNK)
chunk_line(f"{ARCH} fp, 5 slots, max_seq {LONG_SEQ}, 4 greedy requests "
           f"(prompts {[len(r.prompt) for r in c_reqs[:4]]}) x 64 in flight, "
           f"a {LONG}-token prompt x 32 in chunks of {CHUNK}", cb, cc, co,
           c_rids, c_stream, c_dev,
           f"the long request {c_vs} its one-shot twin (near-tie gate "
           f"{NEAR_TIE}); ")
t_params = cc[0].params
del cb, cc, co
torch.cuda.empty_cache()

# starcoder2_3b q8_0 weights + int8 KV: 3 slots of 2,304 rows, 2 requests
# of 64-190 tokens in flight (shorter than a chunk: admitted in one shot),
# a 2,000-token prompt x 32 in 11 chunks of 192 (starts mid-page: the
# boundary pages merge their scales)
q_params = quantize_params(t_params, "q8_0")
del t_params
torch.cuda.empty_cache()
Q_LONG, Q_CHUNK, Q_SEQ = 2_000, 192, 2_304
cq_reqs = make_requests(2, 64, Q_CHUNK - 2, 64) + [Request(LONG_RID, rng.integers(
    1, cfg.vocab, Q_LONG).astype(np.int32), 32)]
qb, qc, qo = chunk_serve(cq_reqs, Q_CHUNK, params=q_params, batch_slots=3,
                         max_seq=Q_SEQ, protocol="axle", stream=True,
                         quant=QuantConfig(kv="int8"))
Q_CHUNKS = -(-Q_LONG // Q_CHUNK)                                # 11
q_rids, q_stream = chunk_checks(f"{ARCH} q8_0 + int8 KV", qb, qc, qo,
                                Q_CHUNKS, Q_LONG)
per_fwd = qb[2]["quant_matmul[q8_0]_tc"] // qb[0].prefill_forwards
check(per_fwd > 0
      and qc[2]["quant_matmul[q8_0]_tc"] == (2 + Q_CHUNKS) * per_fwd
      and qc[2]["decode_attention_fused[int8]"] == qc[0].steps * n_layers,
      f"[chunked] {ARCH} q8_0: launches {qc[2]}, {per_fwd} tensor-core "
      "products a prefill")
q_parts = partings({LONG_RID: qc[1][LONG_RID]}, {LONG_RID: qo[1][LONG_RID]},
                   cq_reqs[-1:], weights=q_params, kv_quant="int8",
                   max_seq=Q_SEQ)
q_dev = chunk_device_ms(qc[0], cq_reqs[-1].prompt, Q_CHUNK)
chunk_line(f"{ARCH} q8_0 + int8 KV, 3 slots, max_seq {Q_SEQ}, 2 requests "
           f"(prompts {[len(r.prompt) for r in cq_reqs[:2]]}) x 64 in "
           f"flight, a {Q_LONG}-token prompt x 32 in chunks of "
           f"{Q_CHUNK}", qb, qc, qo, q_rids, q_stream, q_dev,
           f"{per_fwd} tensor-core quant_matmul launches a prefill forward, "
           f"{(2 + Q_CHUNKS) * per_fwd} = (2 + {Q_CHUNKS}) x that; the long "
           f"request vs "
           f"one-shot (printed, not gated): "
           f"{describe(q_parts) if q_parts else 'equal'}; ")
del qb, qc, qo, q_params
torch.cuda.empty_cache()

# mamba2_370m on its first 24 of 48 layers (section 6's cut of depth):
# the same shape as starcoder2_3b fp; the chunks after the first start
# the scan from the previous chunk's state (init_state)
cm_reqs = make_requests(4, 64, 400, 64, mcfg.vocab) + [Request(
    LONG_RID, rng.integers(1, mcfg.vocab, LONG).astype(np.int32), 32)]
mb, mc, mo = chunk_serve(cm_reqs, CHUNK, batch_slots=5, max_seq=LONG_SEQ,
                         protocol="axle", stream=True, **M6)
m_rids, m_stream = chunk_checks(MAMBA, mb, mc, mo, N_CHUNKS, LONG)
n_ml = mcfg6.n_layers
check(mc[2]["ssd_scan_init"] == (N_CHUNKS - 1) * n_ml
      and mc[2]["ssd_scan_tc"] == mc[2]["ssd_scan"]
      == (4 + N_CHUNKS) * n_ml,
      f"[chunked] {MAMBA}: launches {mc[2]}")
m_bf16 = ("equal to" if mc[1][LONG_RID] == mo[1][LONG_RID] else
          f"parts from (at token "
          f"{next(i for i, (x, y) in enumerate(zip(mc[1][LONG_RID], mo[1][LONG_RID])) if x != y)})")
m_dev = chunk_device_ms(mc[0], cm_reqs[-1].prompt, CHUNK)
cm_params = as_f32(mc[0].params)
cm_m32 = dataclasses.replace(mcfg6, dtype="float32")
chunk_line(f"{MAMBA}, the same shape", mb, mc, mo, m_rids, m_stream, m_dev,
           f"the long request in bf16 {m_bf16} its one-shot twin (printed, "
           "not gated); ")
del mb, mc, mo
torch.cuda.empty_cache()
# f32 arithmetic: the long request alone, chunked and in one shot, bitwise
m32c, m32c_toks, m32c_launches, _ = serve(
    copies(cm_reqs[-1:]), params=cm_params, arch=MAMBA, cfg=cm_m32,
    batch_slots=5, max_seq=LONG_SEQ, protocol="axle", stream=True,
    prefill_chunk=CHUNK)
m32o, m32o_toks, _, _ = serve(
    copies(cm_reqs[-1:]), params=cm_params, arch=MAMBA, cfg=cm_m32,
    batch_slots=5, max_seq=LONG_SEQ, protocol="axle", stream=True)
check(m32c_toks == m32o_toks, f"[chunked] {MAMBA} f32: the chunked long "
      "request differs from its one-shot twin")
check(m32c_launches["ssd_scan_init"] == (N_CHUNKS - 1) * n_ml,
      f"[chunked] {MAMBA} f32: launches {m32c_launches}")
print(f"[chunked] {MAMBA} in f32 arithmetic (the CUDA-core scan): the "
      f"{LONG}-token request alone in {m32c.prefill_chunks} chunks of "
      f"{CHUNK} == its one-shot twin bitwise ({len(m32c_toks[LONG_RID])} "
      f"tokens); ssd_scan launches from the previous chunk's state "
      f"{m32c_launches['ssd_scan_init']} = {N_CHUNKS - 1} x {n_ml}; "
      f"{SMI_LINE}",
      flush=True)
del m32c, m32o, cm_params
torch.cuda.empty_cache()

# the ported quickstart: the simulator (pure Python) and BS vs AXLE decode
# attention on the card in f32
qs_out = io.StringIO()
with contextlib.redirect_stdout(qs_out):
    qs = quickstart.main()
check(qs["max_err"] <= 1e-5, f"[quickstart] BS vs AXLE max error "
      f"{qs['max_err']}")
print(f"[quickstart] workload (e) PageRank: AXLE reduces the simulated "
      f"runtime by {qs['axle_reduction'] * 100:.1f}% against RP (paper: up "
      f"to 50.14%); decode attention on the card (B 2, S 1024, H 4, hd 64, "
      f"f32, 8 chunks) BS vs AXLE max|err| {qs['max_err']:.2e} <= 1e-5; "
      f"[chunked] + [quickstart] phase "
      f"{time.perf_counter() - CHUNK_T0:.1f} s; "
      f"{time.perf_counter() - T_START:.0f} s into the script; {SMI_LINE}",
      flush=True)

# --------------------------------------------------------------------------
# 6g. mesh-sharded serving: a 1x2 gloo group on the one card.  The ported
# `examples/mesh_serve.py` runs in a process of its own (the ranks it
# spawns import its module, never this script), once this process has
# freed its models: the single-device server (graphed) serves full-width
# starcoder2_3b, 4 slots, 4 requests (2 greedy, 2 sampled) x 32 tokens,
# prompts of 64-512 tokens, seg_len 8; then 2 ranks serve the same with
# `BatchedServer(mesh=)` (eager: gloo cannot be captured), each with its
# launch counts set to 0 just before and read just after: tokens, decode
# syncs and the ledger == the single device's on every rank, bitwise.
# H 24 on KH 2 splits its KV heads at n = 2: each rank runs the fused
# partial over 12 heads on 1 KV head and gathers the other group's
# statistics, 4 x 12 x 130 x 4 = 24,960 bytes a merge, 30 merges a step.
# In the same group the sequence-sharded schedules (BS, AXLE, RP) over a
# cache of 8192 slots at starcoder2_3b's widths, bf16 and f32, are held
# on every rank to the single-device fused decode (2e-2 in bf16, one unit
# in the last place below 4; 1e-4 in f32, a summation order apart)
# --------------------------------------------------------------------------

phase("6g")

def holds_cuda(x, depth=0) -> bool:
    """A server, or a CUDA tensor alone or inside dicts, lists and
    tuples."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, BatchedServer):
        return True
    if depth < 8 and isinstance(x, dict):
        return any(holds_cuda(v, depth + 1) for v in x.values())
    if depth < 8 and isinstance(x, (list, tuple)):
        return any(holds_cuda(v, depth + 1) for v in x)
    return False


# what the earlier phases still hold on the card: the result below reads
# only launch counts and timings
held = torch.cuda.memory_allocated()
freed = sorted(k for k, v in list(globals().items())
               if not k.startswith("_") and holds_cuda(v))
for k in freed:
    del globals()[k]
gc.collect()
torch.cuda.empty_cache()
print(f"[mesh] device memory held by this process before the phase: "
      f"{held / 1e9:.2f} GB, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
      f"after freeing {len(freed)} globals", flush=True)
ROOT = Path(__file__).resolve().parent
mesh_json = ROOT / "build" / "mesh_serve.json"
mt_json = ROOT / "build" / "mesh_train.json"
mesh_json.parent.mkdir(exist_ok=True)
CHILDREN = []


def start_child(name, args):
    """`python -m <args>` of the port in a process group of its own (the
    mesh ranks it spawns are in it), its output to build/<name>.out and
    .err; every such group is killed at exit."""
    out = (ROOT / "build" / f"{name}.out").open("w")
    err = (ROOT / "build" / f"{name}.err").open("w")
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                            env=dict(os.environ,
                                     PYTHONPATH=str(ROOT / "src")),
                            stdout=out, stderr=err, start_new_session=True)
    CHILDREN.append(proc)
    return {"name": name, "proc": proc, "files": (out, err),
            "t0": time.perf_counter()}


def kill_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


atexit.register(kill_children)


def finish_child(label, child, timeout=900):
    """Wait for a child (killing its group past `timeout` s): its stdout,
    and its seconds from start to end; fails the run on an error."""
    proc = child["proc"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        kill_children()
        fail(f"{label} {child['name']} outlasted {timeout} s")
    for fh in child["files"]:
        fh.close()
    stdout = (ROOT / "build" / f"{child['name']}.out").read_text()
    stderr = (ROOT / "build" / f"{child['name']}.err").read_text()
    check(proc.returncode == 0, f"{label} {child['name']} failed with "
          f"{proc.returncode}:\n{stdout[-3000:]}\n{stderr[-6000:]}")
    return stdout, time.perf_counter() - child["t0"]


def mesh_results(child):
    """The [mesh] lines and checks of the mesh_serve child."""
    global mesh_launches
    stdout, secs = finish_child("[mesh]", child)
    for line in stdout.splitlines():
        if line.startswith("[mesh]"):
            print(f"{line}; {SMI_LINE}", flush=True)
    mesh_ranks = json.loads(mesh_json.read_text())["ranks"]
    check(len(mesh_ranks) == 2, f"[mesh] {len(mesh_ranks)} ranks reported")
    for rep in mesh_ranks:
        ml, wm = rep["launches"], rep["wire_model"]
        check(ml["decode_attention_fused_partial"] > 0
              and ml["decode_attention_fused_partial_tc"]
              == ml["decode_attention_fused_partial"]
              and ml["decode_attention_fused"] == 0
              and ml["flash_attention"] > 0,
              f"[mesh] rank {rep['rank']}: launches {ml}")
        check(rep["step"]["launches"].get("decode_attention_fused_partial")
              == get_config(ARCH).n_layers == rep["merges_per_step"]
              and wm["bytes_per_merge"] == 24_960 and wm["n_shards"] == 2,
              f"[mesh] rank {rep['rank']}: step {rep['step']}, wire {wm}")
    mesh_launches = mesh_ranks[0]["launches"]
    print(f"[mesh] phase {secs:.1f} s; {time.perf_counter() - T_START:.0f}"
          f" s into the script", flush=True)


mesh_results(start_child("mesh_serve", [
    "repro_torch.examples.mesh_serve", "--full", "--mesh", "1x2",
    "--ring-seq", "8192", "--json", str(mesh_json)]))

# the host tier, the prefix cache and chunked admission under a data split:
# the same example at 2x1 (two ranks of 2 slot rows each on the one card,
# as [mesh_train]'s 2x1 case), full width on starcoder2_3b's first 8
# layers (the eager gloo segments cost ~4x at all 30), 24 tokens a
# request: its churn serve (6
# requests on 4 slots, each evictable after a segment: 4 of the 6
# restores land in the other group's rows, 2 in their own), its prefix
# serve (a prompt of 64-512 tokens served, repeated and extended: the
# extension and the second repeat land in group 1, the entry in group 0)
# and its chunked serve (a 900-token prompt in chunks of 256 beside 3
# streams), each held by the example to the graphed single-device
# server: tokens, decode syncs, the ledger, the tier's counts and its
# host bytes on both ranks
tier_json = ROOT / "build" / "mesh_tier.json"


def tier_results(child):
    """The [mesh] tier lines and checks of the 2x1 mesh_serve child."""
    stdout, secs = finish_child("[mesh]", child)
    for line in stdout.splitlines():
        if line.startswith("[mesh]"):
            print(f"{line}; {SMI_LINE}", flush=True)
    res = json.loads(tier_json.read_text())
    base, ranks = res["base"]["serves"], res["ranks"]
    check(len(ranks) == 2, f"[mesh] tier: {len(ranks)} ranks reported")
    check(base["churn"]["evictions"] > 0 and base["churn"]["restores"] > 0,
          f"[mesh] tier churn: {base['churn']['evictions']} evictions")
    full, partial, _ = base["prefix"]["prefix"]
    check(full >= 1 and partial >= 1, f"[mesh] tier prefix: {full} full, "
          f"{partial} partial hits")
    check(base["chunked"]["prefill_chunks"] >= 4,
          f"[mesh] tier chunked: {base['chunked']['prefill_chunks']} chunks")
    for rep in ranks:
        for name, srv in rep["serves"].items():
            ml = srv["launches"]
            check(ml["decode_attention_fused"] > 0
                  and ml["decode_attention_fused_tc"]
                  == ml["decode_attention_fused"]
                  and ml["flash_attention"] > 0
                  and ml["flash_attention_tc"] == ml["flash_attention"],
                  f"[mesh] tier {name} rank {rep['rank']}: launches {ml}")
            if name in ("churn", "prefix"):
                check(srv["tier_moves"] > 0 and srv["tier_bytes_moved"] > 0,
                      f"[mesh] tier {name} rank {rep['rank']}: "
                      f"{srv['tier_moves']} moves")
        # every eviction's snapshot is a whole row: a move carries one
        churn = rep["serves"]["churn"]
        evicted = base["churn"]["host_bytes"][0] // base["churn"]["evictions"]
        check(churn["tier_bytes_moved"] == churn["tier_moves"] * evicted
              and 0 < churn["restores_moved"] < churn["restores"],
              f"[mesh] tier churn rank {rep['rank']}: "
              f"{churn['tier_bytes_moved']} B in {churn['tier_moves']} "
              f"moves of {evicted} B, {churn['restores_moved']} of "
              f"{churn['restores']} restores moved")
    print(f"[mesh] tier phase {secs:.1f} s; "
          f"{time.perf_counter() - T_START:.0f} s into the script",
          flush=True)


tier_results(start_child("mesh_tier", [
    "repro_torch.examples.mesh_serve", "--full", "--layers", "8", "--mesh",
    "2x1", "--serves", "churn,prefix,chunked", "--max-new", "24",
    "--ring-seq", "0", "--json", str(tier_json)]))

# --------------------------------------------------------------------------
# 6h. training on the one card (`launch/steps.make_train_step`: autograd
# over the plain-torch forward, each block recomputed in the backward, the
# int8 error-feedback compression, AdamW with an f32 master; the data from
# `data/pipeline.make_pipeline`, seed 0).  The reference's training path
# reaches no Pallas kernel (plain XLA attention, SSD, MoE and loss), so
# this phase launches none of ours and adds no kernel record.
#   * f32 on the card == f32 on the CPU: the smoke starcoder2_3b,
#     mamba2_370m and granite_moe_3b in float32, the same weights and
#     batch: the loss within 1e-5 relative and every gradient leaf within
#     1e-5 x its max |CPU| (TF32 would part them by ~1e-3);
#   * full width, bf16, B 4 x S 2048, 8 steps each: starcoder2_3b's first 8 of
#     30 layers, mamba2_370m's first 24 of 48 (its first batch every step),
#     granite_moe_3b's first 4 of 32 layers: every loss and grad norm finite,
#     the last loss below the first; each step's wall ms (synchronised) and
#     tokens/s, one step's device ms (torch.profiler) and its forward /
#     backward / optimizer split (CUDA events), peak memory, and the step's
#     bound from the dry-run's counter (`roofline/cost.py` on meta tensors:
#     the gradients' bf16 products at 989 TFLOP/s, f32 attention or SSD
#     products at 67, the update's bytes at 3.35 TB/s, added: the step runs
#     its kernels one after another);
#   * bf16 against an f32 twin (the same weights, cast) on starcoder2_3b's
#     first 2 layers at full width: the first loss within 1% and every
#     gradient leaf's cosine >= 0.99;
#   The timed runs go first; then the [mesh_train] example starts in its
#   own process (6h2), beside the untimed checks (card vs CPU, bf16 vs
#   f32, the restart).
#   * restart and preemption: the ported `examples/train_pipeline.py`
#     config on its first 2 of 10 layers (~33M, B 8 x S 256,
#     compression, lr 3e-3) through
#     `launch/train.train` in processes of their own.  An 8-step run; the
#     same job stopped by a SIGTERM it raises at its 6th step (the
#     reference's schedule spans the `steps` asked for, so the 8-step job
#     is the one stopped), resumed with steps=6 (nothing to do) and to 8:
#     steps run 6 / 0 / 2; and one stopped by a SIGTERM from this process
#     mid-run and resumed in a new process.  Every loss and every leaf of
#     the final checkpoint (params, AdamW state, residual) == the 8-step
#     run's, bit for bit.
# --------------------------------------------------------------------------

phase("6h")

TRAIN_T0 = time.perf_counter()
CPU_DEV = torch.device("cpu")
TRAIN_B, TRAIN_S = 4, 2048
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
OPT_BYTES = 36                   # a parameter: g (2), residual, mu, nu and
                                 # master (4 each) in, all but g out, and
                                 # the bf16 param (2) out


def train_batch(tcfg, b, s, step=0, device=DEV):
    dcfg = DataConfig(vocab=tcfg.vocab, batch=b, seq_len=s,
                      frontend=tcfg.frontend, d_model=tcfg.d_model)
    return {k: torch.from_numpy(v).to(device)
            for k, v in synth_batch(dcfg, step).items()}


def n_leaf_params(params) -> int:
    return sum(t.numel() for t in ptree.leaves(params))


def attention_pairs(s, q_tile=512, block=1024):
    """Query-key pairs `blocked_attention` scores a head, causal: each
    q tile against whole KV blocks up to its last query."""
    block = min(block, s)
    while s % block:
        block -= 1
    return sum((min(t0 + q_tile, s) - t0) * block
               * max(1, -(-min(s, t0 + q_tile) // block))
               for t0 in range(0, s, q_tile))


def train_bound(tcfg):
    """The step's least time from the dry-run's counter (`roofline/
    cost.py`, on meta tensors in the child process): (bf16 TFLOP, f32
    TFLOP, update GB, their ms at the card's peaks).  The gradients'
    products by operand dtype (bf16 at 989 TFLOP/s, f32 at 67), the
    update's bytes (compression + AdamW under the ideal-fusion model) at
    3.35 TB/s; added, since the step runs its kernels one after
    another."""
    part = dry_meta()["train"][tcfg.arch_id]
    by_dt = part["grads"]["flops_by_dtype"]
    bf16, f32 = by_dt.get("bfloat16", 0.0), by_dt.get("float32", 0.0)
    opt = part["update"]["bytes"]
    ms = (bf16 / analysis.PEAKS["bfloat16"] * 1e3,
          f32 / analysis.PEAKS["float32"] * 1e3, opt / analysis.HBM_BW * 1e3)
    return bf16 / 1e12, f32 / 1e12, opt / 1e9, ms


def hand_train_bound(tcfg, b, s, n_params):
    """The same bound counted by hand from the shapes: a block's
    products run 4x their forward's FLOPs (the forward, its
    recomputation, a backward of twice the work), the loss's
    tied-embedding product 3x (it is not recomputed); the optimizer's 36
    bytes a parameter.  Printed beside the counter's in [dryrun]."""
    t, d = b * s, tcfg.d_model
    blk_bf16 = blk_f32 = 0                    # a block's forward FLOPs
    for pos, kind in enumerate(tcfg.block_pattern):
        if kind == "mamba":
            di, n, nh, p = (tcfg.d_inner, tcfg.ssm_state, tcfg.n_ssm_heads,
                            tcfg.ssm_head_dim)
            blk_bf16 += 2 * t * (d * (2 * di + 2 * n + nh) + di * d)
            q = min(256, s)
            # scores, intra-chunk y, chunk states, inter-chunk y
            blk_f32 += 2 * b * (s // q) * (q * q * n + nh * q * q * p
                                           + 2 * nh * q * p * n)
        else:
            hq = tcfg.n_heads * tcfg.head_dim_
            hk = tcfg.n_kv_heads * tcfg.head_dim_
            blk_bf16 += 2 * t * d * (2 * hq + 2 * hk)
            blk_f32 += 4 * tcfg.head_dim_ * b * tcfg.n_heads \
                * attention_pairs(s)
        if tcfg.d_ff:
            rows = t
            if tcfg.is_moe and pos % tcfg.moe_every == 0:
                rows = tcfg.n_experts * layers.moe_capacity(
                    t, tcfg.top_k, tcfg.n_experts)
            blk_bf16 += 2 * rows * 3 * d * tcfg.d_ff
    bf16 = 4 * blk_bf16 * tcfg.n_blocks + 3 * 2 * t * tcfg.padded_vocab * d
    f32 = 4 * blk_f32 * tcfg.n_blocks
    opt = OPT_BYTES * n_params
    ms = (bf16 / BF16_FLOPS_PER_S * 1e3, f32 / F32_FLOPS_PER_S * 1e3,
          opt / HBM_BYTES_PER_S * 1e3)
    return bf16 / 1e12, f32 / 1e12, opt / 1e9, ms


def split_step(step_fn, state, batch):
    """One train step with CUDA events at the forward's start and end, the
    compression's start (the backward's end) and the optimizer's end.
    Returns (new state, (forward, backward, optimizer) ms)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    real = (steps_lib.get_model, compression.compress_grads, adamw.apply)

    def get_model_timed(tcfg):
        fns = real[0](tcfg)

        def loss_fn(*a, **k):
            ev[0].record()
            out = fns.loss_fn(*a, **k)
            ev[1].record()
            return out
        return fns._replace(loss_fn=loss_fn)

    def compress_timed(*a, **k):
        ev[2].record()
        return real[1](*a, **k)

    def apply_timed(*a, **k):
        out = real[2](*a, **k)
        ev[3].record()
        return out

    steps_lib.get_model, compression.compress_grads, adamw.apply = (
        get_model_timed, compress_timed, apply_timed)
    try:
        *state, _ = step_fn(*state, batch)
        torch.cuda.synchronize()
    finally:
        steps_lib.get_model, compression.compress_grads, adamw.apply = real
    return state, tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3))


def train_run(label, tcfg, n_steps, lr=1e-3, one_batch=False):
    """`n_steps` steps of `make_train_step` (compression on, remat on, AdamW
    lr `lr`, 2 warmup steps) on `make_pipeline`'s B 4 x S 2048 batches
    (under `one_batch`, its first batch every step), weights from seed 0;
    then one step under the profiler and one split by CUDA events.  Prints
    a line a step and the summary."""
    t0 = time.perf_counter()
    params = get_model(tcfg).init_params(
        tcfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    n_params = n_leaf_params(params)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=2, total_steps=n_steps)
    step_fn = steps_lib.make_train_step(tcfg, opt_cfg, compress_grads=True)
    state = [params, adamw.init(params), compression.init(params)]
    del params
    pipe = make_pipeline(DataConfig(vocab=tcfg.vocab, batch=TRAIN_B,
                                    seq_len=TRAIN_S), device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    first = next(pipe)
    for i in range(n_steps):
        step_i, batch = first if i == 0 or one_batch else next(pipe)
        t1 = time.perf_counter()
        *state, m = step_fn(*state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux",
                                                "lr")} | {"wall_ms": wall})
        print(f"[train] {label} step {i} (batch {step_i}): loss "
              f"{rows[-1]['loss']:.4f} "
              f"grad norm {rows[-1]['grad_norm']:.4f} aux "
              f"{rows[-1]['aux']:.4f} lr {rows[-1]['lr']:.2e}, wall "
              f"{wall:.1f} ms ({TRAIN_B * TRAIN_S / wall * 1e3:.0f} "
              f"tokens/s); {SMI_LINE}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    _, batch = next(pipe)
    box = {"state": state}

    def one_step():
        *box["state"], _ = step_fn(*box["state"], batch)

    dev_ms, ev = busy_ms(one_step)
    state, split = split_step(step_fn, box.pop("state"), batch)
    losses = [r["loss"] for r in rows]
    check(all(np.isfinite([r["loss"] for r in rows] +
                          [r["grad_norm"] for r in rows])),
          f"[train] {label}: a loss or grad norm is not finite: {rows}")
    check(losses[-1] < losses[0],
          f"[train] {label}: the loss did not fall: {losses}")
    bf16_t, f32_t, opt_gb, (b_ms, f_ms, o_ms) = train_bound(tcfg)
    walls = [r["wall_ms"] for r in rows[1:]]
    wall = statistics.median(walls)
    print(f"[train] {label}: {n_params / 1e9:.3f} B params, B {TRAIN_B} x S "
          f"{TRAIN_S}, {n_steps} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step wall {wall:.1f} ms (median of steps "
          f"1-{n_steps - 1}; step 0 {rows[0]['wall_ms']:.1f}), "
          f"{TRAIN_B * TRAIN_S / wall * 1e3:.0f} tokens/s; one step's "
          f"device {dev_ms:.1f} ms over {sum(n for _, n, _ in ev)} kernels "
          f"(busy {100 * dev_ms / wall:.1f}% of the wall); forward / "
          f"backward (with the recomputation) / optimizer (compression + "
          f"AdamW) {split[0]:.1f} / {split[1]:.1f} / {split[2]:.1f} ms; "
          f"peak {peak / 1e9:.2f} GB; bound {b_ms + f_ms + o_ms:.1f} ms = "
          f"bf16 products {bf16_t:.2f} TFLOP {b_ms:.1f} ms + f32 "
          f"{f32_t:.2f} TFLOP {f_ms:.1f} ms + update {opt_gb:.1f} GB "
          f"{o_ms:.1f} ms (step / bound {wall / (b_ms + f_ms + o_ms):.2f}); "
          f"kernels by device time: " + "; ".join(
              f"{k[:40]} x{n} {t / 1e3:.1f} ms" for t, n, k in ev[:6])
          + f"; {time.perf_counter() - t0:.1f} s; {SMI_LINE}", flush=True)
    del state, box, batch, first, pipe
    gc.collect()
    torch.cuda.empty_cache()


# (2) starcoder2_3b at full width, its first 8 layers
sc8 = dataclasses.replace(get_config(ARCH), arch_id=f"{ARCH}_first8",
                          n_layers=8)
train_run(f"{ARCH}, its first 8 of 30 layers", sc8, 8)

# (4) mamba2_370m at full width on its first 24 of 48 layers, on one
# batch: its random layers start at a grad norm in the hundreds, and over
# fresh batches its loss stays inside the batches' own spread (PERF.md
# section 6); on one batch it falls.  (5) granite_moe_3b, its first 4
# layers
train_run(f"{MAMBA}, its first 24 of 48 layers, its first batch every step",
          dataclasses.replace(get_config(MAMBA),
                              arch_id=f"{MAMBA}_first24", n_layers=24), 8,
          one_batch=True)
gr4 = dataclasses.replace(get_config(GRANITE), arch_id=f"{GRANITE}_first4",
                          n_layers=4)
train_run(f"{GRANITE}, its first 4 of 32 layers", gr4, 8)

# the [mesh_train] example runs in a process of its own beside the
# untimed parts below (1, 3: card against CPU and bf16 against f32,
# 6: the restart, which checks bits): the timed runs (2, 4, 5) ran
# before it
MESH_TRAIN = start_child("mesh_train", [
    "repro_torch.examples.mesh_train", "--full", "--json",
    str(mt_json)])

# (1) f32 on the card == f32 on the CPU, smoke size
for arch in (ARCH, MAMBA, GRANITE):
    scfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu_params = get_model(scfg).init_params(
        scfg, torch.Generator().manual_seed(0), CPU_DEV)
    sbatch = train_batch(scfg, 2, 32, device=CPU_DEV)
    c_loss, _, c_grads = steps_lib.loss_and_grads(scfg, cpu_params, sbatch)
    g_loss, _, g_grads = steps_lib.loss_and_grads(
        scfg, ptree.map_leaves(lambda t: t.to(DEV), cpu_params),
        {k: v.to(DEV) for k, v in sbatch.items()})
    rel = abs(float(g_loss) - float(c_loss)) / abs(float(c_loss))
    worst = max((g.cpu() - c).abs().max().item()
                / max(c.abs().max().item(), 1e-30)
                for g, c in zip(ptree.leaves(g_grads),
                                ptree.leaves(c_grads)))
    check(rel <= 1e-5 and worst <= 1e-5,
          f"[train] {arch} smoke f32: card vs CPU loss rel {rel:.3e}, "
          f"gradient {worst:.3e} of a leaf's max (gate 1e-5)")
    print(f"[train] {arch} smoke f32, B 2 x S 32: loss card "
          f"{float(g_loss):.7f} CPU {float(c_loss):.7f} (rel {rel:.2e}); "
          f"gradients max |card - CPU| / max |CPU| {worst:.2e} over "
          f"{len(ptree.leaves(c_grads))} leaves (gate 1e-5); {SMI_LINE}",
          flush=True)
del cpu_params, sbatch, c_grads, g_grads

# (3) bf16 against an f32 twin, starcoder2_3b's first 2 layers
sc2 = dataclasses.replace(get_config(ARCH), arch_id=f"{ARCH}_first2",
                          n_layers=2)
p16 = get_model(sc2).init_params(
    sc2, torch.Generator(device=DEV).manual_seed(0), DEV)
p32 = ptree.map_leaves(lambda t: t.float(), p16)
tbatch = train_batch(sc2, TRAIN_B, TRAIN_S)
l16, _, g16 = steps_lib.loss_and_grads(sc2, p16, tbatch)
l32, _, g32 = steps_lib.loss_and_grads(
    dataclasses.replace(sc2, dtype="float32"), p32, tbatch)
loss_rel = abs(float(l16) - float(l32)) / abs(float(l32))
cosines = [float(torch.nn.functional.cosine_similarity(
    a.float().flatten(), b.flatten(), dim=0))
    for a, b in zip(ptree.leaves(g16), ptree.leaves(g32))]
check(loss_rel <= 1e-2 and min(cosines) >= 0.99,
      f"[train] {ARCH} bf16 vs f32 twin: loss rel {loss_rel:.3e}, "
      f"cosines {cosines}")
print(f"[train] {ARCH}, its first 2 layers at full width, bf16 vs an f32 "
      f"twin on the same weights and batch (B {TRAIN_B} x S {TRAIN_S}): "
      f"loss {float(l16):.5f} / {float(l32):.5f} (rel {loss_rel:.2e}, gate "
      f"1e-2); gradient cosines min {min(cosines):.5f} median "
      f"{statistics.median(cosines):.5f} over {len(cosines)} leaves (gate "
      f"0.99); {SMI_LINE}", flush=True)
del p16, p32, g16, g32, tbatch
gc.collect()
torch.cuda.empty_cache()

# (6) restart and preemption of the example's config, in processes of
# their own.  The child runs `train_pipeline.run` once per entry of its
# argument's list; an entry with "stop" raises SIGTERM on its own process
# when the pipeline hands out that step's batch.
TRAIN_CHILD = """
import dataclasses, json, signal, sys
from repro_torch.examples import train_pipeline
from repro_torch.launch import train as tr

# the example's config cut to its first layers (argv[2])
train_pipeline.CONFIG = dataclasses.replace(
    train_pipeline.CONFIG, n_layers=int(sys.argv[2]))

pipeline, stop = tr.make_pipeline, None


def make_pipeline(*args, **kw):
    it = pipeline(*args, **kw)

    def gen():
        for step, batch in it:
            if step == stop:
                signal.raise_signal(signal.SIGTERM)
            yield step, batch
    return gen()


tr.make_pipeline = make_pipeline
for run in json.loads(sys.argv[1]):
    stop = run.pop("stop", None)
    print(f"START {run.pop('label', '')}", flush=True)
    print("RESULT " + json.dumps(train_pipeline.run(**run)), flush=True)
"""
# the restart runs the example's config on its first 2 of 10 layers: a
# checkpoint of the whole config is 1.4 GB, written and compressed 7 times
RESTART_CFG = dataclasses.replace(train_pipeline.CONFIG, n_layers=2)
CKPT_ROOT = ROOT / "build" / "train_ckpt"
shutil.rmtree(CKPT_ROOT, ignore_errors=True)
CK = {k: str(CKPT_ROOT / k) for k in ("whole", "restart", "preempt")}
CHILD_ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def child(runs):
    return subprocess.Popen(
        [sys.executable, "-c", TRAIN_CHILD, json.dumps(runs),
         str(RESTART_CFG.n_layers)], cwd=ROOT,
        env=CHILD_ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def results(proc, head="", timeout=600):
    """The RESULT lines of the child's runs (`head`: what this process has
    already read of its output), and its whole output."""
    out, err = proc.communicate(timeout=timeout)
    out = head + out
    check(proc.returncode == 0, f"[train] restart child failed with "
          f"{proc.returncode}:\n{out[-3000:]}\n{err[-6000:]}")
    return [json.loads(ln[7:]) for ln in out.splitlines()
            if ln.startswith("RESULT ")], out


RESTART_T0 = time.perf_counter()
# the restart's job checkpoints every 3 steps; the other two at the end
# and on the SIGTERM only.  The first process
# runs the 8-step job, the restart's three calls, then the preempted run,
# which this process sends a SIGTERM once it has logged step 2; the
# second process resumes it.
run8 = dict(steps=8, ckpt_every=8, log_every=1)
every3 = dict(run8, ckpt_dir=CK["restart"], ckpt_every=3)
proc = child([dict(run8, ckpt_dir=CK["whole"]), dict(every3, stop=5),
              dict(every3, steps=6), every3,
              dict(run8, ckpt_dir=CK["preempt"], label="preempt")])
seen = []
for line in proc.stdout:
    seen.append(line)
    if line.startswith("[train] step 2 ") and "START preempt\n" in seen:
        proc.send_signal(signal.SIGTERM)
        break
(whole, *restart, preempted), pre_out = results(proc, "".join(seen))
(resumed,), _ = results(child([dict(run8, ckpt_dir=CK["preempt"])]))


def final_leaves(d):
    return torch.load(Path(d) / "step_00000008.ckpt", map_location="cpu",
                      weights_only=True)["leaves"]


want = final_leaves(CK["whole"])
check(whole["steps_run"] == 8 and
      [r["steps_run"] for r in restart] == [6, 0, 2],
      f"[train] restart: steps run {whole['steps_run']} / "
      f"{[r['steps_run'] for r in restart]}, not 8 / [6, 0, 2]")
check(2 < preempted["steps_run"] < 8
      and pre_out.count("[train] preempted at step") == 2 and
      resumed["steps_run"] == 8 - preempted["steps_run"],
      f"[train] preemption: steps run {preempted['steps_run']} + "
      f"{resumed['steps_run']}")
for label, losses, d in (
        ("restart", restart[0]["losses"] + restart[2]["losses"],
         CK["restart"]),
        ("preemption", preempted["losses"] + resumed["losses"],
         CK["preempt"])):
    got = final_leaves(d)
    same = len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    check(losses == whole["losses"] and same,
          f"[train] {label}: losses {losses} vs {whole['losses']}, final "
          f"checkpoint bitwise {same}")
n_ckpt = len(want)
shutil.rmtree(CKPT_ROOT, ignore_errors=True)
print(f"[train] restart and preemption, {RESTART_CFG.arch_id} on its "
      f"first {RESTART_CFG.n_layers} of {train_pipeline.CONFIG.n_layers} "
      f"layers (~{RESTART_CFG.n_params() / 1e6:.0f}M, B 8 x S 256, "
      f"compression on) through launch/train.py in processes of their own: "
      f"steps run 8; 6 / 0 / 2 (a SIGTERM raised at the 6th step, then "
      f"steps=6, then 8); {preempted['steps_run']} + {resumed['steps_run']} "
      f"(a SIGTERM sent after step 2's log line, resumed in a new process): "
      f"every loss and all {n_ckpt} leaves of the final checkpoint == the "
      f"uninterrupted run's, bitwise; loss {whole['losses'][0]:.4f} -> "
      f"{whole['losses'][-1]:.4f}; {time.perf_counter() - RESTART_T0:.1f} s; "
      f"{SMI_LINE}", flush=True)
print(f"[train] phase {time.perf_counter() - TRAIN_T0:.1f} s; "
      f"{time.perf_counter() - T_START:.0f} s into the script", flush=True)

# --------------------------------------------------------------------------
# 6h2. training on a mesh: the ported `examples/mesh_train.py --full` in a
# process of its own (the ranks it spawns import its module), started in
# [train] beside its untimed parts (the card against the CPU, bf16
# against f32, the restart) and read here, two gloo
# ranks on the one card, f32, 3 steps a case, each rank holding its shards
# to the single-device step it runs beside them on the same card by the
# CPU tests' gates (metrics rtol 1e-4, step-0 gradients 1e-5 of a leaf's
# max, the state after step 1 within rtol 2e-4 + atol 1e-5 x the leaf's
# max with a stated few elements off; after step 3 every element within
# the bound, the elements off counted beside a reordered-rows single-device
# control's): starcoder2_3b's first 2 layers, B 4 x S 1024, at 2x1 with
# FSDP forced and at 1x2 compressed; granite_moe_3b's first 2 layers, B 4
# x S 256 at 1x2, whose 1,024 tokens a data shard take `moe_ffn_dist`'s
# expert-parallel branch, 20 of the 40 experts a rank.  Each rank's stored
# bytes, the wire bytes of a step and its wall (gloo stages every
# collective through host memory: not a performance number).  The
# reference's training path reaches no Pallas kernel: no kernel record.
# --------------------------------------------------------------------------

phase("6h2")

mt_stdout, mt_secs = finish_child("[mesh_train]", MESH_TRAIN)
for line in mt_stdout.splitlines():
    if line.startswith("[mesh_train]"):
        print(f"{line}; {SMI_LINE}", flush=True)
mt_cases = json.loads(mt_json.read_text())["cases"]
check(len(mt_cases) == 3, f"[mesh_train] {len(mt_cases)} cases ran")
for name, rep in mt_cases.items():
    check(rep["gates"]["ok"], f"[mesh_train] {name}: {rep['gates']}")
    check(len(rep["rank_stored_bytes"]) == 2
          and max(rep["rank_stored_bytes"]) < rep["single_stored_bytes"],
          f"[mesh_train] {name}: stored {rep['rank_stored_bytes']} against "
          f"{rep['single_stored_bytes']}")
    check(rep["fsdp"] == ("fsdp" in name), f"[mesh_train] {name}: FSDP "
          f"{rep['fsdp']}")
mt_ep = mt_cases["granite_moe_3b 1x2 expert-parallel"]
check(mt_ep["moe_branch"] == "expert-parallel"
      and mt_ep["experts_a_rank"] == 20,
      f"[mesh_train] granite: {mt_ep['moe_branch']}, "
      f"{mt_ep['experts_a_rank']} experts a rank")
print(f"[mesh_train] phase {mt_secs:.1f} s (its process, beside [train]'s "
      f"untimed parts); {time.perf_counter() - T_START:.0f} s into the "
      f"script", flush=True)

# --------------------------------------------------------------------------
# 6i. the dry-run and the roofline held to the card (`launch/dryrun.py`,
# `roofline/cost.py`, `roofline/analysis.py`).  Three single-device cells
# of starcoder2_3b run for real, each once inside the cost counter and
# three times without it (CUDA events, the median):
#   * decode: the full 30 layers, 8 rows (a 16 x 16 rank's batch) over
#     the whole 32,768-slot paged cache, every row at its last slot, so
#     the fused decode's formula (the whole span) is the run's work;
#   * prefill: `logits_fn` on 1 x 32,768 tokens, the first 2 of 30 layers
#     (the plain blocked attention launches ~100,000 kernels a layer at
#     this length; every layer has the same shapes, so the cut keeps a
#     layer's counts);
#   * train: the [train] phase's first 8 layers, B 4 x S 2048 (the loss,
#     its gradients, AdamW; no compression).
# Each cell's FLOPs, bytes and op count on the card == the child's count
# of the same cell on meta tensors; the meta run's predicted peak (its
# arguments plus the peak of what the step allocates) within 10% of the
# growth of max_memory_allocated from before the cell's tensors were
# made; the device time beside the roofline bound and the fraction.  The
# child's 2 x 16 x 16 rows (a decode, a prefill, and the train row that
# is not ported) are printed.
# --------------------------------------------------------------------------

phase("6i")

DRY_T0 = time.perf_counter()
meta = dry_meta()
gc.collect()
torch.cuda.empty_cache()
for name, (kind, arch, layers, b, s) in DRY_CELLS.items():
    dcfg = get_config(arch)
    if layers is not None:
        dcfg = dataclasses.replace(dcfg, arch_id=f"{arch}_first{layers}",
                                   n_layers=layers)
    got = dryrun.card_cell(dcfg, kind, b, s, device=DEV, iters=3)
    want, card = meta["cells"][name], got["counts"]
    same = all(card[k] == want[k] for k in ("flops", "bytes", "n_ops"))
    if not same:
        ops_apart = {k: (card["by_op"].get(k), want["by_op"].get(k))
                     for k in set(card["by_op"]) | set(want["by_op"])
                     if card["by_op"].get(k) != want["by_op"].get(k)}
        print(f"[dryrun] {name}: card {card['flops']} FLOPs "
              f"{card['bytes']} bytes {card['n_ops']} ops, meta "
              f"{want['flops']} / {want['bytes']} / {want['n_ops']}; ops "
              f"apart {ops_apart}; kernels card {card['kernels']} meta "
              f"{want['kernels']}", flush=True)
    check(same, f"[dryrun] {name}: the card's count != the meta count")
    check(got["finite"], f"[dryrun] {name}: a non-finite output")
    pred = want["memory"]["peak_bytes"]
    meas = got["peak_bytes_measured"]
    gap = meas / pred - 1
    check(abs(gap) <= 0.10, f"[dryrun] {name}: measured peak {meas} vs "
          f"predicted {pred} ({100 * gap:+.1f}%)")
    rf = got["roofline"]
    line = (f"[dryrun] {name} {dcfg.arch_id} ({dcfg.n_layers} layers), "
            f"B {b} x {'1 token over ' if kind == 'decode' else 'S '}{s}"
            f"{' slots' if kind == 'decode' else ''}: card == meta count: "
            f"{card['flops'] / 1e12:.4f} TFLOP ("
            + ", ".join(f"{k} {v / 1e12:.4f}"
                        for k, v in card["flops_by_dtype"].items())
            + f"), {card['bytes'] / 1e9:.3f} GB, {card['n_ops']} ops "
            f"({sum(v[2] for v in card['kernels'].values())} kernel calls: "
            + ", ".join(f"{k} x{v[2]}" for k, v in card["kernels"].items())
            + f"); peak predicted {pred / 1e9:.3f} GB, measured "
            f"{meas / 1e9:.3f} GB ({100 * gap:+.2f}%); device "
            f"{got['ms']:.3f} ms (median of 3, CUDA events, no counter; "
            f"runs {', '.join(f'{t:.3f}' for t in got['times_ms'])}); "
            f"bound {got['bound_ms']:.3f} ms ({rf['dominant']}: compute "
            f"{rf['t_compute_s'] * 1e3:.3f}, memory "
            f"{rf['t_memory_s'] * 1e3:.3f} ms at published peaks), device / "
            f"bound {got['ms'] / got['bound_ms']:.2f}, roofline_fraction "
            f"{rf['roofline_fraction']:.4f} (useful FLOPs 2|6 N D at 989 "
            f"TFLOP/s over the bound)")
    if kind == "train":
        hb, hf, hg, (hb_ms, hf_ms, ho_ms) = hand_train_bound(
            dcfg, b, s, sum(math.prod(t.shape) for t in ptree.leaves(
                get_model(dcfg).abstract_params(dcfg))))
        line += (f"; the counter's compute term {rf['t_compute_s'] * 1e3:.1f}"
                 f" ms beside the hand count's {hb_ms + hf_ms:.1f} ms (bf16 "
                 f"{hb:.2f} / f32 {hf:.2f} TFLOP by hand)")
    print(line + f"; {SMI_LINE}", flush=True)
    del got
    gc.collect()
    torch.cuda.empty_cache()
for row in meta["rows"]:
    check(row["status"] == "ok",
          f"[dryrun] {row['arch']} {row['shape']} {row['mesh']}: {row}")
    rf, mem = row["roofline"], row["memory"]
    print(f"[dryrun] {row['arch']} {row['shape']} {row['mesh']} (meta "
          f"tensors, rank 0 of {rf['chips']}): peak "
          f"{mem['peak_bytes'] / 1e9:.3f} GB ({mem['argument_bytes'] / 1e9:.3f}"
          f" GB of arguments); {rf['hlo_flops_per_chip'] / 1e12:.4f} TFLOP, "
          f"{rf['hlo_bytes_per_chip'] / 1e9:.3f} GB, collective "
          f"{rf['coll_bytes_per_chip'] / 1e6:.3f} MB {rf['coll_by_op']}; "
          f"{rf['dominant']}-bound {max(rf['t_compute_s'], rf['t_memory_s'], rf['t_collective_s']) * 1e3:.3f} ms "
          f"at published H100 peaks, roofline_fraction "
          f"{rf['roofline_fraction']:.4f}", flush=True)
print(f"[dryrun] phase {time.perf_counter() - DRY_T0:.1f} s; "
      f"{time.perf_counter() - T_START:.0f} s into the script", flush=True)

# --------------------------------------------------------------------------
# 7. result
# --------------------------------------------------------------------------

records["decode_attention_fused"]["launches"] = \
    main_launches["decode_attention_fused"]
records["flash_attention"]["launches"] = main_launches["flash_attention"]
records["decode_attention_partial"]["launches"] = \
    rp_launches["decode_attention_partial"]
records["ssd_scan"]["launches"] = mamba_launches["ssd_scan"]
for name in ("decode_attention_fused[int8]", "quant_matmul[q8_0]_tc"):
    records[name]["launches"] = quant_launches[name]
records["quant_matmul[q4_k]_tc"]["launches"] = \
    q4_launches["quant_matmul[q4_k]_tc"]
# the skinny (decode) route's launches
for fmt, counts in (("q8_0", quant_launches), ("q4_k", q4_launches)):
    name = f"quant_matmul[{fmt}]"
    records[name]["launches"] = counts[name + "_skinny"]
records["knn_distances"]["launches"] = knn_launches["knn_distances"]
for name, counts in (("[hd256]", g3_launches),
                     ("[hd80]", arch_launches["opt_2_7b"])):
    for fn in ("flash_attention", "decode_attention_fused"):
        records[fn + name]["launches"] = counts[fn]
# gemma3_12b's int8-KV, rp, rp-over-int8 and max_seq 4096 serves (6b)
records["decode_attention_fused[int8][hd256]"]["launches"] = \
    i8_launches_g3["decode_attention_fused[int8]"]
records["decode_attention_partial[hd256]"]["launches"] = \
    rp_launches_g3["decode_attention_partial"]
records["decode_attention_partial[hd256][f32]"]["launches"] = \
    rp8_launches_g3["decode_attention_partial"]
for fn in ("flash_attention", "decode_attention_fused"):
    records[f"{fn}[hd256s{G3_S4K}]"]["launches"] = g3_4k_launches[fn]
records["decode_attention_fused[int8][hd80]"]["launches"] = \
    i8_launches_o["decode_attention_fused[int8]"]
records["decode_attention_partial[hd80]"]["launches"] = \
    rp_launches_o["decode_attention_partial"]
for fn in ("flash_attention", "decode_attention_fused"):
    records[fn + "[hd64]"]["launches"] = gr_launches[fn]
records["decode_attention_fused[int8][hd64]"]["launches"] = \
    g_i8_launches["decode_attention_fused[int8]"]
records["decode_attention_partial[hd64]"]["launches"] = \
    g_rp_launches["decode_attention_partial"]
# the whisper serve's cross reads and the rp serve's cross partials, as
# counted at the cross site, and every whisper prefill's flash
records["decode_attention_fused[enc1500]"]["launches"] = \
    w_launches["decode_attention_fused@cross"]
records["decode_attention_partial[enc1500]"]["launches"] = \
    w_rp_launches["decode_attention_partial@cross"]
records["flash_attention[hd64mha]"]["launches"] = \
    w_launches["flash_attention"]
records["sls"]["launches"] = sls_launches["sls"]
records["decode_attention_fused_partial"]["launches"] = \
    mesh_launches["decode_attention_fused_partial"]
for name, rec in records.items():
    check(rec["launches"] > 0, f"{name} never launched on the main path")
PHASE_T.append(("end", time.perf_counter()))
print("[phases] seconds by section: " + ", ".join(
    f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(PHASE_T, PHASE_T[1:]))
    + f"; {time.perf_counter() - T_START:.0f} s in all", flush=True)
keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
        "library_device_ms")
print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                              for rec in records.values()]}))
print(SMI_LINE)
print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": torch.cuda.get_device_name(0),
    "count": torch.cuda.device_count()}}))
