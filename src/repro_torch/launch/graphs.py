"""The decode segment as one CUDA graph: the port's counterpart of the
reference's single jitted dispatch per segment.

`capture_segments` captures each segment function the server builds (full
and `plain`, at `seg_len` and at the per-token 1) once, at server
construction, against the live parameters and cache; `CapturedSegment`
then runs a segment as one `torch.cuda.CUDAGraph.replay()`:

  * static inputs: the parameters and the cache are static already (the
    cache is written in place); the functional slot state is copied into
    the graph's own input buffers, on the stream, before each replay;
  * static outputs: a replay returns the graph's output tensors (tokens,
    emit masks, the new state), which the next replay of the same graph
    overwrites; every later read of them is ordered behind the replay on
    the stream, and the server's only host reads are the pinned copies it
    queues right behind the segment;
  * the cache's scalar step counter, which the segment replaces rather
    than writes, is copied back into the live tensor inside the graph;
  * warm-up: each function runs once eagerly before capture, on clones of
    the cache and state, never on the live ones: it builds and loads the
    kernels' library, makes the kernels' first-call shared-memory opt-ins
    and creates cuBLAS's handles while no capture is open;
  * launch counts: `LAUNCHES` counts in Python, which a replay does not
    run, so each graph records the counts its capture added (and takes
    them back: capture runs nothing) and adds them at every replay;
  * each graph has its own memory pool: one graph's outputs stay live
    across another's replay.

There is no fallback: a failed capture raises, and a replay against
parameters or cache tensors other than those captured raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import steps

Segment = Callable[..., Tuple[torch.Tensor, torch.Tensor, steps.SlotState,
                              Dict[str, Any]]]


class CapturedSegment:
    """One segment function captured as a CUDA graph; call it as the
    function: (params, cache, state) -> (segment, emitted, state, cache).
    Build it with `capture_segments`."""

    def __init__(self, fn: Segment, params: Dict[str, Any],
                 cache: Dict[str, Any], state: steps.SlotState):
        self.params = params
        self.cache = cache
        self._captured = dict(cache)
        self._in = steps.clone_state(state)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            seg, emit, out, work = fn(params, dict(cache), self._in)
            for key, live in cache.items():
                if work[key] is not live:
                    live.copy_(work[key])
        self.launches = {k: n - before[k] for k, n in LAUNCHES.items()
                         if n != before[k]}
        LAUNCHES.update(before)
        self._out = (seg, emit, out)
        self.replays = 0

    def __call__(self, params: Dict[str, Any], cache: Dict[str, Any],
                 state: steps.SlotState
                 ) -> Tuple[torch.Tensor, torch.Tensor, steps.SlotState,
                            Dict[str, Any]]:
        if params is not self.params or cache is not self.cache or any(
                cache.get(k) is not t for k, t in self._captured.items()):
            raise RuntimeError("a captured decode segment replays only "
                               "against the parameters and cache tensors "
                               "it was captured with")
        for dst, src in zip(steps.state_tensors(self._in),
                            steps.state_tensors(state)):
            if dst is not src:
                dst.copy_(src)
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        self.replays += 1
        seg, emit, out = self._out
        return seg, emit, out, cache


def capture_segments(fns: Sequence[Segment], params: Dict[str, Any],
                     cache: Dict[str, Any], state: steps.SlotState
                     ) -> List[CapturedSegment]:
    """Warm each function up once on one clone of the cache and state,
    then capture each against the live cache (capture executes nothing,
    so the live cache is untouched).  Call it inside the server's offload
    context: the protocol's schedule is captured with the rest."""
    warm = {k: v.clone() for k, v in cache.items()}
    for fn in fns:
        fn(params, warm, steps.clone_state(state))
    del warm
    torch.cuda.synchronize()
    return [CapturedSegment(fn, params, cache, state) for fn in fns]
