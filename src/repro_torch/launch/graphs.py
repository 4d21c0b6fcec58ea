"""The decode segment as one CUDA graph: the port's counterpart of the
reference's single jitted dispatch per segment.

`capture_segments` captures each segment function the server builds (full
and `plain`, at `seg_len` and at the per-token 1: the decode segments, or
on a speculative server the draft-and-verify ones) once, at server
construction, against the live parameters and caches; `CapturedSegment`
then runs a segment as one `torch.cuda.CUDAGraph.replay()`:

  * static inputs: the parameters and the caches (the target's, and the
    draft's on a speculative server) are static already (each cache is
    written in place); the functional slot state is copied into the
    graph's own input buffers, on the stream, before each replay;
  * static outputs: a replay returns the graph's output tensors (tokens,
    emit masks, accept lengths, the new state), which the next replay of
    the same graph overwrites; every later read of them is ordered behind
    the replay on the stream, and the server's only host reads are the
    pinned copies it queues right behind the segment;
  * each cache's scalar step counter, which the segment replaces rather
    than writes, is copied back into the live tensor inside the graph;
  * warm-up: the one-step functions run once eagerly before capture (a
    longer segment repeats their body), on clones of the caches and state,
    never on the live ones: it builds and loads the
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

Segment = Callable[..., Tuple[Any, ...]]


class CapturedSegment:
    """One segment function captured as a CUDA graph; call it as the
    function: (*params, *caches, state) -> (*outputs, state, *caches),
    with one parameter tree and one cache for a decode segment, two of
    each (target, draft) for a speculative one.  Build it with
    `capture_segments`."""

    def __init__(self, fn: Segment, params: Sequence[Dict[str, Any]],
                 caches: Sequence[Dict[str, Any]], state: steps.SlotState):
        self.params = tuple(params)
        self.caches = tuple(caches)
        self._captured = [dict(c) for c in caches]
        self._in = steps.clone_state(state)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        n = len(caches)
        with torch.cuda.graph(self.graph):
            res = fn(*params, *[dict(c) for c in caches], self._in)
            for live, work in zip(caches, res[-n:]):
                for key, t in live.items():
                    if work[key] is not t:
                        t.copy_(work[key])
        self.launches = {k: m - before[k] for k, m in LAUNCHES.items()
                         if m != before[k]}
        LAUNCHES.update(before)
        self._out = res[:-n]
        self.replays = 0

    def __call__(self, *args) -> Tuple[Any, ...]:
        n, m = len(self.params), len(self.caches)
        params, caches, state = args[:n], args[n:n + m], args[-1]
        if len(args) != n + m + 1 or any(
                a is not b for a, b in zip(params + caches,
                                           self.params + self.caches)) \
                or any(c.get(k) is not t for c, cap in zip(caches,
                                                           self._captured)
                       for k, t in cap.items()):
            raise RuntimeError("a captured decode segment replays only "
                               "against the parameters and cache tensors "
                               "it was captured with")
        for dst, src in zip(steps.state_tensors(self._in),
                            steps.state_tensors(state)):
            if dst is not src:
                dst.copy_(src)
        self.graph.replay()
        for k, c in self.launches.items():
            LAUNCHES[k] += c
        self.replays += 1
        return (*self._out, *caches)


def capture_segments(fns: Sequence[Segment],
                     params: Sequence[Dict[str, Any]],
                     caches: Sequence[Dict[str, Any]],
                     state: steps.SlotState,
                     warm_up: Sequence[Segment]) -> List[CapturedSegment]:
    """Run each of `warm_up` once on clones of every cache and of the
    state, then capture each of `fns` against the live caches (capture
    executes nothing, so the live caches are untouched).  `warm_up` must
    launch every kernel and cuBLAS shape the captures will: a segment
    repeats its one-step body, so the one-step functions suffice.  Call
    it inside the server's offload context: the protocol's schedule is
    captured with the rest."""
    warm = [{k: v.clone() for k, v in c.items()} for c in caches]
    for fn in warm_up:
        fn(*params, *warm, steps.clone_state(state))
    del warm
    torch.cuda.synchronize()
    return [CapturedSegment(fn, params, caches, state) for fn in fns]
