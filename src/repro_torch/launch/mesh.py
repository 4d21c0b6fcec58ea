"""The serving mesh over `torch.distributed`: the port of `launch/mesh.py`.

One process a shard.  `make_debug_mesh(n_data, n_model)` lays the ranks
of an initialised process group out as a ("data", "model") DeviceMesh;
`spawn` starts such a group on this host for a function (the tests and
`chip_smoke.py`), `init_from_env` joins one started by `torchrun` (the
serving CLI's `--mesh`).

The backend is gloo, on the CPU and on the card alike: NCCL refuses two
ranks on one device, and a one-card machine runs every rank on it.  Gloo
moves host tensors, so the mesh's transport (`core/backstream.py`)
stages a CUDA tensor through host memory; every computation stays on the
card.  The mesh is a CPU-typed DeviceMesh for that reason: its groups
carry host tensors, whatever device the model runs on.

`make_production_mesh` lays out the dry-run's production meshes, 16 x 16
and 2 x 16 x 16, over torch's "fake" process group (`init_fake_group`):
one per process, its collectives complete at once and move nothing.  It
comes from a private torch module
(`torch.testing._internal.distributed.fake_pg`), imported here and
nowhere else.  The dry-run runs rank 0's program on meta tensors (shapes
and dtypes, no storage): on this CPU-only build a fake CUDA tensor
(`FakeTensorMode`) fails at a slice, an `expand` or a `clone` ("not
linked with support for cuda devices"), and fake CPU tensors cost six
times the meta ones' time an op; the model code takes no branch on the
device, so the ops are the card's either way.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")
PRODUCTION_AXES = ("pod", "data", "model")
# a collective that waits longer than this fails its rank
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> DeviceMesh:
    """The ranks of the initialised process group as an (n_data, n_model)
    ("data", "model") mesh, rank r at (r // n_model, r % n_model)."""
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs an initialised process "
                           "group (mesh.spawn, or torchrun with "
                           "init_from_env)")
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} ranks; the group has {world}")
    return init_device_mesh("cpu", (n_data, n_model), mesh_dim_names=AXES)


# ranks of the fake group: the larger production mesh's
FAKE_WORLD = 512


def init_fake_group() -> None:
    """Rank 0 of a FAKE_WORLD-rank "fake" process group: collectives
    complete at once and move nothing.  One per process, as the
    reference's placeholder device count is; raises if another group is
    already initialised (a fake group would break a real mesh's ranks in
    the same process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake":
            return
        raise RuntimeError("init_fake_group: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", rank=0, world_size=FAKE_WORLD,
                            store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The dry-run's production layouts over the fake group, CPU-typed
    like `make_debug_mesh`, rank 0 at coordinate 0: one pod (data 16,
    model 16) over ranks 0..255, or two (pod 2, data 16, model 16) over
    all 512, the pod axis joining data for the batch.  Sets up the fake
    group when none is (`init_fake_group`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = PRODUCTION_AXES if multi_pod else AXES
    init_fake_group()
    n = 1
    for d in shape:
        n *= d
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def parse_mesh(text: str) -> tuple:
    """"DATAxMODEL" -> (n_data, n_model)."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                  for p in parts):
        raise ValueError(f"mesh {text!r}: want DATAxMODEL, e.g. 1x2")
    return int(parts[0]), int(parts[1])


def init_from_env(n_data: int, n_model: int) -> DeviceMesh:
    """Join the process group `torchrun` started (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT in the environment) and lay it out as the
    mesh.  Raises unless WORLD_SIZE is n_data * n_model."""
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if world != n_data * n_model:
        raise ValueError(f"mesh {n_data}x{n_model} needs WORLD_SIZE="
                         f"{n_data * n_model}; got {world or 'none'} (run "
                         f"under torchrun --nproc-per-node "
                         f"{n_data * n_model})")
    dist.init_process_group("gloo", init_method="env://",
                            timeout=COLLECTIVE_TIMEOUT)
    return make_debug_mesh(n_data, n_model)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable[..., Any], rank: int, n_data: int,
               n_model: int, port: int, device: str, threads: int,
               args: tuple, out: "mp.Queue") -> None:
    """One rank: join the group, build the mesh, run fn, report."""
    try:
        torch.set_num_threads(threads)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=n_data * n_model, timeout=COLLECTIVE_TIMEOUT)
        try:
            mesh = make_debug_mesh(n_data, n_model)
            result = fn(mesh, device, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result if rank == 0 else None))
    except Exception:              # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], n_data: int, n_model: int, *,
          device: str = "cpu", args: tuple = (), threads: int = 1,
          timeout: float = 1200.0) -> Any:
    """Run `fn(mesh, device, *args)` on every rank of an n_data x n_model
    gloo group of fresh processes on this host (start method "spawn",
    127.0.0.1, a free port, `threads` torch threads a rank) and return
    rank 0's result.  A rank that raises fails the call with its
    traceback; one that dies without a word, or a group that outlasts
    `timeout` seconds, fails it too.  Every process is ended before this
    returns.  `fn` and its result must pickle (a module-level function)."""
    world = n_data * n_model
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n_data, n_model, port, device,
                               threads, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    reports = {}
    deadline = time.monotonic() + timeout
    try:
        while len(reports) < world:
            try:
                rank, ok, payload = out.get(timeout=0.5)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in reports and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"mesh rank {dead[0]} of {n_data}x{n_model} died "
                        f"with exit code {procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mesh {n_data}x{n_model} outlasted {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} of {n_data}x{n_model} "
                                   f"failed:\n{payload}")
            reports[rank] = payload
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return reports[0]


def rank_device(device: Optional[str]) -> torch.device:
    """This rank's device: the one card of a one-card host for every rank,
    else the card of the rank's index on the host; a CPU device as
    given."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % max(1, torch.cuda.device_count()))
    return dev
