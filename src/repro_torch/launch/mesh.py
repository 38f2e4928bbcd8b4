"""Device meshes: named axes over devices.

card       : (1, 1)       axes ("data", "model")          = one card
single pod : (16, 16)     axes ("data", "model")          = 256 devices
multi-pod  : (2, 16, 16)  axes ("pod", "data", "model")   = 512 devices

A mesh is *abstract* (no devices behind it: the production meshes, whose
axis sizes the sharding rules (`distributed/sharding.py`) and the dry run's
per-device arithmetic read, as the reference's dry run lowers for its pod
without running there), a mesh of one device (`make_card_mesh`), or *live*:
one process per device over an initialised `torch.distributed` world
(`make_mesh`, `run_on_mesh`).  A live mesh knows this rank's coordinates,
holds one process group per axis, and its rank's device; each rank computes
on its own shard of every tensor, the way the reference's `shard_map` body
does, and the collectives (`distributed/collectives.py`) run where XLA's
partitioner put them for the reference.

The backend is the caller's choice and nothing switches it: `nccl` for a
card per rank, `gloo` for ranks on the CPU and for ranks that share one
card.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None  # None: an abstract mesh
    # a live mesh of more than one rank: this rank's coordinates, one process
    # group per axis (in axis order) and the world's backend
    coords: tuple[int, ...] | None = None
    groups: tuple[Any, ...] | None = dataclasses.field(default=None, compare=False)
    backend: str | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.axis_sizes} "
                             "differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} devices given "
                             f"{len(self.devices)}")
        if self.devices is not None and self.size > 1 and self.groups is None:
            raise ValueError("a mesh of more than one device runs one process per "
                             "device: build it with make_mesh / run_on_mesh")

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def abstract(self) -> bool:
        return self.devices is None

    @property
    def rank(self) -> int:
        """This process's index among the mesh's devices (row-major)."""
        if self.coords is None:
            return 0
        r = 0
        for c, n in zip(self.coords, self.axis_sizes):
            r = r * n + c
        return r

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (0 on a mesh of one)."""
        if self.coords is None or axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of the ranks that differ from this one along
        `axis` only."""
        return self.groups[self.axis_names.index(axis)]


def make_card_mesh(device: "str | torch.device" = "cuda") -> Mesh:
    """{"data": 1, "model": 1} over one device: the card unless the caller
    asks for the CPU."""
    from repro_torch.nn.module import resolve_device

    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def mesh_name(mesh: Mesh) -> str:
    """The name records carry: card_1x1, pod_16x16, multipod_2x16x16."""
    dims = "x".join(str(n) for n in mesh.axis_sizes)
    if mesh.size == 1:
        return f"card_{dims}"
    return f"{'multipod' if 'pod' in mesh.axis_names else 'pod'}_{dims}"


def _rank_device(backend: str, device: "str | torch.device", rank: int) -> torch.device:
    if backend == "nccl":  # one card per rank
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)  # the ranks share one card
    return device


def make_mesh(shape, axes=("data", "model"), *, backend: str,
              device: "str | torch.device") -> Mesh:
    """The live mesh of this rank inside an initialised `torch.distributed`
    world of `prod(shape)` ranks (row-major over `axes`).  Every rank must
    call it, in the same order as every other collective: it creates one
    process group per line of every axis."""
    import torch.distributed as dist

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world "
                           "(run_on_mesh starts one)")
    if dist.get_backend() != backend:
        raise ValueError(f"a {backend} mesh in a {dist.get_backend()} world")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"a mesh {dict(zip(axes, shape))} needs {math.prod(shape)} "
                         f"ranks, the world has {world}")
    coords, r = [], rank
    for n in reversed(shape):
        coords.append(r % n)
        r //= n
    coords = tuple(reversed(coords))

    def flat(c):
        out = 0
        for ci, n in zip(c, shape):
            out = out * n + ci
        return out

    groups = []
    for i, n in enumerate(shape):
        mine = None
        others = [range(m) for j, m in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            members = []
            for k in range(n):
                c = list(rest)
                c.insert(i, k)
                members.append(flat(c))
            g = dist.new_group(members, backend=backend)
            if rank in members:
                mine = g
        groups.append(mine)
    devices = tuple(_rank_device(backend, device, r) for r in range(world))
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    return Mesh(axes, shape, devices, coords, tuple(groups), backend)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, shape, axes, backend, device, threads, queue):
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        mesh = make_mesh(shape, axes, backend=backend, device=device)
        result = fn(mesh)
        dist.barrier()
        path = None
        if rank == 0:
            # pickled by value into a file, whose name the queue carries: a
            # tensor the queue shared by file descriptor would be gone with
            # this process, and the queue's pipe moves a result of a few GB
            # far more slowly than a file does
            fd, path = tempfile.mkstemp(prefix="run_on_mesh_", suffix=".pkl")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
            except BaseException:
                os.remove(path)
                raise
        queue.put(("ok", rank, path))
    except BaseException:  # reported to the parent, which stops every rank
        queue.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_mesh(fn: Callable[[Mesh], Any], shape, axes=("data", "model"), *,
                backend: str, device: "str | torch.device", threads: int | None = None,
                timeout_s: float = 600.0) -> Any:
    """Spawn one process per device of a `shape` mesh, call `fn(mesh)` on
    every rank with its live mesh, and return rank 0's result (which must
    pickle; hand back host values; it passes through a temporary file).  A
    rank that raises, or a run past `timeout_s`, stops every rank and
    raises here with the rank's traceback.  `fn` must be importable by name
    (a module-level function or a `functools.partial` of one): ranks are
    spawned, never forked.
    `threads` sets each rank's `torch.set_num_threads`."""
    world = math.prod(int(s) for s in shape)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, fn, tuple(shape), tuple(axes),
                               backend, str(device), threads, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    result, done, error = None, 0, None
    try:
        while done < world and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = f"the mesh run passed its {timeout_s:.0f} s limit"
                break
            try:
                status, rank, value = queue.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode is not None and p.exitcode != 0]
                if dead:
                    error = f"rank(s) {dead} exited with {[procs[i].exitcode for i in dead]}"
                continue
            if status == "error":
                error = f"rank {rank} raised:\n{value}"
            else:
                done += 1
                if rank == 0:
                    try:
                        with open(value, "rb") as f:
                            result = pickle.load(f)
                    finally:
                        os.remove(value)
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        # a result rank 0 wrote as the run failed (its time limit) is removed
        # unread
        while error is not None:
            try:
                status, rank, value = queue.get_nowait()
            except (queue_mod.Empty, OSError, EOFError):
                break
            if status == "ok" and value is not None and os.path.exists(value):
                os.remove(value)
        queue.close()
    if error is not None:
        raise RuntimeError(f"run_on_mesh {dict(zip(axes, shape))}: {error}")
    return result


def check_mesh(mesh) -> "Mesh | None":
    """`mesh` if it can run a step: None, a mesh of one device, or a live
    mesh (`make_mesh`).  An abstract mesh of more than one device has no
    processes behind it and raises; so does anything that is not a Mesh."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"{type(mesh).__name__} is not a device mesh "
            "(repro_torch.launch.mesh.Mesh); pass make_card_mesh(), a live mesh "
            "(make_mesh / run_on_mesh) or no mesh")
    if mesh.size != 1 and mesh.abstract:
        raise NotImplementedError(
            f"an abstract mesh of {mesh.size} devices {mesh.shape} has no ranks to "
            "run on; build a live one with make_mesh / run_on_mesh")
    return mesh


def mesh_device(mesh) -> torch.device | None:
    """The device a step on `mesh` runs on: None for no mesh, the device of
    a mesh of one, this rank's device on a live mesh.  An abstract mesh has
    none and raises."""
    if check_mesh(mesh) is None:
        return None
    if mesh.abstract:
        raise NotImplementedError(
            "an abstract mesh has no device to run on; pass make_card_mesh()")
    return mesh.device


def require_mesh_on(mesh, device: torch.device) -> None:
    """A server or trainer on `mesh` runs on this rank's device of the mesh,
    which must be of the program's type (`mesh_device` raises for an
    abstract mesh)."""
    mesh_dev = mesh_device(mesh)
    if mesh_dev is not None and mesh_dev.type != device.type:
        raise ValueError(f"a mesh on {mesh_dev} for a program on {device}")


def is_live(mesh) -> bool:
    """Whether `mesh` is a live mesh of several ranks (`make_mesh`)."""
    return mesh is not None and mesh.groups is not None


def is_parallel(mesh, axis: str) -> bool:
    """Whether `axis` spans more than one rank of a live mesh."""
    return is_live(mesh) and mesh.shape.get(axis, 1) > 1
