"""Fault-tolerant checkpointing: async, atomic, one writer per step.

Layout:  <dir>/ckpt_<step>/ {manifest.json, arrays/<flatkey>.npy} — the
reference's layout and manifest.  Leaves are written with numpy (`np.save`):
a tensor is copied to the host and saved as its numpy array; numpy has no
bfloat16, so a bf16 tensor is stored as its raw 16 bits (a uint16 view) and
the manifest names its dtype — bit for bit, as the reference stores its
ml_dtypes bfloat16 arrays.
Atomicity: writes land in ckpt_<step>.tmp.<pid>.<uid>, manifest last, then
one os.replace — a crash mid-write never corrupts the latest checkpoint, and
a failed write leaves no manifest (its tmp directory is removed).
Async: values are copied to the host synchronously (consistency), disk I/O
happens on a daemon thread (training continues); `save` and `wait` join the
previous write first, so one writer runs at a time.
Restore: `restore(template)` returns a tree shaped like the template —
CPU tensors where the template holds tensors, numpy arrays elsewhere — and
the caller copies them onto its device, or `place` puts them on a mesh
(elastic restore, `distributed/elastic.py`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Mapping

import numpy as np
import torch

_SEP = "::"

# tensor dtypes numpy cannot hold: stored as their raw 16 bits (uint16, as
# the reference stores its bfloat16 arrays), under this manifest name
_EXOTIC = {torch.bfloat16: "bfloat16"}
_EXOTIC_BY_NAME = {name: dt for dt, name in _EXOTIC.items()}


def process_index_and_count() -> tuple[int, int]:
    """(rank, world size) of this writer: torch.distributed's when it is
    initialised, else one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _to_savable(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _EXOTIC:
            return t.view(torch.int16).numpy().view(np.uint16), _EXOTIC[t.dtype]
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, dname: str, as_tensor: bool):
    if dname in _EXOTIC_BY_NAME:
        raw = torch.from_numpy(arr.view(np.int16).copy())
        return raw.view(_EXOTIC_BY_NAME[dname])
    if as_tensor:
        return torch.from_numpy(np.array(arr))
    return arr


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    flat = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            flat.update(_flatten(v, key))
        return flat
    return {prefix: tree}


def _unflatten(template, flat: dict[str, Any], prefix: str = ""):
    if isinstance(template, Mapping):
        return {k: _unflatten(v, flat, f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k, v in template.items()}
    return flat[prefix]


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, meta: dict | None = None,
             blocking: bool = False, whole: bool = False) -> None:
        """Snapshot now; write async unless blocking.  `whole`: the tree's
        leaves are whole (a meshed trainer's gathered state, saved by rank
        0 alone), written as one process writes them, so that every rank
        of any mesh reads the same files back."""
        host = {}
        dtypes = {}
        for k, v in _flatten(tree).items():
            host[k], dtypes[k] = _to_savable(v)
        rank, world = (0, 1) if whole else process_index_and_count()
        manifest = {
            "step": int(step),
            "time": time.time(),
            "process_index": rank,
            "process_count": world,
            "keys": sorted(host),
            "dtypes": dtypes,
            "meta": meta or {},
        }
        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, manifest), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host, manifest)

    def _write(self, step: int, host: dict, manifest: dict) -> None:
        tmp = None
        try:
            final = os.path.join(self.directory, f"ckpt_{step}")
            # pid alone is not unique: two writers in one process (an async
            # save overlapping a blocking one) must not share a tmp dir
            tmp = f"{final}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
            arrays = os.path.join(tmp, "arrays")
            os.makedirs(arrays, exist_ok=True)
            suffix = (
                f".proc{manifest['process_index']}"
                if manifest["process_count"] > 1
                else ""
            )
            for key, arr in host.items():
                np.save(os.path.join(arrays, f"{key}{suffix}.npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        except Exception as e:  # surfaced by the next save() / wait()
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
            self.last_error = e

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"ckpt_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, dict]:
        """Returns (a tree shaped like template, the manifest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        base = os.path.join(self.directory, f"ckpt_{step}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = os.path.join(base, "arrays")
        flat = {}
        dtypes = manifest.get("dtypes", {})
        rank, _ = process_index_and_count()
        for key, leaf in _flatten(template).items():
            path = os.path.join(arrays, f"{key}.npy")
            if not os.path.exists(path):
                path = os.path.join(arrays, f"{key}.proc{rank}.npy")
            flat[key] = _from_savable(np.load(path), dtypes.get(key, ""),
                                      isinstance(leaf, torch.Tensor))
        return _unflatten(template, flat), manifest

    @staticmethod
    def place(tree: Any, shardings: Any):
        """Elastic placement: every leaf (a tensor or a numpy array, whole)
        onto its sharding's mesh — this rank's block of it on this rank's
        device (`distributed/sharding.local_shard`), bit for bit; the whole
        leaf on a mesh of one.  An abstract mesh has no device to place on
        and raises."""
        from repro_torch.distributed.sharding import local_shard
        from repro_torch.launch.mesh import mesh_device

        if isinstance(tree, Mapping):
            return {k: Checkpointer.place(v, shardings[k]) for k, v in tree.items()}
        device = mesh_device(shardings.mesh)
        value = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
        return local_shard(value, shardings).to(device)
