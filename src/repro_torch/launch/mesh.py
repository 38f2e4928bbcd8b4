"""Device meshes: named axes over devices.

card       : (1, 1)       axes ("data", "model")          = one card
single pod : (16, 16)     axes ("data", "model")          = 256 devices
multi-pod  : (2, 16, 16)  axes ("pod", "data", "model")   = 512 devices

The port runs on one card: `make_card_mesh` is the only mesh a step,
a server or a trainer takes.  The production meshes are *abstract* (no
devices behind them): they carry the axis sizes the sharding rules
(`distributed/sharding.py`) and the dry run's per-device arithmetic read,
as the reference's dry run lowers for its pod without running there.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...] | None = None  # None: an abstract mesh

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.axis_sizes} "
                             "differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} devices given "
                             f"{len(self.devices)}")

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


def mesh_of_one(mesh) -> "Mesh | None":
    """`mesh` if it is None or a mesh of one device (abstract or not);
    anything else raises: more than one card is outside this one-card
    port."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"{type(mesh).__name__} is not a device mesh "
            "(repro_torch.launch.mesh.Mesh); pass make_card_mesh() or no mesh")
    if mesh.size != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices {mesh.shape}: more than one card is "
            "outside this one-card port; run on make_card_mesh()")
    return mesh


def mesh_device(mesh) -> torch.device | None:
    """The device a step on `mesh` runs on: None for no mesh, the device of
    a mesh of one.  An abstract mesh has none and raises, as does a mesh of
    more than one device (`mesh_of_one`)."""
    if mesh_of_one(mesh) is None:
        return None
    if mesh.abstract:
        raise NotImplementedError(
            "an abstract mesh has no device to run on; pass make_card_mesh()")
    return mesh.devices[0]


def require_mesh_on(mesh, device: torch.device) -> None:
    """A server or trainer on `mesh` runs on the mesh's one device, which
    must be the program's (`mesh_device` raises for any other mesh)."""
    mesh_dev = mesh_device(mesh)
    if mesh_dev is not None and mesh_dev.type != device.type:
        raise ValueError(f"a mesh on {mesh_dev} for a program on {device}")
