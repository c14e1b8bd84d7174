"""Named device meshes over a ``torch.distributed`` process group.

The port of the JAX package's ``launch/mesh.py``. A JAX mesh names the axes
of an array of devices; here the devices are the ranks of the default
process group, rank ``r`` at row-major position ``r`` of the mesh's shape
(``coord_of``). Axes: pod (the slow links between pods), data (data
parallelism, the batch), model (tensor, expert and index shards).

``MeshShape`` holds the names and sizes only, which is all that the sharding
rules (``distributed/sharding.py``) and the placements' index maps read, so
they run with no process group (JAX's ``AbstractMesh``). ``DeviceMesh`` adds
this rank's coordinate, the device its shards live on, and one sub-group per
axis for the collectives along that axis. Every rank builds every slice's
group, in the same order (``dist.new_group`` is collective: a rank that
skipped one would hang the others), over the default group's backend: NCCL
where each rank has a card, gloo where ranks share one (NCCL refuses two
ranks on one card) or run on the CPU. Without a process group the world is
one rank, and every axis has size 1. The collectives along the groups are in
``distributed/topk.py``.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _world() -> tuple[int, int]:
    """(world size, this rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class MeshShape:
    """Axis names and sizes of a mesh, with no devices: ``axis_names`` and
    ``shape`` (name -> size, in axis order) as a JAX mesh has them."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} must pair up, names unique")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an axis of size < 1")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def sizes(self) -> tuple:
        return tuple(self.shape.values())

    def coord_of(self, rank: int) -> tuple:
        """The coordinate of position ``rank`` in row-major order."""
        coord = []
        for s in reversed(self.sizes):
            rank, c = divmod(rank, s)
            coord.append(c)
        return tuple(reversed(coord))

    def coords(self) -> list:
        """Every coordinate, in row-major (rank) order."""
        return list(itertools.product(*(range(s) for s in self.sizes)))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(f'{n}={s}' for n, s in self.shape.items())})"


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class DeviceMesh(MeshShape):
    """A mesh over the ranks of the default process group (its world must
    have exactly the mesh's size): this rank's ``coord``, the ``device`` its
    shards live on, and ``group(axes)``, the sub-group of the ranks that
    share every coordinate but ``axes`` with this one (None where the axes
    have size 1). A group's ranks are in global rank order, which for one
    axis is the order of its coordinate."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device=None):
        super().__init__(shape, axis_names)
        world, self.rank = _world()
        if world != self.size:
            raise ValueError(f"a mesh of shape {self.shape} needs a world of {self.size} ranks, not {world}")
        self.coord = self.coord_of(self.rank)
        self.device = resolve_device(device)
        self._groups = {}
        for name in self.axis_names:  # every rank, every axis, in the same order
            self._groups[(name,)] = self._new_groups((name,))

    def _new_groups(self, axes: tuple):
        """Create the group of every slice along ``axes`` (collective: every
        rank creates all of them, in one order); return this rank's."""
        if math.prod(self.shape[a] for a in axes) == 1:
            return None
        others = [i for i, n in enumerate(self.axis_names) if n not in axes]
        slices: dict = {}  # the other axes' coordinate -> its ranks, ascending
        for r in range(self.size):
            c = self.coord_of(r)
            slices.setdefault(tuple(c[i] for i in others), []).append(r)
        mine = None
        for ranks in slices.values():
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def group(self, axes):
        """This rank's sub-group along ``axes`` (a name or a tuple of names).
        A tuple's group is made on its first request, which every rank must
        make, in the same order."""
        key = tuple(a for a in self.axis_names if a in _axes(axes))
        if len(key) != len(_axes(axes)):
            raise ValueError(f"axes {axes} are not all axes of {self}")
        if key not in self._groups:
            self._groups[key] = self._new_groups(key)
        return self._groups[key]

    def index(self, axes) -> int:
        """This rank's position along ``axes``, major to minor in the order
        given (``jax.lax.axis_index`` of a tuple of axes)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coord[self.axis_names.index(a)]
        return idx


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with ``multi_pod``.
    Raises unless the world has 256 (512) ranks: the shape is never shrunk."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh(shape, axes, device)


def make_host_mesh(model: int = 1, data: Optional[int] = None, device=None) -> DeviceMesh:
    """A (data, model) mesh over the world that exists (CPU tests, one host)."""
    world, _ = _world()
    data = data or (world // model)
    return DeviceMesh((data, model), ("data", "model"), device)


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1

