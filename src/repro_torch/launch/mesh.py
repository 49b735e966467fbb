"""Meshes of ranks over ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

single pod:  (16, 16)    axes ("data", "model")        — 256 ranks
multi-pod:   (2, 16, 16) axes ("pod", "data", "model") — 512 ranks

A :class:`Mesh` lays the world's ranks out row-major over named axes, as
``torch.distributed.device_mesh.init_device_mesh`` does (it holds one);
its ``.shape`` is a dict from axis name to size, as a JAX mesh's is, so the
sharding tables (``distributed/sharding.py``) read it unchanged. It gives
the rank's coordinate on each axis and the process group of the ranks that
differ from this one only on a given axis or tuple of axes.

Functions, not module constants: importing this module touches no process
group. Without one (a single process) a mesh spans the one rank and every
group is that rank alone.
"""
from __future__ import annotations

import math

import torch.distributed as dist

DATA, MODEL, POD = "data", "model", "pod"

# Rates of one card of the production fleet, from NVIDIA's H100 SXM5 data
# sheet (the 700 W part): the dry run's roofline terms
# (``launch/dryrun.py``) divide by them. Not measured here.
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
H100_HBM_BW = 3.35e12        # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s a direction, a card
IB_BW = 400e9 / 8            # 400 Gb/s InfiniBand NDR a card, bytes/s
NODE_CARDS = 8               # cards a node, joined by NVLink


class Mesh:
    """Ranks ``0 .. world-1`` laid out row-major over ``axes`` of
    ``sizes``. ``device_type`` is the ``DeviceMesh``'s ("cuda" for NCCL
    with one card per rank, "cpu" for gloo, also when gloo carries CUDA
    tensors of ranks that share a card)."""

    def __init__(self, sizes: tuple, axes: tuple, device_type: str = "cpu"):
        if len(sizes) != len(axes):
            raise ValueError(f"{len(sizes)} sizes for axes {axes}")
        self.axes = tuple(axes)
        self.sizes = tuple(int(s) for s in sizes)
        self.shape = dict(zip(self.axes, self.sizes))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(self.sizes) != world:
            raise ValueError(f"a {self.shape} mesh needs "
                             f"{math.prod(self.sizes)} ranks; the world "
                             f"has {world}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.device_mesh = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(
                device_type, self.sizes, mesh_dim_names=self.axes)
        self._groups: dict = {}

    def coordinate(self, rank: int | None = None) -> dict:
        """Axis name -> the rank's coordinate (row-major over the axes)."""
        rank = self.rank if rank is None else rank
        out = {}
        for axis, size in reversed(tuple(zip(self.axes, self.sizes))):
            out[axis] = rank % size
            rank //= size
        return {a: out[a] for a in self.axes}

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks,
        as a size-1 axis would give)."""
        return self.coordinate().get(axis, 0)

    def size(self, axes: tuple) -> int:
        """The product of the sizes of ``axes`` (absent axes count 1)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes: tuple, rank: int | None = None) -> int:
        """The rank's row-major index over ``axes`` in their given order
        (the shard index of a dim sharded over that tuple of axes)."""
        c = self.coordinate(rank)
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + c.get(a, 0)
        return i

    def group_ranks(self, axes: tuple, rank: int | None = None) -> list:
        """The ranks that agree with ``rank`` on every axis outside
        ``axes``, ascending (a process group's rank order)."""
        c = self.coordinate(rank)
        keep = [a for a in self.axes if a not in axes]
        return [r for r in range(math.prod(self.sizes))
                if all(self.coordinate(r)[a] == c[a] for a in keep)]

    def group(self, axes: tuple | str):
        """The process group over ``axes`` that holds this rank, or None
        when that group is this rank alone. A single axis is the
        ``DeviceMesh``'s own group; a tuple's groups are made on first use
        with ``new_group``, a collective of the whole world, so every rank
        asks for the same tuples in the same order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        if not axes:
            return None
        key = tuple(sorted(axes, key=self.axes.index))
        if key not in self._groups:
            if len(key) == 1:
                self._groups[key] = self.device_mesh.get_group(key[0])
            else:
                # one group per coordinate outside ``key``, made in the
                # order of their first ranks (the same on every rank)
                parts: dict = {}
                for r in range(math.prod(self.sizes)):
                    c = self.coordinate(r)
                    parts.setdefault(tuple(c[a] for a in self.axes
                                           if a not in key), []).append(r)
                for ranks in parts.values():
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[key] = g
        return self._groups[key]


def _device_type() -> str:
    return ("cuda" if dist.is_initialized()
            and dist.get_backend() == "nccl" else "cpu")


def make_production_mesh(*, multi_pod: bool = False, model_par: int = 16
                         ) -> Mesh:
    """The production meshes. ``model_par`` re-factorizes the 256 ranks of a
    pod between the data and model axes (16×16 by default); raises unless
    the world has 256 (one pod) or 512 (two) ranks."""
    per_pod = 256
    if per_pod % model_par:
        raise ValueError(f"model_par {model_par} does not divide {per_pod}")
    data = per_pod // model_par
    shape = (2, data, model_par) if multi_pod else (data, model_par)
    axes = (POD, DATA, MODEL) if multi_pod else (DATA, MODEL)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs "
                           f"{math.prod(shape)} ranks; the world has "
                           f"{world} (launch.multihost.bootstrap first)")
    return Mesh(shape, axes, _device_type())


def make_host_mesh(model: int = 1) -> Mesh:
    """A (data, model) mesh over every rank of the world (one rank without
    a process group)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"model {model} does not divide {n} ranks")
    return Mesh((n // model, model), (DATA, MODEL), _device_type())


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1
