"""Logical meshes for the dry run (port of ``repro.launch.mesh``).

A mesh here is a shape and its axis names, nothing more: the dry run
places tensors on it by arithmetic (``parallel.sharding.local_shape``), so
no device, process group or rank is created or needed.  The JAX package's
meshes are kept as they are, because the configs' ``kv_repeat`` is chosen
for 16 query-head shards (``models/config.py``):

  single-pod : (data=16, model=16)            = 256 chips
  multi-pod  : (pod=2, data=16, model=16)     = 512 chips; ``pod`` is pure
               data parallelism.

On H100 clusters of ``NODE_CHIPS`` cards a node (NVLink inside, the
inter-node network between), chips are numbered row-major over the mesh
(the last axis fastest) and filled into nodes in that order.  So a
``model`` axis of 16 spans two nodes, and ``group_link`` says which link a
collective over some axes crosses.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

#: cards a node: an HGX / DGX H100 board, NVLink all to all inside
NODE_CHIPS = 8


@dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``shape[i]`` chips along ``axis_names[i]``."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ "
                             f"in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(int(s) for s in shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small (data, model) mesh; (1, 1) is one card."""
    return make_mesh((data, model), ("data", "model"))


def mesh_num_chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape)


def group_link(mesh: Mesh, axes) -> str | None:
    """The link a collective over mesh ``axes`` crosses: ``"nvlink"`` when
    every group of chips varying along them lies inside one node,
    ``"inter-node"`` when some group spans nodes, ``None`` for groups of
    one chip (no collective)."""
    axes = (axes,) if isinstance(axes, str) else tuple(a for a in axes if a is not None)
    idx = [mesh.axis_names.index(a) for a in axes]
    if math.prod(mesh.shape[i] for i in idx) == 1:
        return None
    strides = [math.prod(mesh.shape[i + 1:]) for i in range(len(mesh.shape))]
    others = [i for i in range(len(mesh.shape)) if i not in idx]
    for base in itertools.product(*(range(mesh.shape[i]) for i in others)):
        origin = sum(c * strides[i] for c, i in zip(base, others))
        nodes = {(origin + sum(c * strides[i] for c, i in zip(coords, idx))) // NODE_CHIPS
                 for coords in itertools.product(*(range(mesh.shape[i]) for i in idx))}
        if len(nodes) > 1:
            return "inter-node"
    return "nvlink"
