"""The device mesh (port of ``xpt_mde_tpu.parallel.mesh``).

The JAX package's mesh is a named grid of devices over which XLA shards
arrays. The port's is a grid of ranks, one per card, with the cross-rank
sums made explicitly (``parallel.sharding``, ``parallel.spatial``):

- ``data``: each rank holds the whole model and its share of the global
  batch;
- ``spatial`` (the JAX package's high-res mode): the ranks of one spatial
  group hold the same samples, each a band of the image rows, and exchange
  the rows a convolution reads across a band's edge
  (``parallel.spatial``).

Rank r is (data index r // S, spatial index r % S) for S spatial ranks:
JAX's host-major device order with ``spatial`` the trailing axis, so the
bands of one sample sit on one host. A ``model`` axis larger than 1 is not
ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in a ``(data, spatial)`` mesh.

    :ivar group: the ``torch.distributed`` group of all the mesh's ranks;
        None for a mesh of one process outside any group
    :ivar rank, world_size: this process's rank in ``group`` and its size
    :ivar device: this rank's device
    :ivar spatial: the spatial axis's size S (1: the data mesh)
    :ivar data_group, spatial_group: the groups of this rank's data
        replicas (same spatial index) and of its spatial band partners
        (same data index); None where the axis has one rank
    """

    group: object
    rank: int
    world_size: int
    device: torch.device
    spatial: int = 1
    data_group: object = None
    spatial_group: object = None

    @property
    def axis_names(self) -> tuple:
        return ("data", "spatial") if self.spatial > 1 else ("data",)

    @property
    def data(self) -> int:
        """The data axis's size: the number of batch shares."""
        return self.world_size // self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def shape(self) -> dict:
        if self.spatial > 1:
            return {"data": self.data, "spatial": self.spatial}
        return {"data": self.world_size}


def _axis_groups(world: int, spatial: int, rank: int) -> tuple:
    """(data group, spatial group) of ``rank``: every rank creates every
    group, in one order, as ``dist.new_group`` needs."""
    data_group = spatial_group = None
    for s in range(spatial):
        ranks = list(range(s, world, spatial))
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        if rank in ranks:
            data_group = group
    for d in range(world // spatial):
        ranks = list(range(d * spatial, (d + 1) * spatial))
        group = dist.new_group(ranks)
        if rank in ranks:
            spatial_group = group
    return data_group, spatial_group


def make_mesh(shape: Mapping[str, int] | None = None, group=None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over ``group`` (the default group when one is
    initialized, else this process alone).

    :param shape: ``{"data": W}``, W the group's size (the default), or
        ``{"data": D, "spatial": S}`` with D x S ranks; an axis product
        that differs raises ``ValueError`` as JAX's does, a ``model`` axis
        above 1 ``NotImplementedError``
    :param device: this rank's device; ``cuda:LOCAL_RANK`` by default
    """
    from xpt_mde_tpu_torch.parallel.multihost import local_device

    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    shape = dict(shape) if shape is not None else {"data": world}
    wide = {axis: size for axis, size in shape.items()
            if axis not in ("data", "spatial") and size > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} are not ported: the port's mesh has the 'data' and "
            "'spatial' axes")
    total = math.prod(shape.values())
    if total != world:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {world}")
    if device is None:
        device = local_device()
    spatial = int(shape.get("spatial", 1))
    if spatial == 1:
        return Mesh(group if world > 1 else None, rank, world, torch.device(device))
    if group is not dist.group.WORLD:
        raise NotImplementedError("a spatial mesh spans the default process group")
    data_group, spatial_group = _axis_groups(world, spatial, rank)
    return Mesh(group, rank, world, torch.device(device), spatial, data_group, spatial_group)
