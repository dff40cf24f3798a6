"""The data mesh (port of ``xpt_mde_tpu.parallel.mesh``).

The JAX package's mesh is a named grid of devices over which XLA shards
arrays. The port's is one axis, ``data``: one rank per card, each holding
the whole model and its share of the global batch, with the cross-rank
sums made explicitly (``parallel.sharding``). A ``spatial`` axis (the
image height sharded over cards) or a ``model`` axis larger than 1 is not
ported: height sharding needs a halo exchange before every convolution
(ROADMAP queue 1 item 7, "the height-sharded mesh").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's place in a 1-D data mesh.

    :ivar group: the ``torch.distributed`` group of the mesh's ranks; None
        for a mesh of one process outside any group
    :ivar rank, world_size: this process's rank in ``group`` and its size
    :ivar device: this rank's device
    """

    group: object
    rank: int
    world_size: int
    device: torch.device

    axis_names = ("data",)

    @property
    def shape(self) -> dict:
        return {"data": self.world_size}


def make_mesh(shape: Mapping[str, int] | None = None, group=None,
              device: torch.device | str | None = None) -> Mesh:
    """The data mesh over ``group`` (the default group when one is
    initialized, else this process alone).

    :param shape: ``{"data": W}``, W the group's size (the default); an
        axis product that differs raises ``ValueError`` as JAX's does, a
        ``spatial`` or ``model`` axis above 1 ``NotImplementedError``
    :param device: this rank's device; ``cuda:LOCAL_RANK`` by default
    """
    from xpt_mde_tpu_torch.parallel.multihost import local_device

    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    shape = dict(shape) if shape is not None else {"data": world}
    wide = {axis: size for axis, size in shape.items() if axis != "data" and size > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} are not ported: the port's mesh is the 1-D data mesh; "
            "height sharding needs a halo exchange per convolution (ROADMAP queue 1 "
            "item 7, the height-sharded ('data', 'spatial') mesh)")
    total = math.prod(shape.values())
    if total != world:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {world}")
    if device is None:
        device = local_device()
    return Mesh(group if world > 1 else None, rank, world, torch.device(device))
