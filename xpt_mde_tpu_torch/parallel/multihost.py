"""Coupling processes into one data-parallel run (port of
``xpt_mde_tpu.parallel.multihost``).

The JAX package runs one program per host and couples the hosts with
``jax.distributed``; the port runs one process per card and couples them
with a ``torch.distributed`` process group, as ``torchrun`` starts them:

- ``initialize()`` joins the group, from torchrun's ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` or
  from explicit arguments and an ``init_method``. The backend follows the
  device: NCCL for a card, gloo for the CPU. Neither stands in for the
  other: a group that cannot form raises;
- ranks are host-major (all of host 0's cards, then host 1's), which is
  torchrun's own numbering, so ``make_multihost_mesh`` is the mesh over
  every rank in rank order, and its trailing axes (``spatial``) must
  divide one host's rank count, as JAX's rule keeps them off the network
  between hosts;
- each process feeds only its rows of the global batch (the loaders'
  ``process_index``/``process_count`` slice of the shared shuffle order),
  and ``local_view`` of a batch is those rows;
- exactly one process (``is_main_process``) writes checkpoints, logs and
  the config snapshot.

Not ported: ``lockstep``. It separates XLA's per-host compiles from the
first collective; the port compiles nothing ahead of a step, so there is
nothing to separate.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Mapping

import torch
import torch.distributed as dist


def backend_for(device: torch.device | str) -> str:
    """The collective backend of ``device``: NCCL for a card, gloo for the
    CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type {kind!r}")


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` (torchrun's variable, 0
    without it), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize(device: torch.device | str = "cuda", rank: int | None = None,
               world_size: int | None = None, init_method: str | None = None,
               backend: str | None = None, timeout_s: float = 3600.0) -> None:
    """Join this process to the default process group (nothing when it
    has joined already).

    :param device: the process's device; its type picks the backend
        (:func:`backend_for`). A card is made the current device first,
        as NCCL needs
    :param rank, world_size: default to torchrun's ``RANK`` and
        ``WORLD_SIZE``
    :param init_method: the rendezvous, e.g. ``file:///tmp/x`` or
        ``tcp://localhost:29500``; torchrun's ``env://`` by default
    :param backend: the device's own by default; ``"gloo"`` for several
        ranks on one card, which NCCL refuses
    """
    if dist.is_initialized():
        return
    device = torch.device(device)
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or backend_for(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def process_index() -> int:
    """This process's rank; 0 outside a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 outside a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the one process that owns the file system's side effects
    (checkpoints, history.csv, the config snapshot)."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (nothing outside a group): after a write
    that another process reads next."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# the group the running data-parallel step reduces over (reducing_over)
_step_group = None


@contextlib.contextmanager
def reducing_over(group):
    """For the block, the batch-global quantities of a train step (the
    BatchNorm statistics, md2cmb's kept-pixel count) are summed over the
    ranks of ``group``; a group of one, or None, changes nothing."""
    global _step_group
    if group is None or dist.get_world_size(group) == 1:
        yield
        return
    outer, _step_group = _step_group, group
    try:
        yield
    finally:
        _step_group = outer


def step_group():
    """The group of the enclosing :func:`reducing_over` block, or None."""
    return _step_group


def local_process_count() -> int:
    """The processes on this host: torchrun's ``LOCAL_WORLD_SIZE``, else
    every process."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def make_multihost_mesh(shape: Mapping[str, int] | None = None, device=None):
    """The mesh over every rank of every host, in torchrun's host-major
    rank order (:func:`~xpt_mde_tpu_torch.parallel.mesh.make_mesh`). The
    axes after the first must divide the ranks of one host (ValueError),
    so a sample's bands sit on one host."""
    from xpt_mde_tpu_torch.parallel.mesh import make_mesh

    if shape is not None and len(shape) > 1:
        dims = list(shape.values())
        trailing = 1
        for n in dims[1:]:
            trailing *= n
        if trailing > 1 and local_process_count() % trailing:
            raise ValueError(f"trailing axes {dict(list(shape.items())[1:])} (size {trailing}) "
                             f"must divide the per-host process count {local_process_count()}")
    return make_mesh(shape, device=device)


def local_view(x):
    """The rows of a batch that live on this process: a rank holds only
    its own rows, so this is the identity (as a numpy array for a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x
