"""The data-parallel train step (port of ``xpt_mde_tpu.parallel.sharding``).

The JAX package jits the single-device step over a mesh with the batch
sharded and the state replicated; XLA then makes every reduction over the
batch a global one. The port runs the SAME step body
(``training.train_step.make_train_step``, no duplicated body to drift) in
each rank on its rows, and adds the cross-rank sums that SPMD gave JAX:

- the BatchNorm statistics of the global batch and md2cmb's kept-pixel
  count (``multihost.reducing_over`` the mesh's group for the step);
- the gradients, SUMMED over the ranks once per optimizer step: every loss
  term is a sum over samples divided by the GLOBAL batch
  (``TotalLoss.batch_size``), so the ranks' gradients are partial sums of
  the global one. DDP's mean would divide by the world size again;
- the metrics: the loss terms summed, the per-sample means averaged, so
  every rank logs the values JAX's replicated scalars hold.

The gradients go through an explicit bucketed all-reduce after the
backward, not ``DistributedDataParallel``: the sum (DDP averages), frozen
nets and microbatches need nothing special (a gradient that does not exist
is not reduced, and the reduction runs once per optimizer step rather than
in every microbatch's backward), the train-mode BatchNorms' own
all-reduces run in the forward and backward in one order on every rank
(DDP's bucket all-reduces would interleave with them), and the model stays
the single-process module, so checkpoints keep its state-dict keys (no
``module.`` prefix). What it gives up is DDP's overlap of the reduction
with the backward.

Rows: rank r of W holds rows of the global batch of B such that, cut into
``grad_accum_steps`` = k contiguous microbatches, its microbatch i is its
share of JAX's global microbatch i (``rank_rows``); for k = 1 that is the
contiguous r-th share.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from xpt_mde_tpu_torch.parallel.mesh import Mesh
from xpt_mde_tpu_torch.parallel.multihost import reducing_over

# the gradients' all-reduce buckets
BUCKET_BYTES = 25 * 2**20


def rank_rows(global_batch: int, world_size: int, rank: int,
              grad_accum_steps: int = 1) -> np.ndarray:
    """The rows of a global batch that ``rank`` holds: for each of the k
    contiguous global microbatches of B/k rows, its r-th share of B/(kW)
    rows, in order. Raises unless kW divides B."""
    k = grad_accum_steps
    if global_batch % (k * world_size):
        raise ValueError(f"global batch {global_batch} must divide by grad_accum_steps {k} "
                         f"x world size {world_size}")
    share, micro = global_batch // (k * world_size), global_batch // k
    return np.concatenate([np.arange(i * micro + rank * share, i * micro + (rank + 1) * share)
                           for i in range(k)])


def local_rows(features: Mapping, mesh: Mesh, grad_accum_steps: int = 1) -> dict:
    """This rank's rows (:func:`rank_rows`) of a global batch that every
    rank holds whole (numpy arrays or tensors)."""
    batch = len(next(iter(features.values())))
    rows = rank_rows(batch, mesh.world_size, mesh.rank, grad_accum_steps)
    return {key: value[torch.from_numpy(rows)] if isinstance(value, torch.Tensor)
            else np.asarray(value)[rows] for key, value in features.items()}


def shard_batch(features: Mapping, mesh: Mesh) -> dict:
    """The process's rows (a loader's slice of the global batch, or
    :func:`local_rows`) as tensors on the rank's device."""
    from xpt_mde_tpu_torch.training.train_step import features_to_device
    return features_to_device(features, mesh.device)


def _source(mesh: Mesh) -> int:
    return dist.get_global_rank(mesh.group, 0)


@torch.no_grad()
def replicate_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer | None,
                    mesh: Mesh) -> None:
    """Broadcast rank 0's parameters, buffers (the BatchNorm running
    statistics) and optimizer state to every rank, in place (a tensor off
    the rank's device, as Adam's step count, through a copy on it)."""
    if mesh.group is None:
        return
    tensors = list(model.state_dict().values())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                tensors.extend(v for v in optimizer.state.get(p, {}).values()
                               if isinstance(v, torch.Tensor))
    for tensor in tensors:
        if tensor.device == mesh.device:
            dist.broadcast(tensor, _source(mesh), group=mesh.group)
        else:
            moved = tensor.to(mesh.device)
            dist.broadcast(moved, _source(mesh), group=mesh.group)
            tensor.copy_(moved)


def sum_gradients(params: Sequence[torch.nn.Parameter], group) -> None:
    """Replace each existing ``.grad`` of ``params`` by its sum over the
    ranks of ``group``: one all-reduce per bucket of BUCKET_BYTES, each
    bucket one dtype, in parameter order (the same on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    buckets, current, size = [], [], 0
    for grad in grads:
        if current and (size + grad.numel() * grad.element_size() > BUCKET_BYTES
                        or grad.dtype != current[0].dtype):
            buckets.append(current)
            current, size = [], 0
        current.append(grad)
        size += grad.numel() * grad.element_size()
    if current:
        buckets.append(current)
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(bucket, [piece.view_as(g) for piece, g in zip(
            flat.split([g.numel() for g in bucket]), bucket)])


def reduce_metrics(metrics: Mapping[str, torch.Tensor], group) -> dict:
    """The step's metrics over the ranks: ``loss`` and ``loss/*`` (sums
    over the samples divided by the global batch) summed, the others
    (means over the rank's rows, which are equal in number) averaged."""
    if group is None:
        return dict(metrics)
    keys = list(metrics)
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(values, group=group)
    world = dist.get_world_size(group)
    return {k: v if k == "loss" or k.startswith("loss/") else v / world
            for k, v in zip(keys, values)}


def make_parallel_train_step(model: torch.nn.Module, total_loss,
                             optimizer: torch.optim.Optimizer, mesh: Mesh, augmenter=None,
                             regularize_net: str | None = None, frozen_nets=(),
                             grad_accum_steps: int = 1) -> Callable:
    """The train step over ``mesh``: ``make_train_step``'s body on the
    rank's rows (:func:`rank_rows`), inside ``reducing_over`` the mesh's
    group, with the gradients summed before the optimizer step and the
    metrics reduced after it.

    ``total_loss.batch_size`` must be the GLOBAL batch. ``step(features,
    generator)``: every rank passes a generator seeded alike, so every
    rank draws the same augmentation, as JAX draws one per global batch.
    ``step.reduce_ms()`` is the last step's gradient all-reduce time.
    """
    from xpt_mde_tpu_torch.training.train_step import make_train_step

    if getattr(total_loss, "batch_size", None) is None:
        raise ValueError("a data-parallel step needs total_loss built with batch_size = the "
                         "GLOBAL batch size")
    params = [p for group in optimizer.param_groups for p in group["params"]]
    timing = {"events": None, "ms": 0.0}

    def reduce_gradients():
        if mesh.group is None:
            return
        if mesh.device.type != "cuda":
            t0 = time.perf_counter()
            sum_gradients(params, mesh.group)
            timing["ms"], timing["events"] = (time.perf_counter() - t0) * 1e3, None
            return
        timing["events"] = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        timing["events"][0].record()
        sum_gradients(params, mesh.group)
        timing["events"][1].record()

    body = make_train_step(model, total_loss, optimizer, augmenter=augmenter,
                           frozen_nets=frozen_nets, regularize_net=regularize_net,
                           grad_accum_steps=grad_accum_steps,
                           reduce_gradients=reduce_gradients)

    def step(features: Mapping[str, torch.Tensor],
             generator: torch.Generator | None = None) -> dict:
        with reducing_over(mesh.group):
            metrics = body(features, generator)
        return reduce_metrics(metrics, mesh.group)

    def reduce_ms() -> float:
        """The last step's gradient all-reduce, in milliseconds (between
        CUDA events on a card: waits for them)."""
        events = timing["events"]
        if events is not None:
            events[1].synchronize()
            timing["ms"], timing["events"] = events[0].elapsed_time(events[1]), None
        return timing["ms"]

    step.reduce_ms = reduce_ms
    return step
