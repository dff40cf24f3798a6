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

Rows: the ranks of data index d of D hold rows of the global batch of B
such that, cut into ``grad_accum_steps`` = k contiguous microbatches, their
microbatch i is their share of JAX's global microbatch i (``rank_rows``);
for k = 1 that is the contiguous d-th share.

On a mesh with a ``spatial`` axis (``parallel.spatial``) the S ranks of one
data index hold the same rows, whole: the augmentation's box and resize,
the source frames the synthesis samples and the target pyramid read whole
frames, which are small beside the nets' activations
(:func:`feature_sharding` names the features JAX splits by height). The
steps run the step body inside ``spatial.banded``, where the nets cut
their inputs to the rank's band, and sum the gradients over the whole
mesh: each rank's loss is its bands' share of the global loss. The
per-sample metrics come from the gathered predictions, the same on every
rank of a spatial group, and are averaged as before.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from xpt_mde_tpu_torch.parallel import spatial
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
    """This rank's rows (:func:`rank_rows` of its data index) of a global
    batch that every rank holds whole (numpy arrays or tensors)."""
    batch = len(next(iter(features.values())))
    rows = rank_rows(batch, mesh.data, mesh.data_index, grad_accum_steps)
    return {key: value[torch.from_numpy(rows)] if isinstance(value, torch.Tensor)
            else np.asarray(value)[rows] for key, value in features.items()}


# feature-name prefixes whose arrays carry the image (H, W) axes; poses,
# intrinsics and extrinsics stay data-sharded whatever their rank (pose_gt
# is [B, numsrc, 4, 4]: its axis 1 is not the height)
SPATIAL_KEYS = ("image", "depth_gt", "flow_gt")


def feature_sharding(mesh: Mesh, ndim: int, name: str = "") -> tuple:
    """The JAX package's PartitionSpec of one feature, as a tuple: the
    batch axis on ``data``, and on a mesh with a ``spatial`` axis the
    height of the image-like features by NAME (``image*``, ``depth_gt*``,
    ``flow_gt*``): [B, S, H, W, C] -> (data, None, spatial), [B, H, W, C]
    -> (data, spatial)."""
    if mesh.spatial > 1 and name.startswith(SPATIAL_KEYS) and ndim >= 4:
        return ("data", None, "spatial") if ndim >= 5 else ("data", "spatial")
    return ("data",)


def spatial_keys(features: Mapping, mesh: Mesh) -> list:
    """The features :func:`feature_sharding` splits by height."""
    return [key for key, value in features.items()
            if "spatial" in feature_sharding(mesh, np.ndim(value), key)]


def shard_batch(features: Mapping, mesh: Mesh) -> dict:
    """The process's rows (a loader's slice of the global batch, or
    :func:`local_rows`) as tensors on the rank's device. On a mesh with a
    ``spatial`` axis every rank of a spatial group holds the whole frames:
    the nets cut their inputs to the rank's band (``spatial.to_band``) and
    each rank samples the whole source frames."""
    from xpt_mde_tpu_torch.training.train_step import features_to_device
    return features_to_device(features, mesh.device)


# the modules whose every spatial op the band context covers
_SPATIAL_DEPTH_NETS = ("DepthNetBasic", "DepthNetNoResize", "DepthNetPretrained")
_SPATIAL_POSE_NETS = ("PoseNetBasic", "PoseNetImproved", "PoseNetDeep")
# the depth and pose nets' terms (cmb and md2cmb need the flownet's views)
_SPATIAL_LOSSES = ("L1", "L2", "SSIM", "smoothe", "md2L1", "md2SSIM", "cmbL1", "cmbSSIM",
                   "md2cmbL1", "md2cmbSSIM")
_SPATIAL_FLOW_LOSSES = ("flowL2", "flow_reg")
_SPATIAL_TODO = ("the stereo steps on the spatial mesh (the _R views and terms, the "
                 "left<->right cross-synthesis, stereoPose, the moa terms) and then the other "
                 "backbones and PoseNetPreTrained are ROADMAP queue 1 item 4")


def check_spatial(model: torch.nn.Module, total_loss=None, frozen_nets=None) -> None:
    """Raise NotImplementedError unless ``model`` and ``total_loss`` run on
    bands: the rigid path (a depth net on EfficientNet or the basic
    encoder, a pose net without a backbone, the L1, L2, SSIM, md2 and
    smoothness terms), the flow stage (PWC-Net alone, the flowL2 and
    flow_reg terms) or the joint step (those depth and pose nets beside
    PWC-Net, the cmb and md2cmb terms too). A stereo recipe's terms, moa,
    and the other backbones and pose backbones raise, naming ROADMAP.

    In a train step (``frozen_nets`` given) the joint step's flownet must
    be frozen: the JAX trainer and the port's freeze it in every row that
    trains depth and flow together (``training/trainer.py``), and a
    gradient into PWC-Net through the flow-warped views of the cmb terms
    has no test on bands, so it raises. The eval and predict steps
    (``frozen_nets`` None) take no gradient."""
    from xpt_mde_tpu_torch.models.backbones.efficientnet import EfficientNet

    depth, pose = getattr(model, "depthnet", None), getattr(model, "posenet", None)
    flow = getattr(model, "flownet", None)
    terms = set(getattr(total_loss, "loss_objects", {}))
    if flow is not None and depth is None and pose is None:
        terms -= set(_SPATIAL_FLOW_LOSSES)
        if terms:
            raise NotImplementedError(f"loss terms {sorted(terms)} on the spatial mesh's flow "
                                      f"stage: {_SPATIAL_TODO}")
        return
    if flow is not None and frozen_nets is not None and "flownet" not in frozen_nets:
        raise NotImplementedError("a flownet that trains beside a depth or pose net on the "
                                  "spatial mesh: the joint step freezes it, as every plan "
                                  "row does")
    backbone = getattr(depth, "backbone", None)
    if depth is not None and (type(depth).__name__ not in _SPATIAL_DEPTH_NETS or (
            backbone is not None and not isinstance(backbone, EfficientNet))):
        raise NotImplementedError(f"{type(depth).__name__} on {type(backbone).__name__}: the "
                                  "spatial mesh runs EfficientNet and the basic encoder; "
                                  f"{_SPATIAL_TODO}")
    if pose is not None and (type(pose).__name__ not in _SPATIAL_POSE_NETS
                             or pose.backbone is not None):
        raise NotImplementedError(f"{type(pose).__name__}: the spatial mesh runs the "
                                  f"pose nets without a backbone; {_SPATIAL_TODO}")
    terms -= set(_SPATIAL_LOSSES)
    if terms:
        raise NotImplementedError(f"loss terms {sorted(terms)} on the spatial mesh: "
                                  f"{_SPATIAL_TODO}")


def whole_predictions(preds: Mapping) -> dict:
    """The predictions of a banded forward with every band of a map
    gathered (NHWC maps, rows along axis 1; the flows [B, N, h, W, 2],
    rows along axis 2)."""
    def full(value):
        if isinstance(value, (list, tuple)):
            return [full(v) for v in value]
        if isinstance(value, torch.Tensor) and value.dim() in (4, 5):
            return spatial.whole(value, value.dim() - 3)
        return value
    return {key: full(value) for key, value in preds.items()}


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
                             grad_accum_steps: int = 1, timed: bool = False) -> Callable:
    """The train step over ``mesh``: ``make_train_step``'s body on the
    rank's rows (:func:`rank_rows`), inside ``reducing_over`` the mesh's
    group (and on a spatial mesh ``spatial.banded``, on the whole frames
    :func:`shard_batch` gave), with the gradients
    summed before the optimizer step and the metrics reduced after it.

    ``total_loss.batch_size`` must be the GLOBAL batch. ``step(features,
    generator)``: every rank passes a generator seeded alike, so every
    rank draws the same augmentation, as JAX draws one per global batch.
    ``step.reduce_ms()`` is the last step's gradient all-reduce time;
    on a spatial mesh ``step.band_stats`` the last step's
    ``spatial.BandStats`` (its collectives' seconds with ``timed``).
    """
    from xpt_mde_tpu_torch.training.train_step import make_train_step

    if getattr(total_loss, "batch_size", None) is None:
        raise ValueError("a data-parallel step needs total_loss built with batch_size = the "
                         "GLOBAL batch size")
    if mesh.spatial > 1:
        check_spatial(model, total_loss, set(frozen_nets) - {regularize_net})
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
        with reducing_over(mesh.group), spatial.banded(mesh, timed) as band:
            if band is not None:
                spatial.register_frames(features, spatial_keys(features, mesh))
            metrics = body(features, generator)
        step.band_stats = None if band is None else band.stats
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


def make_parallel_eval_step(model: torch.nn.Module, total_loss, mesh: Mesh) -> Callable:
    """The eval step over ``mesh`` on the rank's rows (and bands):
    ``make_eval_step`` inside ``reducing_over`` the mesh's group, the
    metrics reduced over it."""
    from xpt_mde_tpu_torch.training.train_step import make_eval_step

    if mesh.spatial > 1:
        check_spatial(model, total_loss)
    body = make_eval_step(model, total_loss)

    def eval_step(features: Mapping[str, torch.Tensor]) -> dict:
        with reducing_over(mesh.group), spatial.banded(mesh) as band:
            if band is not None:
                spatial.register_frames(features, spatial_keys(features, mesh))
            metrics = body(features)
        return reduce_metrics(metrics, mesh.group)

    return eval_step


def make_parallel_predict_step(model: torch.nn.Module, mesh: Mesh) -> Callable:
    """The predict step over ``mesh``: on a spatial mesh the nets run on
    the rank's bands and the predicted maps come back whole on every rank
    of its spatial group; on the data mesh ``make_predict_step``."""
    from xpt_mde_tpu_torch.training.train_step import make_predict_step

    body = make_predict_step(model)
    if mesh.spatial == 1:
        return body
    check_spatial(model)

    def predict_step(features: Mapping[str, torch.Tensor]) -> dict:
        with spatial.banded(mesh):
            spatial.register_frames(features, spatial_keys(features, mesh))
            preds = body(features)
            with torch.inference_mode():
                return whole_predictions(preds)

    return predict_step
