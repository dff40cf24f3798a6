"""Plan-driven training (port of ``xpt_mde_tpu.training.trainer``).

``train_by_plan`` walks ``Config.training_plan``: each row (nets, dataset,
epochs, learning rate, loss recipe, scale weights, save_ckpt) runs its
epochs on a model and optimizer of its own, which are freed before the
next row builds its own. Rows that ``history.csv`` shows done are
skipped. Per row: shard loaders, ``ModelFactory``, augmentation, the loss
recipe, constant-lr Adam; the flownet is frozen in a row that trains
depth and flow together, and ``flow_reg`` regularizes the flownet. Each
row starts from the weights of the nets it shares with the rows before
(``restore_params``), or resumes its own full state and optimizer
(``restore_full``, same row only), or its mid-epoch checkpoint.

Per epoch: train, validate, then the "latest" checkpoint, then the
``history.csv`` row, then the midway checkpoint is dropped (in that
order: history.csv drives resume, so an epoch's weights are on disk
before the log claims it); then, on the main process, one predict step
on a fixed example batch writes the depth and pose quantiles
(``scales.txt``) and the reconstruction panels (``reconstruction/``);
"ep{NN}" at a row's end.

One process on one card, or one per card over a data mesh
(``parallel.make_mesh``, one rank per card): ``cfg.batch_size`` is then
the GLOBAL batch, each rank's loader reads its ``batch_size / W`` rows of
the shared shuffle order (a global batch that W does not divide raises),
the step is ``parallel.make_parallel_train_step`` (BatchNorm statistics,
md2cmb's count, gradients and metrics over the global batch), and the
validation metrics are reduced over the ranks too, so every rank logs the
values a single process would. On a mesh with a ``spatial`` axis
(``{"data": D, "spatial": S}``: the rigid path, the flow stage and the
joint step, its flownet frozen) the S ranks of one data index read the
same rows, and the train and eval steps run on their bands of the image
rows (``parallel.spatial``); a stereo row raises. Only the main process writes the config
snapshot, the checkpoints and ``history.csv``; every rank reads them at a
resume, each after a barrier that follows the writes.
``grad_accum_steps > 1`` splits each batch into that many microbatches
before one optimizer step. The step's random stream is a CPU
``torch.Generator`` seeded from (epoch, step), the same on every rank (one
augmentation per global batch), so a run resumed mid-epoch draws what the
uninterrupted run drew. Metrics add up on the device and are read once
per log interval.
"""

from __future__ import annotations

import gc
import itertools
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from xpt_mde_tpu_torch.config import Config, TrainStage
from xpt_mde_tpu_torch.data import example_batch
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.parallel import (barrier, is_main_process, make_parallel_train_step,
                                        replicate_state, shard_batch)
from xpt_mde_tpu_torch.parallel.sharding import make_parallel_eval_step
from xpt_mde_tpu_torch.training.augmentation import augmentation_factory
from xpt_mde_tpu_torch.training.checkpoint import (CheckpointManager,
                                                   load_pretrained_backbone,
                                                   read_previous_epoch, snapshot_config)
from xpt_mde_tpu_torch.training.logger import TrainingLogger, print_progress
from xpt_mde_tpu_torch.training.optimizers import optimizer_factory
from xpt_mde_tpu_torch.training.train_step import (decode_image_features, features_to_device,
                                                   make_eval_step, make_predict_step,
                                                   make_train_step)
from xpt_mde_tpu_torch.utils.util_class import DurationTime


def _np(value) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def inspect_model(preds, features, step: int, steps_per_epoch: int) -> bool:
    """Quantiles of the predicted depth and flow, and the pose and the
    stereo pose beside their ground truths, at three steps per epoch.

    :return: True when this step was inspected
    """
    stride = max(steps_per_epoch // 3, 1)
    if step % stride > 0:
        return False
    qs = np.arange(0.1, 1, 0.1)

    def quant(name, val):
        print(name, np.quantile(_np(val), qs))

    print("")
    if "depth_ms" in preds:
        quant("depth0 ", preds["depth_ms"][0])
        quant("depth3 ", preds["depth_ms"][3])
    if "flow_ms" in preds:
        quant("flow0  ", preds["flow_ms"][0])
    if "pose" in preds:
        pose = _np(preds["pose"])
        print("pose_pr", pose[0, 0, :3], pose[0, 1, :3])
    if "pose_gt" in features:
        gt = _np(features["pose_gt"])
        print("pose_gt", gt[0, 0, :3, 3], gt[0, 1, :3, 3])
    if "pose_LR" in preds:
        lr = _np(preds["pose_LR"])
        print("T_LR_pr", lr[0, 0, :3], lr[0, 1, :3])
        gt_lr = _np(features["stereo_T_LR"])
        print("T_LR_gt", gt_lr[0, :3, 3], gt_lr[0, :3, 3])
    return True


def default_dataset_factory(cfg: Config, mesh=None):
    """Shard loaders over ``cfg.datapath_shd/{dataset}_{split}``: the
    native reader behind a prefetch thread, uint8 snippets (the steps
    decode them on the device), shuffled for the train split only. Over a
    mesh, ``batch_size`` is the rank's and each rank reads its data
    index's slice of the shared order (its share of each microbatch): the
    ranks of one spatial group read the same rows."""
    from xpt_mde_tpu_torch.data.native_loader import make_loader

    rank, world = (mesh.data_index, mesh.data) if mesh is not None else (0, 1)

    def factory(dataset_name: str, split: str, batch_size: int):
        return make_loader(Path(cfg.datapath_shd) / f"{dataset_name}_{split}",
                           batch_size, cfg.snippet_len, shuffle=(split == "train"),
                           process_index=rank, process_count=world, raw_images=True,
                           workers=cfg.loader_workers, microbatches=cfg.grad_accum_steps)
    return factory


def loader_keys(loader) -> list:
    if hasattr(loader, "config_keys"):
        return loader.config_keys()
    if hasattr(loader, "ds"):
        return loader.ds.keys()
    raise ValueError("loader must expose config_keys() or .ds.keys()")


def _step_generator(epoch: int, step: int) -> torch.Generator:
    """The step's random stream, a function of (epoch, step) alone."""
    return torch.Generator().manual_seed((epoch << 32) + step)


def _set_loader_epoch(loader, epoch_in_row: int) -> None:
    """Point a shuffling loader (under any prefetch wrappers) at the shuffle
    order of the row's ``epoch_in_row``-th epoch. A row run without
    interruption gets the orders it would count itself; a resumed row gets
    them too, rather than restarting at the first."""
    while hasattr(loader, "loader"):
        loader = loader.loader
    if hasattr(loader, "epoch"):
        loader.epoch = epoch_in_row


class StageRuntime:
    """The loaders, model, loss, optimizer and steps of one plan row."""

    def __init__(self, cfg: Config, stage: TrainStage, dataset_factory,
                 device: torch.device, mesh=None):
        self.cfg = cfg
        self.stage = stage
        self.device = device
        self.mesh = mesh
        # cfg.batch_size is the GLOBAL batch (the loss divides by it); each
        # data index loads its share
        world = mesh.data if mesh is not None else 1
        if cfg.batch_size % world:
            raise ValueError(f"global batch {cfg.batch_size} must divide by the world size "
                             f"{world}")
        rank_batch = cfg.batch_size // world
        self.train_loader = dataset_factory(stage.dataset, "train", rank_batch)
        try:
            self.val_loader = dataset_factory(stage.dataset, "val", rank_batch)
        except FileNotFoundError as exc:
            # only an absent val split is skippable; schema or IO errors surface
            print(f"[StageRuntime] no val split for {stage.dataset}, "
                  f"training without validation: {exc}")
            self.val_loader = None
        keys = loader_keys(self.train_loader)
        self.model = ModelFactory(keys, stage.net_names, cfg.depth_activation,
                                  stereo=cfg.stereo, high_res=cfg.high_res,
                                  upsample_interp=cfg.depth_upsample_interp,
                                  compute_dtype=cfg.compute_dtype, device=device).get_model()
        self.total_loss = loss_factory(keys, stage.loss_weights, stage.scale_weights,
                                       cfg.stereo, batch_size=cfg.batch_size)
        # the flownet is frozen where a row trains depth and flow together
        frozen = ["flownet"] if {"flow", "depth"} <= set(stage.net_names) else []
        reg_net = "flownet" if "flow_reg" in stage.loss_weights else None
        self.optimizer = optimizer_factory(cfg.optimizer, stage.learning_rate, self.model,
                                           frozen_nets=frozen)
        augmenter = augmentation_factory(cfg.augment_probs)
        if mesh is not None:
            self.train_step = make_parallel_train_step(
                self.model, self.total_loss, self.optimizer, mesh, augmenter=augmenter,
                regularize_net=reg_net, frozen_nets=frozen,
                grad_accum_steps=cfg.grad_accum_steps)
        else:
            self.train_step = make_train_step(
                self.model, self.total_loss, self.optimizer, augmenter=augmenter,
                frozen_nets=frozen, regularize_net=reg_net,
                grad_accum_steps=cfg.grad_accum_steps)
        self.eval_step = make_eval_step(self.model, self.total_loss) if mesh is None \
            else make_parallel_eval_step(self.model, self.total_loss, mesh)
        self.predict_step = make_predict_step(self.model)
        # one fixed batch for the per-epoch scale log; reading it consumes no epoch
        self.example = self.to_device(example_batch(self.train_loader))
        self.step = 0  # optimizer steps taken in this row

    def to_device(self, batch: dict) -> dict:
        return features_to_device(batch, self.device)

    def shard(self, batch: dict) -> dict:
        """The rank's features for the steps over the mesh (its band of the
        image rows on a spatial mesh)."""
        return self.to_device(batch) if self.mesh is None else shard_batch(batch, self.mesh)

    def run_train_epoch(self, epoch: int, epoch_in_row: int, log_every: int = 50,
                        start_step: int = 0, metric_sums=None, count: int = 0,
                        save_cb=None) -> dict:
        """One training epoch, resumable mid-epoch: (start_step, metric_sums,
        count) come from a midway checkpoint, and ``save_cb(steps_done,
        metric_sums, count)`` runs every ``cfg.ckpt_every_steps`` steps."""
        loader = self.train_loader
        steps = getattr(loader, "steps_per_epoch", None)
        if steps is None:
            steps = len(loader)
        every = self.cfg.ckpt_every_steps
        _set_loader_epoch(loader, epoch_in_row)
        if hasattr(loader, "iter_from"):
            batches = loader.iter_from(start_step)
        else:
            batches = itertools.islice(iter(loader), start_step, None)
        with DurationTime() as dt:
            for step_idx, batch in enumerate(batches, start=start_step):
                metrics = self.train_step(self.shard(batch), _step_generator(epoch, step_idx))
                self.step += 1
                metric_sums = metrics if metric_sums is None else \
                    {k: metric_sums[k] + v for k, v in metrics.items()}
                count += 1
                if save_cb is not None and every > 0 and (step_idx + 1) % every == 0:
                    save_cb(step_idx + 1, {k: float(v) for k, v in metric_sums.items()},
                            count)
                if step_idx % log_every == 0 and is_main_process():
                    print_progress(f"  train {step_idx}/{steps} "
                                   f"loss={float(metrics['loss']):.4f}")
                if self.cfg.inspect_model and steps and is_main_process():
                    stride = max(steps // 3, 1)
                    if step_idx % stride == 0:
                        features = self.to_device(batch)
                        inspect_model(self.predict_step(features), features, step_idx, steps)
            if count == 0:
                raise ValueError("train loader yielded no batches -- dataset smaller "
                                 f"than the batch size? (steps_per_epoch={steps})")
            means = {k: float(v) / count for k, v in metric_sums.items()}
        print("")
        means["sec_per_epoch"] = dt.duration
        return means

    def run_val_epoch(self) -> dict:
        if self.val_loader is None:
            return {}
        metric_sums, count = None, 0
        for batch in self.val_loader:
            # over a mesh: md2cmb's count over the global batch, the metrics
            # over the ranks
            metrics = self.eval_step(self.shard(batch))
            metric_sums = metrics if metric_sums is None else \
                {k: metric_sums[k] + v for k, v in metrics.items()}
            count += 1
        if count == 0:
            return {}
        return {k: float(v) / count for k, v in metric_sums.items()}


def train_by_plan(cfg: Config, dataset_factory: Optional[Callable] = None,
                  device: torch.device | str = "cuda", mesh=None) -> None:
    """Walk the training plan, skipping the rows already done.

    :param dataset_factory: ``(dataset, split, batch_size) -> loader``
        (``batch_size`` the rank's); the shard loaders of
        ``default_dataset_factory`` by default
    :param device: the card by default; ``"cpu"`` where the caller asks
    :param mesh: the data mesh (``parallel.make_mesh``) to train over, its
        rank's device taking the place of ``device``; None: one process
    """
    device = mesh.device if mesh is not None else torch.device(device)
    dataset_factory = dataset_factory or default_dataset_factory(cfg, mesh)
    ckpt_dir = Path(cfg.datapath_ckp) / cfg.ckpt_name
    if is_main_process():  # one writer per shared file system
        snapshot_config(ckpt_dir, cfg.to_json_dict())
    barrier()
    initial_epoch = read_previous_epoch(ckpt_dir)

    target_epoch = 0
    for stage_idx, stage in enumerate(cfg.training_plan):
        target_epoch += stage.epochs
        if initial_epoch >= target_epoch:
            print(f"[train_by_plan] stage {stage_idx} already done")
            continue
        train_stage(cfg, stage, stage_idx, initial_epoch, target_epoch,
                    dataset_factory, device, mesh)
        initial_epoch = max(initial_epoch, target_epoch)
        # the row's model, optimizer and cached workspaces go before the
        # next row builds its own
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def train_stage(cfg: Config, stage: TrainStage, stage_idx: int, initial_epoch: int,
                target_epoch: int, dataset_factory, device: torch.device,
                mesh=None) -> None:
    print(f"[train_stage] stage {stage_idx}: nets={dict(stage.net_names)} "
          f"dataset={stage.dataset} lr={stage.learning_rate} "
          f"epochs {initial_epoch}..{target_epoch}")
    ckpt_dir = Path(cfg.datapath_ckp) / cfg.ckpt_name
    runtime = StageRuntime(cfg, stage, dataset_factory, device, mesh)
    main = is_main_process()
    model, optimizer = runtime.model, runtime.optimizer
    ckpt = CheckpointManager(ckpt_dir)
    logger = TrainingLogger(ckpt_dir, cfg.log_loss)

    # this row's own full state where it was interrupted, else the weights
    # of the nets it shares with the rows before, with a fresh optimizer
    step = ckpt.restore_full(model, optimizer, stage_idx=stage_idx)
    if step is not None:
        runtime.step = step
    elif not ckpt.restore_params(model) and cfg.pretrained_weight:
        load_pretrained_backbone(model, Path(cfg.datapath) / "pretrained"
                                 / f"{stage.net_names.get('depth', '')}.msgpack")
    # a mid-epoch checkpoint is newer than "latest" by definition
    start_step, mid_sums, mid_count = 0, None, 0
    midway = ckpt.restore_midway(model, optimizer, stage_idx, initial_epoch)
    if midway is not None:
        runtime.step, start_step, mid_sums, mid_count = midway
    if mesh is not None:  # every rank read the same files; rank 0's state wins
        replicate_state(model, optimizer, mesh)

    first_epoch = target_epoch - stage.epochs
    for epoch in range(initial_epoch, target_epoch):
        print(f"========== epoch {epoch} (stage {stage_idx})")
        save_cb = None
        if cfg.ckpt_every_steps > 0 and main:
            def save_cb(steps_done, sums, count, _epoch=epoch):
                ckpt.save_midway(model, optimizer, stage_idx, _epoch, steps_done, sums,
                                 count, runtime.step)
        train_metrics = runtime.run_train_epoch(
            epoch, epoch - first_epoch, start_step=start_step, metric_sums=mid_sums,
            count=mid_count, save_cb=save_cb)
        start_step, mid_sums, mid_count = 0, None, 0  # only the first epoch resumes
        val_metrics = runtime.run_val_epoch()
        print(f"  epoch {epoch}: train_loss={train_metrics.get('loss', 0):.4f}"
              f" val_loss={val_metrics.get('loss', 0):.4f}"
              f" ({train_metrics.get('sec_per_epoch', 0):.1f}s)")
        if main:
            ckpt.save(model, optimizer, "latest", stage_idx=stage_idx, step=runtime.step)
            logger.save_log(epoch, train_metrics, val_metrics)
            ckpt.clear_midway()
            preds = runtime.predict_step(runtime.example)
            logger.save_scales(epoch, preds)
            logger.save_reconstruction_samples(epoch, decode_image_features(runtime.example),
                                               preds)
        barrier()
    if stage.save_ckpt and main:
        ckpt.save(model, optimizer, f"ep{target_epoch:02d}", stage_idx=stage_idx,
                  step=runtime.step)
    barrier()
