"""Train, eval and predict steps (port of ``xpt_mde_tpu.training.train_step``).

The port has no TrainState: the module carries its weights and BatchNorm
statistics and the optimizer its moments, so ``make_*_step`` takes the
module (and the optimizer) and the step takes the features (a dict of
tensors on the module's device). Every step runs in full float32 (TF32
off) and restores the module's mode afterwards. The eval and predict
steps run the module in eval mode (BN running statistics) under
``inference_mode``; the train step runs it in train mode, so BatchNorm
normalizes with the batch statistics and updates its running ones.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping, Sequence

import torch

from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.training import metrics as tm
from xpt_mde_tpu_torch.utils.precision import full_f32

# the loaders' host decode, u * 2/255 - 1
_IMG_DECODE_SCALE = 2.0 / 255.0


def decode_image_features(features: Mapping[str, torch.Tensor]) -> dict:
    """uint8 ``image5d*`` entries -> float32 [-1, 1]; floats pass through."""
    out = dict(features)
    for key, value in features.items():
        if key.startswith("image5d") and value.dtype == torch.uint8:
            out[key] = value.to(torch.float32) * _IMG_DECODE_SCALE - 1.0
    return out


def features_to_device(batch: Mapping, device: torch.device) -> dict:
    """A loader's numpy batch as tensors on ``device``; to a card through
    pinned host memory, without waiting for the copy."""
    if device.type == "cuda":
        return {key: torch.as_tensor(value).pin_memory().to(device, non_blocking=True)
                for key, value in batch.items()}
    return {key: torch.as_tensor(value).to(device) for key, value in batch.items()}


def _compute_metrics(preds, features, loss, loss_by_type) -> dict:
    metrics = {"loss": loss}
    metrics.update({f"loss/{k}": v for k, v in loss_by_type.items()})
    if "depth_ms" in preds and "depth_gt" in features:
        d = spatial.whole(preds["depth_ms"][0], 1)  # a spatial mesh's bands gathered
        metrics["depth_abs_rel"] = torch.mean(tm.depth_abs_rel(d, features["depth_gt"]))
        # centre-region mean depth magnitude
        h, w = d.shape[1:3]
        metrics["depth_center_mean"] = torch.mean(
            d[:, h // 4: h * 3 // 4, w // 4: w * 3 // 4])
    if "pose" in preds and "pose_gt" in features:
        metrics.update(tm.pose_metrics(preds["pose"], features["pose_gt"]))
    return metrics


@contextlib.contextmanager
def _inference(model: torch.nn.Module):
    was_training = model.training
    model.eval()
    try:
        with full_f32(), torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def make_train_step(model: torch.nn.Module, total_loss,
                    optimizer: torch.optim.Optimizer, augmenter=None,
                    frozen_nets: Sequence[str] = (),
                    regularize_net: str | None = None,
                    grad_accum_steps: int = 1,
                    reduce_gradients: Callable[[], None] | None = None) -> Callable:
    """Train step: decode, augment, forward in train mode, ``total_loss``,
    backward, ``optimizer.step()``.

    :param optimizer: from ``training.optimizers.optimizer_factory`` over
        the same model (frozen nets left out of it)
    :param augmenter: optional ``TotalAugment``; its draws come from the
        CPU ``generator`` the step is given
    :param frozen_nets: top-level nets (``depthnet``, ``posenet``,
        ``flownet``) whose parameters get no gradient during the step, as
        JAX's ``stop_gradient`` prunes them; their BN running statistics
        still update
    :param regularize_net: the top-level net whose parameters the
        ``flow_reg`` loss reads, as ``preds["regularize_weights"]``; it is
        never frozen. A name the model lacks adds nothing, as in JAX
    :param grad_accum_steps: k > 1 augments the batch once, then runs it
        as k sequential microbatches of batch/k (forward, loss, backward
        each, the gradients summed in the parameters' ``.grad``) before
        ONE optimizer step, as the JAX step's ``lax.scan`` does. Every
        loss term is a sum over samples divided by the GLOBAL batch, so
        ``total_loss`` must carry ``batch_size`` (the whole batch), and
        the summed gradients are the whole batch's up to float summation
        order. The JAX step's two deviations hold here too: BatchNorm
        normalizes each microbatch by its own statistics (and folds k
        batches of batch/k into its running ones), and the md2cmb terms
        count valid pixels per microbatch. The metrics: the loss terms
        summed over the microbatches, the others averaged
    :param reduce_gradients: called once after the backward (of every
        microbatch) and before the optimizer step: the data-parallel step's
        cross-rank gradient sum (``parallel.sharding``)
    :return: ``step(features, generator=None) -> metrics``, the metrics of
        the train-mode forward (detached), as the JAX step reports them
    """
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if grad_accum_steps > 1 and getattr(total_loss, "batch_size", None) is None:
        # each microbatch's loss would be its sum / (batch/k): k x too large
        raise ValueError("grad_accum_steps > 1 requires total_loss built "
                         "with batch_size = the GLOBAL batch size")
    frozen = set(frozen_nets) - {regularize_net}
    frozen_params = [p for name, net in model.named_children() if name in frozen
                     for p in net.parameters()]
    regularized = getattr(model, regularize_net, None) if regularize_net else None

    def forward_backward(features) -> dict:
        """Loss and metrics of one (micro)batch; its gradients are added
        into ``.grad``."""
        preds = model(features)
        if regularized is not None:
            preds["regularize_weights"] = list(regularized.parameters())
        loss, loss_by_type = total_loss(preds, features)
        loss.backward()
        with torch.no_grad():
            return _compute_metrics(preds, features, loss.detach(),
                                    {k: v.detach() for k, v in loss_by_type.items()})

    def train_step(features: Mapping[str, torch.Tensor],
                   generator: torch.Generator | None = None) -> dict:
        was_training = model.training
        grad_flags = [p.requires_grad for p in frozen_params]
        model.train()
        for p in frozen_params:
            p.requires_grad_(False)
        try:
            with full_f32():
                features = decode_image_features(features)
                if augmenter is not None:
                    with spatial.suspended():  # on a spatial mesh, the whole frames
                        features = augmenter(features, generator)
                optimizer.zero_grad(set_to_none=True)
                if grad_accum_steps == 1:
                    metrics = forward_backward(features)
                else:
                    metrics = _accumulate(forward_backward, features, grad_accum_steps)
                if reduce_gradients is not None:
                    reduce_gradients()
                optimizer.step()
                return metrics
        finally:
            for p, flag in zip(frozen_params, grad_flags):
                p.requires_grad_(flag)
            model.train(was_training)

    return train_step


def _accumulate(forward_backward: Callable, features: Mapping[str, torch.Tensor],
                k: int) -> dict:
    """``forward_backward`` over the k microbatches of ``features`` (every
    entry split along its batch axis, in order); the loss terms' metrics
    summed (each is already a sum / the global batch), the others
    averaged over the microbatches of equal size."""
    batch = next(iter(features.values())).shape[0]
    if batch % k:
        raise ValueError(f"batch {batch} must divide by grad_accum_steps {k}")
    size = batch // k
    runs = [forward_backward({key: value[i * size: (i + 1) * size]
                              for key, value in features.items()})
            for i in range(k)]
    return {key: (torch.sum if key == "loss" or key.startswith("loss/") else torch.mean)(
                torch.stack([run[key] for run in runs]))
            for key in runs[0]}


def make_eval_step(model: torch.nn.Module, total_loss) -> Callable:
    """Validation step: forward + loss + metrics, no update."""

    def eval_step(features: Mapping[str, torch.Tensor]) -> dict:
        with _inference(model):
            features = decode_image_features(features)
            preds = model(features)
            loss, loss_by_type = total_loss(preds, features)
            return _compute_metrics(preds, features, loss, loss_by_type)

    return eval_step


def make_predict_step(model: torch.nn.Module) -> Callable:
    """Inference step returning the full prediction dict."""

    def predict_step(features: Mapping[str, torch.Tensor]) -> dict:
        with _inference(model):
            return model(decode_image_features(features))

    return predict_step
