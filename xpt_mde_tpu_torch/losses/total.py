"""Loss orchestration for the rigid, flow, joint and stereo recipes (port of
``xpt_mde_tpu.losses.total``).

Contracts kept:
- every loss maps (features, predictions, augm_data) -> [batch];
- multi-scale losses combine per-scale batch losses by a scale-weight
  vector;
- ``TotalLoss`` builds the shared data (source/target split, target
  pyramids, synthesized and flow-warped views, and with stereo data the
  same for the right views plus the left<->right cross-synthesis) once,
  then sums each loss over the GLOBAL batch, divides by it and weights it
  by the recipe;
- the factory drops losses whose required features the dataset lacks.

The pool is the JAX package's: ``L1``, ``SSIM``, ``md2L1``, ``md2SSIM``,
``cmbL1``, ``cmbSSIM``, ``md2cmbL1``, ``md2cmbSSIM``, ``moaL1``,
``moaSSIM``, ``smoothe``, ``flowL2`` and their ``_R`` twins, ``flow_reg``,
``stereoL1``, ``stereoSSIM`` and ``stereoPose``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import torch
import torch.distributed as dist

from xpt_mde_tpu_torch.losses.photometric import PHOTOMETRIC_FNS
from xpt_mde_tpu_torch.ops.flow_warp import flow_warp_multi_scale
from xpt_mde_tpu_torch.ops.synthesize import synthesize_multi_scale
from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.parallel.multihost import step_group
from xpt_mde_tpu_torch.utils import se3
from xpt_mde_tpu_torch.utils.image import multi_scale_like, resize_image

LossFn = Callable[[Mapping[str, Any], Mapping[str, Any], Mapping[str, Any]],
                  torch.Tensor]


def _merge_multi_scale(losses: Sequence[torch.Tensor],
                       scale_weights: Sequence[float]) -> torch.Tensor:
    """[scales][batch] -> [batch] via scale-weighted sum."""
    stacked = torch.stack(list(losses), dim=0)
    weights = torch.as_tensor(scale_weights, dtype=stacked.dtype,
                              device=stacked.device)
    return torch.tensordot(weights, stacked, dims=1)


def _full_resolution(photo, views: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The per-pixel error ([B, N, H, W, C]) of ``views`` resized
    bilinearly to the target's size against the target. On a spatial
    mesh's band, the views' band of the full-resolution rows against the
    same rows of the whole target."""
    resized = resize_image(views, *target.shape[1:3])
    return photo(resized, spatial.like(target, resized, -3), reduce=False)


class PhotometricLossMultiScale:
    """Per-scale photometric loss against the scaled target."""

    def __init__(self, method: str, scale_weights, key_suffix: str = ""):
        self.photo = PHOTOMETRIC_FNS[method]
        self.scale_weights = tuple(float(w) for w in scale_weights)
        self.sfx = key_suffix

    def __call__(self, features, predictions, augm_data):
        target_ms = augm_data["target_ms" + self.sfx]
        synth_ms = augm_data["synth_target_ms" + self.sfx]
        losses = [self.photo(s, t) for s, t in zip(synth_ms, target_ms)]
        return _merge_multi_scale(losses, self.scale_weights)


class MonoDepth2LossMultiScale:
    """Monodepth2's per-pixel minimum over the sources: each scale's
    synthesized views resized bilinearly to the target's size, the
    photometric error's minimum over the sources, averaged (on a spatial
    mesh's band, its share of the sample's mean)."""

    def __init__(self, method: str, scale_weights, key_suffix: str = ""):
        self.photo = PHOTOMETRIC_FNS[method]
        self.scale_weights = tuple(float(w) for w in scale_weights)
        self.sfx = key_suffix

    def __call__(self, features, predictions, augm_data):
        synth_ms = augm_data["synth_target_ms" + self.sfx]
        target = augm_data["target" + self.sfx]
        losses = []
        for synth in synth_ms:
            err = _full_resolution(self.photo, synth, target)
            # amin splits the gradient among ties, as jnp.min's does
            losses.append(spatial.band_mean(torch.amin(err, dim=1), (1, 2, 3), 1))
        return _merge_multi_scale(losses, self.scale_weights)


class CombinedLossMultiScale:
    """The static (view-synthesis) loss at full resolution, masked where
    it is not below the optical-flow loss: each scale's synthesized views
    and the finest flow-warped views are resized bilinearly to the
    target's size, and a pixel counts only where its static error is
    smaller than its flow error (per pixel, so on a spatial mesh's band
    with no collective but the resizes' gathers)."""

    def __init__(self, method: str, scale_weights, key_suffix: str = ""):
        self.photo = PHOTOMETRIC_FNS[method]
        self.scale_weights = tuple(float(w) for w in scale_weights)
        self.sfx = key_suffix

    def __call__(self, features, predictions, augm_data):
        synth_ms = augm_data["synth_target_ms" + self.sfx]
        warped_ms = augm_data["warped_target_ms" + self.sfx]
        target = augm_data["target" + self.sfx]
        flow_loss = _full_resolution(self.photo, warped_ms[0], target)
        losses = []
        for synth in synth_ms:
            static = _full_resolution(self.photo, synth, target)
            static = static * (static < flow_loss).to(static.dtype)
            losses.append(spatial.band_mean(static, (1, 2, 3, 4), 2))
        return _merge_multi_scale(losses, self.scale_weights)


class MoALossMultiScale:
    """Per pixel, the minimum of the errors of the temporal synthesized
    views and the stereo cross-synthesized view, all resized to the
    target's size."""

    def __init__(self, method: str, scale_weights, key_suffix: str = ""):
        self.photo = PHOTOMETRIC_FNS[method]
        self.scale_weights = tuple(float(w) for w in scale_weights)
        self.sfx = key_suffix

    def __call__(self, features, predictions, augm_data):
        temp_ms = augm_data["synth_target_ms" + self.sfx]
        stro_ms = augm_data["stereo_synth_ms" + self.sfx]
        target = augm_data["target" + self.sfx]
        ho, wo = target.shape[1:3]
        losses = []
        for temp, stro in zip(temp_ms, stro_ms):
            temp_loss = self.photo(resize_image(temp, ho, wo), target, reduce=False)
            stro_loss = self.photo(resize_image(stro, ho, wo), target, reduce=False)
            moa = torch.amin(torch.cat([temp_loss, stro_loss], dim=1), dim=1)
            losses.append(torch.mean(moa, dim=(1, 2, 3)))
        return _merge_multi_scale(losses, self.scale_weights)


def _global_sum(value: torch.Tensor) -> torch.Tensor:
    """``value`` (no gradient) summed over the ranks of the enclosing
    data-parallel step (``parallel.multihost.reducing_over``); itself
    outside one."""
    group = step_group()
    if group is None:
        return value
    value = value.clone()
    dist.all_reduce(value, group=group)
    return value


class MD2CombLossMultiScale:
    """The minimum over the sources with the flow's outliers excluded: a
    source's pixel whose static error exceeds twice the flow-warped
    view's error gets 1000 added; pixels whose minimum stays at or above
    1000 are dropped. Each sample's sum is divided by the valid pixels of
    the WHOLE batch (the reference's ``count_nonzero``, kept as is): in a
    data-parallel step, of the global batch, summed over the ranks; on a
    spatial mesh each rank sums and counts its band's pixels, and the count
    runs over the whole mesh (a map that every rank of a spatial group
    holds whole, each of them counts in its sums and its count alike, so
    each rank's term is its share of the sample's)."""

    def __init__(self, method: str, scale_weights, key_suffix: str = ""):
        self.photo = PHOTOMETRIC_FNS[method]
        self.scale_weights = tuple(float(w) for w in scale_weights)
        self.sfx = key_suffix

    def __call__(self, features, predictions, augm_data):
        synth_ms = augm_data["synth_target_ms" + self.sfx]
        warped_ms = augm_data["warped_target_ms" + self.sfx]
        target = augm_data["target" + self.sfx]
        flow_loss = _full_resolution(self.photo, warped_ms[0], target)
        losses = []
        for synth in synth_ms:
            static = _full_resolution(self.photo, synth, target)
            outlier = (static > flow_loss * 2.0).to(static.dtype)
            static = torch.amin(static + outlier * 1000.0, dim=1)  # [B, H, W, C]
            keep = (static < 1000.0).to(static.dtype)
            count = torch.clamp(_global_sum(torch.sum(keep)), min=1.0)
            losses.append(torch.sum(static * keep, dim=(1, 2, 3)) / count)
        return _merge_multi_scale(losses, self.scale_weights)


class SmoothenessLossMultiScale:
    """Edge-aware disparity smoothness (NHWC, like the reference)."""

    def __init__(self, scale_weights, key_suffix: str = "",
                 image_gradient_factor: float = 4.0):
        self.scale_weights = tuple(float(w) for w in scale_weights)
        self.sfx = key_suffix
        self.grad_factor = image_gradient_factor

    def __call__(self, features, predictions, augm_data):
        disp_ms = predictions["disp_ms" + self.sfx]
        target_ms = augm_data["target_ms" + self.sfx]
        orig_width = target_ms[0].shape[2]
        losses = []
        for disp, image in zip(disp_ms, target_ms):
            scale = orig_width / image.shape[2]
            losses.append(self.smootheness_loss(disp, image) / scale)
        return _merge_multi_scale(losses, self.scale_weights)

    def smootheness_loss(self, disp, image):
        """On a spatial mesh's band, ``grad_y`` takes the next band's first
        row, and each mean is the band's share of the sample's."""
        def grad_x(img):
            return img[:, :, :-1] - img[:, :, 1:]

        def grad_y(img):
            if spatial.current() is not None:
                return spatial.diff_rows(img, 1)[0]
            return img[:, :-1] - img[:, 1:]

        disp_gx, disp_gy = grad_x(disp), grad_y(disp)
        img_gx, img_gy = grad_x(image), grad_y(image)
        wx = torch.exp(-torch.mean(torch.abs(img_gx * self.grad_factor), 3,
                                   keepdim=True))
        wy = torch.exp(-torch.mean(torch.abs(img_gy * self.grad_factor), 3,
                                   keepdim=True))
        rows = spatial.global_rows(disp, 1)
        sx = 0.5 * spatial.band_mean(torch.abs(disp_gx * wx), (1, 2, 3), 1, of=disp)
        sy = 0.5 * spatial.band_mean(torch.abs(disp_gy * wy), (1, 2, 3), 1, of=disp,
                                     rows=rows - 1)
        return sx + sy


class StereoDepthLoss:
    """Photometric loss of the left<->right cross-synthesized views against
    their targets, the left and right sides summed per scale."""

    def __init__(self, method: str, scale_weights):
        self.photo = PHOTOMETRIC_FNS[method]
        self.scale_weights = tuple(float(w) for w in scale_weights)

    def __call__(self, features, predictions, augm_data):
        sides = [[self.photo(s, t) for s, t in zip(augm_data["stereo_synth_ms" + sfx],
                                                   augm_data["target_ms" + sfx])]
                 for sfx in ("", "_R")]
        return _merge_multi_scale([l + r for l, r in zip(*sides)], self.scale_weights)


class StereoPoseLoss:
    """Mean squared error of the predicted stereo twists against the
    extrinsic's, both directions: ``pose_LR`` against T_LR and
    ``pose_RL`` against its inverse."""

    def __call__(self, features, predictions, augm_data):
        t_lr = features["stereo_T_LR"][:, None]  # [B, 1, 4, 4]
        pose_lr_true = se3.matrix_to_twist(t_lr)
        pose_rl_true = se3.matrix_to_twist(se3.invert_matrix(t_lr))
        loss = (torch.mean((pose_lr_true - predictions["pose_LR"]) ** 2, dim=-1)
                + torch.mean((pose_rl_true - predictions["pose_RL"]) ** 2, dim=-1))
        return torch.mean(loss, dim=1)


class FlowWarpLossMultiScale:
    """Photometric loss of the flow-warped sources against the scaled
    target."""

    def __init__(self, method: str, scale_weights, key_suffix: str = ""):
        self.photo = PHOTOMETRIC_FNS[method]
        self.scale_weights = tuple(float(w) for w in scale_weights)
        self.sfx = key_suffix

    def __call__(self, features, predictions, augm_data):
        flow_target_ms = augm_data["flow_target_ms" + self.sfx]
        warped_ms = augm_data["warped_target_ms" + self.sfx]
        losses = [self.photo(w, t) for w, t in zip(warped_ms, flow_target_ms)]
        return _merge_multi_scale(losses, self.scale_weights)


class L2Regularizer:
    """0.5 * sum(w^2) over the tensors in ``predictions["regularize_weights"]``
    (the train step puts a net's parameters there, kernels and biases),
    the same value for every sample; zeros without it. On a spatial mesh
    every rank of a group holds the weights whole, so the group's first
    rank alone counts it (``spatial.first_rank_share``), as ``band_mean``
    counts a whole map: the step sums the gradients over the mesh."""

    def __call__(self, features, predictions, augm_data):
        weights = predictions.get("regularize_weights")
        image5d = features["image5d"]
        if weights is None:
            return torch.zeros(image5d.shape[0], dtype=image5d.dtype, device=image5d.device)
        loss = sum(0.5 * torch.sum(torch.square(w)) for w in weights)
        return spatial.first_rank_share(loss).expand(image5d.shape[0])


class TotalLoss:
    """Weighted sum of registered losses over shared augmented data."""

    def __init__(self, loss_objects: Mapping[str, LossFn],
                 loss_weights: Mapping[str, float], stereo: bool = False,
                 batch_size: int | None = None):
        self.loss_objects = dict(loss_objects)
        self.loss_weights = dict(loss_weights)
        self.stereo = stereo
        self.batch_size = batch_size

    def __call__(self, predictions, features):
        """:return: (total loss scalar, dict of per-loss scalars)"""
        augm_data = self.append_data(features, predictions)
        if self.stereo and "image5d_R" in features:
            augm_data.update(self.append_data(features, predictions, "_R"))
            augm_data.update(self.synthesize_stereo(features, predictions, augm_data))
        global_batch = self.batch_size or features["image5d"].shape[0]
        total = 0.0
        loss_by_type = {}
        for name, loss_obj in self.loss_objects.items():
            loss_mean = torch.sum(loss_obj(features, predictions, augm_data)) \
                / global_batch
            total = total + loss_mean * self.loss_weights[name]
            loss_by_type[name] = loss_mean
        return total, loss_by_type

    def append_data(self, features, predictions, suffix: str = ""):
        """Source/target split, target pyramid and synthesized views."""
        image5d = features["image5d" + suffix]
        source = image5d[:, :-1]
        target = image5d[:, -1]
        augm = {"source" + suffix: source, "target" + suffix: target}
        if ("depth_ms" + suffix in predictions) and ("pose" + suffix in predictions):
            depth_ms = predictions["depth_ms" + suffix]
            augm["target_ms" + suffix] = multi_scale_like(target, depth_ms)
            augm["synth_target_ms" + suffix] = synthesize_multi_scale(
                source, features["intrinsic" + suffix], depth_ms,
                predictions["pose" + suffix])
        if "flow_ms" + suffix in predictions:
            flow_ms = predictions["flow_ms" + suffix]
            augm["flow_target_ms" + suffix] = multi_scale_like(target, flow_ms)
            augm["warped_target_ms" + suffix] = flow_warp_multi_scale(source, flow_ms)
        return augm

    def synthesize_stereo(self, features, predictions, augm_data):
        """The left target synthesized from the right one (through
        inv(T_LR) and the left depth) and the right from the left (T_LR,
        the right depth), each a single-source synthesis at every scale.
        Both directions use the LEFT intrinsic, as the JAX package does."""
        if "stereo_T_LR" not in features or "depth_ms" not in predictions:
            return {}
        t_lr = features["stereo_T_LR"]  # [B, 4, 4]
        intrinsic = features["intrinsic"]
        return {
            "stereo_synth_ms": synthesize_multi_scale(
                augm_data["target_R"][:, None], intrinsic, predictions["depth_ms"],
                se3.invert_matrix(t_lr)[:, None]),
            "stereo_synth_ms_R": synthesize_multi_scale(
                augm_data["target"][:, None], intrinsic, predictions["depth_ms_R"],
                t_lr[:, None])}


# ---------------------------------------------------------------------------
# registry / factory

LOSS_DEPENDENCIES = [
    (["L1", "SSIM", "md2L1", "md2SSIM", "cmbL1", "cmbSSIM", "md2cmbL1",
      "md2cmbSSIM", "moaL1", "moaSSIM", "smoothe", "flowL2", "flow_reg"],
     ["image", "intrinsic"]),
    (["L1_R", "SSIM_R", "md2L1_R", "md2SSIM_R", "cmbL1_R", "cmbSSIM_R",
      "md2cmbL1_R", "md2cmbSSIM_R", "moaL1_R", "moaSSIM_R", "smoothe_R",
      "flowL2_R"],
     ["image_R", "intrinsic_R"]),
    (["stereoL1", "stereoSSIM", "stereoPose",
      "moaL1", "moaSSIM", "moaL1_R", "moaSSIM_R"],
     ["image", "intrinsic", "image_R", "intrinsic_R", "stereo_T_LR"]),
]


def check_loss_dependency(loss_key: str, dataset_keys) -> bool:
    """True if every feature ``loss_key`` needs is in the dataset."""
    dataset_keys = {k.replace("image5d", "image") for k in dataset_keys}
    for loss_names, data_names in LOSS_DEPENDENCIES:
        if loss_key in loss_names:
            for dep in data_names:
                if dep not in dataset_keys:
                    print(f"[check_loss_dependency] drop {loss_key}: "
                          f"{dep} not in dataset")
                    return False
    return True


def loss_factory(dataset_keys, loss_weights: Mapping[str, float],
                 scale_weights, stereo: bool = True,
                 batch_size: int | None = None,
                 image_gradient_factor: float = 4.0) -> TotalLoss:
    """Build a TotalLoss from a recipe dict.

    Losses with weight 0 or missing features are dropped, as in the JAX
    factory.
    """
    pool: dict[str, LossFn] = {}
    for sfx in ("", "_R"):
        pool["L1" + sfx] = PhotometricLossMultiScale("L1", scale_weights, sfx)
        pool["SSIM" + sfx] = PhotometricLossMultiScale("SSIM", scale_weights, sfx)
        pool["md2L1" + sfx] = MonoDepth2LossMultiScale("L1", scale_weights, sfx)
        pool["md2SSIM" + sfx] = MonoDepth2LossMultiScale("SSIM", scale_weights, sfx)
        pool["cmbL1" + sfx] = CombinedLossMultiScale("L1", scale_weights, sfx)
        pool["cmbSSIM" + sfx] = CombinedLossMultiScale("SSIM", scale_weights, sfx)
        # the reference defines this one but never registers it; the JAX
        # package does, and so does the port
        pool["md2cmbL1" + sfx] = MD2CombLossMultiScale("L1", scale_weights, sfx)
        pool["md2cmbSSIM" + sfx] = MD2CombLossMultiScale("SSIM", scale_weights, sfx)
        pool["moaL1" + sfx] = MoALossMultiScale("L1", scale_weights, sfx)
        pool["moaSSIM" + sfx] = MoALossMultiScale("SSIM", scale_weights, sfx)
        pool["smoothe" + sfx] = SmoothenessLossMultiScale(scale_weights, sfx,
                                                          image_gradient_factor)
        pool["flowL2" + sfx] = FlowWarpLossMultiScale("L2", scale_weights, sfx)
    pool["stereoL1"] = StereoDepthLoss("L1", scale_weights)
    pool["stereoSSIM"] = StereoDepthLoss("SSIM", scale_weights)
    pool["stereoPose"] = StereoPoseLoss()
    pool["flow_reg"] = L2Regularizer()
    losses, weights = {}, {}
    for name, weight in loss_weights.items():
        if weight == 0.0 or not check_loss_dependency(name, dataset_keys):
            continue
        losses[name] = pool[name]
        weights[name] = weight
    return TotalLoss(losses, weights, stereo, batch_size)
