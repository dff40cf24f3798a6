"""Model factory + composite model (port of ``xpt_mde_tpu.models.factory``).

``VodeModel(features)`` runs each sub-net on ``image5d`` and merges their
prediction dicts, deriving ``disp_ms = 1 / depth_ms``; with stereo data it
runs them again on the ``_R`` views, and with a stereo extrinsic and a
posenet it predicts the left<->right pose by feeding
``[R_target] * numsrc + [L_target]`` snippets (and their mirror) to the
posenet. The nets are the JAX factory's: ``DepthNetBasic``,
``DepthNetNoResize`` and ``DepthNetPretrained`` over any backbone of
``backbones.BACKBONE_NAMES``; ``PoseNetBasic``, ``PoseNetImproved``,
``PoseNetDeep`` and ``PoseNetPreTrained`` over any backbone that takes the
snippet's 15 channels (ResNet50V2, MobileNetV2, Xception, NASNet: the
others raise ValueError, as their JAX twins cannot run); ``PWCNet``. They
compute in float32 or bfloat16 (``compute_dtype``; the parameters are
float32 either way); an unknown name raises ValueError.

``remat_backbone`` checkpoints the depth net's backbone
(``torch.utils.checkpoint``, non-reentrant), as the JAX factory's
``nn.remat``: its activations are recomputed in the backward instead of
kept, and the recompute folds nothing into the BatchNorm running
statistics (``DepthNetPretrained``).

Weights are drawn from an explicit ``torch.Generator`` on the CPU (the
modules are built on the ``meta`` device first, so nothing is drawn
twice), then moved to ``device``: one seed gives the same weights on
every device. ``device`` defaults to the card; without one, building
raises unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

from xpt_mde_tpu_torch.config import SNIPPET_LEN
from xpt_mde_tpu_torch.models import depth_net as dn
from xpt_mde_tpu_torch.models import pose_net as pn
from xpt_mde_tpu_torch.models.backbones import BACKBONE_NAMES, backbone_factory
from xpt_mde_tpu_torch.models.backbones.efficientnet import EfficientNet
from xpt_mde_tpu_torch.models.flow_net import PWCNet
from xpt_mde_tpu_torch.models.layers import Conv2dSame, ConvTranspose, activation_factory
from xpt_mde_tpu_torch.utils import precision
from xpt_mde_tpu_torch.utils.image import safe_reciprocal_ms


class VodeModel(nn.Module):
    """Composite {depthnet, posenet, flownet} model with stereo handling.

    The nets run in a fixed order: depth, pose and flow on the left views,
    then on the right, then the posenet on the L->R and the R->L
    snippets. In train mode each call folds its batch statistics into the
    BatchNorm running ones in turn, as flax's mutable ``batch_stats`` do,
    so the order is part of the result."""

    def __init__(self, depthnet: nn.Module | None = None,
                 posenet: nn.Module | None = None,
                 flownet: nn.Module | None = None,
                 stereo: bool = False, stereo_pose: bool = False):
        super().__init__()
        self.depthnet = depthnet
        self.posenet = posenet
        self.flownet = flownet
        self.stereo = stereo
        self.stereo_pose = stereo_pose

    def forward(self, features: Mapping[str, torch.Tensor]) -> dict:
        preds = self.predict_batch(features, "")
        if self.stereo and "image5d_R" in features:
            preds.update(self.predict_batch(features, "_R"))
            if self.stereo_pose and self.posenet is not None:
                preds.update(self.predict_stereo_pose(features))
        return preds

    def predict_batch(self, features, suffix: str) -> dict:
        image5d = features["image5d" + suffix]
        preds = {}
        if self.depthnet is not None:
            preds.update(self.depthnet(image5d))
        if self.posenet is not None:
            preds.update(self.posenet(image5d))
        if self.flownet is not None:
            preds.update(self.flownet(image5d))
        if "depth_ms" in preds:
            preds["disp_ms"] = safe_reciprocal_ms(preds["depth_ms"])
        return {key + suffix: value for key, value in preds.items()}

    def predict_stereo_pose(self, features) -> dict:
        """``pose_LR`` / ``pose_RL`` [B, numsrc, 6]: the posenet on the
        right target repeated as the sources of the left target, and the
        mirror."""
        left_target = features["image5d"][:, -1]
        right_target = features["image5d_R"][:, -1]
        numsrc = features["image5d"].shape[1] - 1
        lr_input = torch.stack([right_target] * numsrc + [left_target], dim=1)
        rl_input = torch.stack([left_target] * numsrc + [right_target], dim=1)
        pose_lr = self.posenet(lr_input)["pose"]
        pose_rl = self.posenet(rl_input)["pose"]
        return {"pose_LR": pose_lr, "pose_RL": pose_rl}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight from ``generator`` (flax's inits: truncated
    normal or lecun normal convs, zero biases, identity BatchNorm and
    input normalization)."""
    for module in model.modules():
        if isinstance(module, (Conv2dSame, ConvTranspose)):
            module.init_weights(generator)
        elif isinstance(module, nn.BatchNorm2d):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
            module.reset_running_stats()
        elif isinstance(module, EfficientNet):
            module.input_mean.zero_()
            module.input_var.fill_(1.0)


class ModelFactory:
    """Builds a VodeModel per net-name dict."""

    def __init__(self, dataset_keys, net_names: Mapping[str, str],
                 depth_activation: str = "InverseSigmoid",
                 stereo: bool = True, high_res: bool = False,
                 upsample_interp: str = "nearest",
                 compute_dtype: str = "float32",
                 device: torch.device | str = "cuda", seed: int = 0,
                 remat_backbone: bool = False):
        self.dtype = precision.compute_dtype(compute_dtype)
        self.dataset_keys = {k.replace("image5d", "image") for k in dataset_keys}
        self.net_names = dict(net_names)
        self.depth_activation = depth_activation
        self.stereo = stereo
        self.high_res = high_res
        self.upsample_interp = upsample_interp
        self.device = torch.device(device)
        self.seed = seed
        self.remat_backbone = remat_backbone

    def get_model(self) -> VodeModel:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the model is built on the card "
                               "unless the caller passes device='cpu'")
        with torch.device("meta"):
            depthnet = posenet = flownet = None
            if "depth" in self.net_names:
                depthnet = self.depth_net_factory(self.net_names["depth"])
            if "camera" in self.net_names:
                posenet = self.pose_net_factory(self.net_names["camera"])
            if "flow" in self.net_names:
                flownet = self.flow_net_factory(self.net_names["flow"])
            # the wrapper choice of the JAX factory: stereo pose wherever
            # the data carry the extrinsic and a depth net is built
            stereo_pose = "stereo_T_LR" in self.dataset_keys and depthnet is not None
            stereo = stereo_pose or ("image_R" in self.dataset_keys and self.stereo)
            model = VodeModel(depthnet, posenet, flownet, stereo, stereo_pose)
        model.to_empty(device="cpu")
        init_weights(model, torch.Generator().manual_seed(self.seed))
        return model.to(self.device)

    def depth_net_factory(self, net_name: str) -> nn.Module:
        activation = activation_factory(self.depth_activation)
        if net_name == "DepthNetBasic":
            return dn.DepthNetBasic(activation, self.upsample_interp, self.dtype)
        if net_name == "DepthNetNoResize":
            return dn.DepthNetNoResize(activation, self.upsample_interp, self.dtype)
        if net_name in BACKBONE_NAMES:
            return dn.DepthNetPretrained(backbone_factory(net_name, self.dtype), activation,
                                         self.upsample_interp, self.dtype,
                                         remat_backbone=self.remat_backbone)
        raise ValueError(f"wrong depth net name: {net_name}")

    def pose_net_factory(self, net_name: str) -> nn.Module:
        if net_name == "PoseNetBasic":
            return pn.PoseNetBasic(SNIPPET_LEN, self.high_res, self.dtype)
        if net_name == "PoseNetImproved":
            return pn.PoseNetImproved(SNIPPET_LEN, self.high_res, self.dtype)
        if net_name == "PoseNetDeep":
            return pn.PoseNetDeep(SNIPPET_LEN, self.high_res, self.dtype)
        if net_name in BACKBONE_NAMES:
            backbone = backbone_factory(net_name, self.dtype, in_channels=SNIPPET_LEN * 3)
            return pn.PoseNetPreTrained(backbone, SNIPPET_LEN, self.high_res, self.dtype)
        raise ValueError(f"wrong pose net name: {net_name}")

    def flow_net_factory(self, net_name: str) -> nn.Module:
        if net_name == "PWCNet":
            return PWCNet(self.dtype)
        raise ValueError(f"wrong flow net name: {net_name}")
