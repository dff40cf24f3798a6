"""Model factory + composite model (port of ``xpt_mde_tpu.models.factory``).

``VodeModel(features)`` runs each sub-net on ``image5d`` and merges their
prediction dicts, deriving ``disp_ms = 1 / depth_ms``. Ported so far: the
monocular nets an EfficientNet ``DepthNetPretrained``, ``PoseNetImproved``
and ``PWCNet``, in float32. Any other net, stereo and bfloat16 raise,
naming the ROADMAP item that adds them.

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
from xpt_mde_tpu_torch.models.backbones import backbone_factory
from xpt_mde_tpu_torch.models.backbones.efficientnet import EfficientNet
from xpt_mde_tpu_torch.models.flow_net import PWCNet
from xpt_mde_tpu_torch.models.layers import Conv2dSame, ConvTranspose, activation_factory
from xpt_mde_tpu_torch.utils.image import safe_reciprocal_ms


class VodeModel(nn.Module):
    """Composite {depthnet, posenet, flownet} model (monocular)."""

    def __init__(self, depthnet: nn.Module | None = None,
                 posenet: nn.Module | None = None,
                 flownet: nn.Module | None = None):
        super().__init__()
        self.depthnet = depthnet
        self.posenet = posenet
        self.flownet = flownet

    def forward(self, features: Mapping[str, torch.Tensor]) -> dict:
        return self.predict_batch(features, "")

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
                 device: torch.device | str = "cuda", seed: int = 0):
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r} is not ported yet: float32 only "
                "until the ROADMAP's 'bf16' item lands")
        self.dataset_keys = {k.replace("image5d", "image") for k in dataset_keys}
        self.net_names = dict(net_names)
        self.depth_activation = depth_activation
        self.stereo = stereo
        self.high_res = high_res
        self.upsample_interp = upsample_interp
        self.device = torch.device(device)
        self.seed = seed

    def get_model(self) -> VodeModel:
        unported = set(self.net_names) - {"depth", "camera", "flow"}
        if unported:
            raise NotImplementedError(f"nets {sorted(unported)} are not ported yet")
        if "stereo_T_LR" in self.dataset_keys or (
                "image_R" in self.dataset_keys and self.stereo):
            raise NotImplementedError(
                "the stereo VodeModel is not ported yet (ROADMAP: 'Stereo slice')")
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
            model = VodeModel(depthnet, posenet, flownet)
        model.to_empty(device="cpu")
        init_weights(model, torch.Generator().manual_seed(self.seed))
        return model.to(self.device)

    def depth_net_factory(self, net_name: str) -> nn.Module:
        activation = activation_factory(self.depth_activation)
        return dn.DepthNetPretrained(backbone_factory(net_name), activation,
                                     self.upsample_interp)

    def pose_net_factory(self, net_name: str) -> nn.Module:
        if net_name == "PoseNetImproved":
            return pn.PoseNetImproved(SNIPPET_LEN, self.high_res)
        raise NotImplementedError(
            f"pose net {net_name!r} is not ported yet (ROADMAP: 'Breadth')")

    def flow_net_factory(self, net_name: str) -> nn.Module:
        if net_name == "PWCNet":
            return PWCNet()
        raise ValueError(f"wrong flow net name: {net_name}")
