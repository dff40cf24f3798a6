"""Multi-scale backbones (strides 2, 4, 8, 16, 32), every net of the JAX
package's zoo: EfficientNet B0-B7, ResNet50V2, MobileNetV2, VGG16,
DenseNet121, Xception, NASNetMobile and NASNetLarge. Each takes
[B, C, H, W] and returns 5 NCHW maps, and carries ``out_channels``."""

import torch

from xpt_mde_tpu_torch.models.backbones.densenet import DenseNet121
from xpt_mde_tpu_torch.models.backbones.efficientnet import EfficientNet
from xpt_mde_tpu_torch.models.backbones.mobilenet import MobileNetV2
from xpt_mde_tpu_torch.models.backbones.nasnet import NASNet
from xpt_mde_tpu_torch.models.backbones.resnet import ResNet50V2
from xpt_mde_tpu_torch.models.backbones.vgg import VGG16
from xpt_mde_tpu_torch.models.backbones.xception import Xception

BACKBONE_NAMES = ["EfficientNetB0", "EfficientNetB1", "EfficientNetB2",
                  "EfficientNetB3", "EfficientNetB4", "EfficientNetB5",
                  "EfficientNetB6", "EfficientNetB7",
                  "ResNet50V2", "MobileNetV2", "VGG16",
                  "DenseNet121", "Xception", "NASNetMobile", "NASNetLarge"]

_KERAS_NETS = {"ResNet50V2": ResNet50V2, "MobileNetV2": MobileNetV2, "VGG16": VGG16,
               "DenseNet121": DenseNet121, "Xception": Xception}


def backbone_factory(net_name: str, dtype: torch.dtype = torch.float32,
                     in_channels: int = 3) -> torch.nn.Module:
    """Build a backbone by reference net name, computing in ``dtype`` on
    ``in_channels`` input channels (PoseNetPreTrained: the snippet's 15).
    A backbone whose preprocessing has 3-channel constants (EfficientNet,
    VGG16, DenseNet121) raises ValueError on another count."""
    if net_name.startswith("EfficientNetB") and net_name in BACKBONE_NAMES:
        return EfficientNet(variant=net_name[-2:], dtype=dtype, in_channels=in_channels)
    if net_name in _KERAS_NETS:
        return _KERAS_NETS[net_name](in_channels, dtype)
    if net_name in ("NASNetMobile", "NASNetLarge"):
        return NASNet(net_name[6:], in_channels, dtype)
    raise ValueError(f"unknown backbone: {net_name}")
