"""Multi-scale backbones (strides 2, 4, 8, 16, 32). Ported so far:
EfficientNet B0-B7."""

import torch

from xpt_mde_tpu_torch.models.backbones.efficientnet import EfficientNet

BACKBONE_NAMES = [f"EfficientNetB{i}" for i in range(8)]


def backbone_factory(net_name: str, dtype: torch.dtype = torch.float32):
    """Build a ported backbone by reference net name, computing in ``dtype``."""
    if net_name in BACKBONE_NAMES:
        return EfficientNet(variant=net_name[-2:], dtype=dtype)
    raise NotImplementedError(
        f"depth net or backbone {net_name!r} is not ported yet (ROADMAP queue 1 item 5, "
        "'Breadth': ResNet50V2, MobileNetV2, DenseNet121, VGG16, Xception, NASNet)")
