"""VGG16 encoder (port of ``xpt_mde_tpu.models.backbones.vgg``), the twin
of ``tf.keras.applications.VGG16``.

Module names are the keras layer names; every conv is 3x3 SAME with bias
and ReLU, and there is no BatchNorm. Taps: ``block{2,3,4,5}_conv{last}``
(strides 2, 4, 8, 16, before each pool) and ``block5_pool`` (32). The
input is "caffe"-mode preprocessed: RGB to BGR, then the BGR ImageNet
mean subtracted, no scaling; its 3-entry mean takes 3 channels only.
"""

from __future__ import annotations

import torch

from xpt_mde_tpu_torch.models.backbones.keras_net import KerasNet

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_STAGES = [("block1", 64, 2), ("block2", 128, 2), ("block3", 256, 3),
           ("block4", 512, 3), ("block5", 512, 3)]


class VGG16(KerasNet):
    def __init__(self, in_channels: int = 3, dtype: torch.dtype = torch.float32):
        if in_channels != 3:
            raise ValueError(f"VGG16 takes 3 channels, not {in_channels}: its caffe-mode "
                             "preprocessing subtracts a 3-entry BGR mean")
        super().__init__(in_channels, dtype)

    def preprocess(self, x):
        mean = torch.tensor(_CAFFE_MEAN_BGR, dtype=x.dtype, device=x.device)
        return x.flip(1) - mean[:, None, None]

    def _net(self, x):
        taps = []
        for stage_idx, (sname, ch, convs) in enumerate(_STAGES):
            for c in range(1, convs + 1):
                x = self.relu(self.conv(x, f"{sname}_conv{c}", ch, 3, bias=True))
            if stage_idx >= 1:
                taps.append(x)  # block{2..5}_conv{last}
            x = self.max_pool(x, 2, 2)  # block{i}_pool
        taps.append(x)  # block5_pool
        return taps
