"""DenseNet121 encoder (port of ``xpt_mde_tpu.models.backbones.densenet``),
the twin of ``tf.keras.applications.DenseNet121``.

Module names are the keras layer names (keras 2.4's "conv1/relu" slashes
as underscores). Taps: ``conv1_relu`` (stride 2), ``pool{2,3,4}_conv``
(4, 8, 16: each transition's 1x1 conv, taken BEFORE its 2x2 average
pool) and the final relu (32).

Kept from keras: explicit zero pads before the 7x7 stem conv and the
stride-2 max pool, growth by concatenation of 32 channels a block, bias-
free convs, BatchNorm eps 1.001e-5. The input is "torch"-mode
preprocessed, (x / 255 - mean) / std with 3-entry constants, so it takes
3 channels only.
"""

from __future__ import annotations

import torch

from xpt_mde_tpu_torch.models.backbones.keras_net import KerasNet

_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)
_BLOCKS = (6, 12, 24, 16)


class DenseNet121(KerasNet):
    bn_eps = 1.001e-5

    def __init__(self, in_channels: int = 3, dtype: torch.dtype = torch.float32):
        if in_channels != 3:
            raise ValueError(f"DenseNet121 takes 3 channels, not {in_channels}: its torch-mode "
                             "preprocessing normalizes with a 3-entry mean and std")
        super().__init__(in_channels, dtype)

    def preprocess(self, x):
        mean = torch.tensor(_TORCH_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
        std = torch.tensor(_TORCH_STD, dtype=x.dtype, device=x.device)[:, None, None]
        return (x / 255.0 - mean) / std

    def _net(self, x):
        x = self.conv(self.pad(x, 3, 3, 3, 3), "conv1_conv", 64, 7, 2, "VALID")
        f2 = self.relu(self.norm(x, "conv1_bn"))  # conv1_relu
        x = self.max_pool(self.pad(f2, 1, 1, 1, 1), 3, 2)
        taps = [f2]
        for stage_idx, blocks in enumerate(_BLOCKS):
            sname = f"conv{stage_idx + 2}"
            for b in range(1, blocks + 1):
                p = f"{sname}_block{b}"
                y = self.relu(self.norm(x, f"{p}_0_bn"))
                y = self.conv(y, f"{p}_1_conv", 128, 1, pad="VALID")
                y = self.relu(self.norm(y, f"{p}_1_bn"))
                y = self.conv(y, f"{p}_2_conv", 32, 3)
                x = self.cat([x, y])
            if stage_idx < 3:  # transition pool{2,3,4}
                pname = f"pool{stage_idx + 2}"
                y = self.relu(self.norm(x, f"{pname}_bn"))
                y = self.conv(y, f"{pname}_conv", self.channels(x) // 2, 1, pad="VALID")
                taps.append(y)  # tapped before the average pool
                x = self.avg_pool(y, 2, 2)
            else:
                taps.append(self.relu(self.norm(x, "bn")))  # the final relu
        return taps
