"""Xception encoder (port of ``xpt_mde_tpu.models.backbones.xception``),
the twin of ``tf.keras.applications.Xception``.

The input is "tf"-mode preprocessed (x / 127.5 - 1) BEFORE it is resized
bilinearly (tf semantics, ``utils/image.py``) to (H + 6, W + 6), so that
the two VALID stem convs land the taps exactly at strides 2..32. Module
names are the keras layer names; the keras auto-named residual convs and
norms are ``xres_conv_{i}`` / ``xres_bn_{i}``, and a SeparableConv2D is
two bias-free convs, ``{name}_dw`` (depthwise) and ``{name}_pw`` (1x1),
as in the JAX twin. Taps: ``block{2,3,4}_sepconv2_bn`` (strides 2, 4, 8),
``block13_sepconv2_bn`` (16) and ``block14_sepconv2_act`` (32). The
entry blocks' pools are flax SAME max pools (-inf pads, (0, 1) at even
sizes). BatchNorm eps 1e-3; block 2 has no ReLU before its first
sepconv.
"""

from __future__ import annotations

from xpt_mde_tpu_torch.models.backbones.keras_net import KerasNet, tf_preprocess
from xpt_mde_tpu_torch.utils.image import resize_nchw


class Xception(KerasNet):
    def preprocess(self, x):
        x = tf_preprocess(x)
        return resize_nchw(x, x.shape[-2] + 6, x.shape[-1] + 6, "bilinear")

    def _sepconv(self, y, name, features):
        return self.conv(self.depthwise(y, f"{name}_dw", 3), f"{name}_pw", features)

    def _entry_block(self, y, block, sep1_ch, sep2_ch, relu_first=True):
        residual = self.norm(self.conv(y, f"xres_conv_{self._xres}", sep2_ch, 1, 2),
                           f"xres_bn_{self._xres}")
        self._xres += 1
        if relu_first:
            y = self.relu(y)
        y = self.norm(self._sepconv(y, f"block{block}_sepconv1", sep1_ch),
                    f"block{block}_sepconv1_bn")
        tap = self.norm(self._sepconv(self.relu(y), f"block{block}_sepconv2", sep2_ch),
                      f"block{block}_sepconv2_bn")
        return self.add(self.max_pool(tap, 3, 2, same=True), residual), tap

    def _net(self, x):
        x = self.relu(self.norm(self.conv(x, "block1_conv1", 32, 3, 2, "VALID"),
                              "block1_conv1_bn"))
        x = self.relu(self.norm(self.conv(x, "block1_conv2", 64, 3, 1, "VALID"),
                              "block1_conv2_bn"))
        self._xres = 0  # the keras auto-name counter
        taps = []
        x, tap = self._entry_block(x, 2, 128, 128, relu_first=False)
        taps.append(tap)
        x, tap = self._entry_block(x, 3, 256, 256)
        taps.append(tap)
        x, tap = self._entry_block(x, 4, 728, 728)
        taps.append(tap)
        for block in range(5, 13):  # middle flow
            y = x
            for s in (1, 2, 3):
                y = self.norm(self._sepconv(self.relu(y), f"block{block}_sepconv{s}", 728),
                            f"block{block}_sepconv{s}_bn")
            x = self.add(x, y)
        x, tap = self._entry_block(x, 13, 728, 1024)
        taps.append(tap)
        x = self.relu(self.norm(self._sepconv(x, "block14_sepconv1", 1536), "block14_sepconv1_bn"))
        x = self.relu(self.norm(self._sepconv(x, "block14_sepconv2", 2048), "block14_sepconv2_bn"))
        taps.append(x)
        return taps
