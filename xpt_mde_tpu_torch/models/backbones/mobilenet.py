"""MobileNetV2 encoder (port of ``xpt_mde_tpu.models.backbones.mobilenet``),
the twin of ``tf.keras.applications.MobileNetV2`` (alpha 1.0).

Module names are the keras layer names. Taps: ``block_{1,3,6,13}_expand_relu``
(strides 2, 4, 8, 16) and ``out_relu`` (32).

Kept from the JAX twin: relu6; a stride-2 depthwise conv takes a fixed
((0, 1), (0, 1)) zero pad and then VALID (keras's ``correct_pad`` would
pad otherwise at odd sizes; the JAX package hard-codes this pad);
residual adds only on stride-1 blocks whose widths match; BatchNorm eps
1e-3 and flax momentum 0.999 (torch 0.001). The input is "tf"-mode
preprocessed, x / 127.5 - 1.
"""

from __future__ import annotations

from xpt_mde_tpu_torch.models.backbones.keras_net import KerasNet, tf_preprocess

# (out_ch, stride) per block_1..block_16; expansion is 6x input channels
_BLOCKS = [(24, 2), (24, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1),
           (64, 1), (64, 1), (96, 1), (96, 1), (96, 1), (160, 2), (160, 1),
           (160, 1), (320, 1)]
_TAP_BLOCKS = (1, 3, 6, 13)


class MobileNetV2(KerasNet):
    bn_momentum = 1.0 - 0.999

    def preprocess(self, x):
        return tf_preprocess(x)

    def _depthwise(self, y, name, stride):
        if stride == 2:
            return self.depthwise(self.pad(y, 0, 1, 0, 1), name, 3, 2, "VALID")
        return self.depthwise(y, name, 3)

    def _net(self, x):
        x = self.relu6(self.norm(self.conv(x, "Conv1", 32, 3, 2), "bn_Conv1"))
        # expanded_conv: the expansion-1 first block
        x = self.relu6(self.norm(self._depthwise(x, "expanded_conv_depthwise", 1),
                               "expanded_conv_depthwise_BN"))
        x = self.norm(self.conv(x, "expanded_conv_project", 16), "expanded_conv_project_BN")
        taps = []
        for i, (out_ch, stride) in enumerate(_BLOCKS, start=1):
            p = f"block_{i}"
            in_ch = self.channels(x)
            y = self.relu6(self.norm(self.conv(x, f"{p}_expand", in_ch * 6), f"{p}_expand_BN"))
            if i in _TAP_BLOCKS:
                taps.append(y)  # block_i_expand_relu
            y = self.relu6(self.norm(self._depthwise(y, f"{p}_depthwise", stride),
                                   f"{p}_depthwise_BN"))
            y = self.norm(self.conv(y, f"{p}_project", out_ch), f"{p}_project_BN")
            x = self.add(x, y) if (stride == 1 and in_ch == out_ch) else y
        taps.append(self.relu6(self.norm(self.conv(x, "Conv_1", 1280), "Conv_1_bn")))  # out_relu
        return taps
