"""ResNet50V2 encoder (port of ``xpt_mde_tpu.models.backbones.resnet``),
the twin of ``tf.keras.applications.ResNet50V2``.

Module names are the keras layer names. Taps: ``conv1_conv`` (stride 2),
``conv{2,3,4}_block{last}_1_relu`` (4, 8, 16) and ``post_relu`` (32).

Kept from keras: explicit zero pads before the 7x7 stem conv, the stem's
max pool (zeros, not -inf: the stem output is not ReLU'd) and the strided
3x3 convs; pre-activation blocks, the stride in each stage's last block,
whose shortcut is the 1x1 stride-2 max pool (a strided slice); a conv
shortcut on each stage's first block; bias on the 1x1 convs but the
bottleneck's first; BatchNorm eps 1.001e-5, flax momentum 0.99. The
input is "tf"-mode preprocessed, x / 127.5 - 1.
"""

from __future__ import annotations

from xpt_mde_tpu_torch.models.backbones.keras_net import KerasNet, tf_preprocess

_STAGES = [("conv2", 64, 3), ("conv3", 128, 4), ("conv4", 256, 6), ("conv5", 512, 3)]


class ResNet50V2(KerasNet):
    bn_eps = 1.001e-5

    def preprocess(self, x):
        return tf_preprocess(x)

    def _net(self, x):
        x = self.conv(self.pad(x, 3, 3, 3, 3), "conv1_conv", 64, 7, 2, "VALID", bias=True)
        taps = [x]
        x = self.max_pool(self.pad(x, 1, 1, 1, 1), 3, 2)
        for stage_idx, (sname, ch, blocks) in enumerate(_STAGES):
            for b in range(1, blocks + 1):
                p = f"{sname}_block{b}"
                strided = b == blocks and stage_idx < 3
                preact = self.relu(self.norm(x, f"{p}_preact_bn"))
                if b == 1:
                    shortcut = self.conv(preact, f"{p}_0_conv", ch * 4, 1, 2 if strided else 1,
                                         "VALID", bias=True)
                elif strided:
                    shortcut = self.subsample(x)
                else:
                    shortcut = x
                y = self.relu(self.norm(self.conv(preact, f"{p}_1_conv", ch, 1, pad="VALID"),
                                      f"{p}_1_bn"))
                if strided:
                    taps.append(y)  # conv{2,3,4}_block{last}_1_relu
                y = self.conv(self.pad(y, 1, 1, 1, 1), f"{p}_2_conv", ch, 3, 2 if strided else 1,
                              "VALID")
                y = self.relu(self.norm(y, f"{p}_2_bn"))
                y = self.conv(y, f"{p}_3_conv", ch * 4, 1, pad="VALID", bias=True)
                x = self.add(shortcut, y)
        taps.append(self.relu(self.norm(x, "post_bn")))  # post_relu
        return taps
