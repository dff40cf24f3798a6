"""NASNet-A encoder, Mobile and Large (port of
``xpt_mde_tpu.models.backbones.nasnet``), the twin of
``tf.keras.applications.NASNetMobile`` / ``NASNetLarge``.

The input is "tf"-mode preprocessed (x / 127.5 - 1), then resized
bilinearly (tf semantics) to (H + 2, W + 2), so that the VALID 3x3
stride-2 stem conv lands the first tap at H/2. Cells follow keras's
``nasnet``: ``_sep_block`` is 2x [relu -> SeparableConv -> BN(eps 1e-3)]
whose first conv may be strided (keras's ``correct_pad``, which depends
on the size's parity, then VALID); ``_adjust`` matches the previous
cell's output p to this one's (two stride-2 paths, the second shifted by
a pixel: zero pad bottom and right, then ``[1::2]``; or a 1x1
projection); 5-block normal and reduction cells; the reduction cell's
VALID pools share one explicit zero pad, whose zeros count in the
average; its last sep block reuses keras's ``reduction_left4`` name.
Module names are the keras layer names, a SeparableConv2D split into
``{name}_dw`` / ``{name}_pw``.

Taps, in order: relu(stem_bn1) (stride 2), relu(adjusted p) in the cells
stem_2, reduce_N and reduce_2N (4, 8, 16), relu of the last normal cell
(32). 'Mobile': N = 4 cells a stack, penultimate 1056, stem 32; 'Large':
N = 6, penultimate 4032, stem 96, and p carries past the reductions
(``skip_reduction``).
"""

from __future__ import annotations

import torch

from xpt_mde_tpu_torch.models.backbones.keras_net import KerasNet, _Spec, tf_preprocess
from xpt_mde_tpu_torch.utils.image import resize_nchw

# variant: (cells a stack, penultimate filters, stem filters, skip_reduction)
_VARIANTS = {"Mobile": (4, 1056, 32, False), "Large": (6, 4032, 96, True)}


def _correct_pad(x, kernel: int) -> tuple[int, int, int, int]:
    """keras ``correct_pad`` for a stride-2 VALID conv or pool, as
    (top, bottom, left, right): SAME's alignment at even sizes."""
    h, w = x.shape[-2:]
    half = kernel // 2
    return half - (1 - h % 2), half, half - (1 - w % 2), half


def _same_size(a, b) -> bool:
    """Whether ``a`` and ``b`` have one height (while the net is built: one
    stride, which stands for it)."""
    if isinstance(a, _Spec):
        return a.stride == b.stride
    return a.shape[-2] == b.shape[-2]


class NASNet(KerasNet):
    """NASNet-A; ``variant`` 'Mobile' or 'Large'. Emits 5 maps at strides
    2..32 of the input (the +2 resize cancels the VALID stem)."""

    def __init__(self, variant: str = "Mobile", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        if variant not in _VARIANTS:
            raise ValueError(f"unknown NASNet variant: {variant!r}")
        self.variant = variant
        super().__init__(in_channels, dtype)

    def preprocess(self, x):
        x = tf_preprocess(x)
        return resize_nchw(x, x.shape[-2] + 2, x.shape[-1] + 2, "bilinear")

    def _pad_for(self, x, kernel):
        return x if isinstance(x, _Spec) else self.pad(x, *_correct_pad(x, kernel))

    def _sep_block(self, ip, filters, kernel, stride, block_id):
        x = self.relu(ip)
        if stride == 2:
            x = self.depthwise(self._pad_for(x, kernel), f"separable_conv_1_{block_id}_dw",
                               kernel, 2, "VALID")
        else:
            x = self.depthwise(x, f"separable_conv_1_{block_id}_dw", kernel)
        x = self.conv(x, f"separable_conv_1_{block_id}_pw", filters)
        x = self.relu(self.norm(x, f"separable_conv_1_bn_{block_id}"))
        x = self.depthwise(x, f"separable_conv_2_{block_id}_dw", kernel)
        x = self.conv(x, f"separable_conv_2_{block_id}_pw", filters)
        return self.norm(x, f"separable_conv_2_bn_{block_id}")

    def _adjust(self, p, ip, filters, block_id):
        if p is None:
            return ip
        if not _same_size(p, ip):
            p = self.relu(p)
            p1 = self.conv(self.subsample(p), f"adjust_conv_1_{block_id}", filters // 2)
            # zero pad bottom and right, then crop top and left: a one-pixel shift
            p2 = self.subsample(self.pad(p, 0, 1, 0, 1), offset=1)
            p2 = self.conv(p2, f"adjust_conv_2_{block_id}", filters // 2)
            return self.norm(self.cat([p1, p2]), f"adjust_bn_{block_id}")
        if self.channels(p) != filters:
            p = self.conv(self.relu(p), f"adjust_conv_projection_{block_id}", filters)
            return self.norm(p, f"adjust_bn_{block_id}")
        return p

    def _normal_cell(self, ip, p, filters, block_id):
        p = self._adjust(p, ip, filters, block_id)
        h = self.norm(self.conv(self.relu(ip), f"normal_conv_1_{block_id}", filters),
                    f"normal_bn_1_{block_id}")

        def sep(y, kernel, name):
            return self._sep_block(y, filters, kernel, 1, f"{name}_{block_id}")

        x1 = self.add(sep(h, 5, "normal_left1"), sep(p, 3, "normal_right1"))
        x2 = self.add(sep(p, 5, "normal_left2"), sep(p, 3, "normal_right2"))
        x3 = self.add(self.avg_pool_same(h), p)
        x4 = self.add(self.avg_pool_same(p), self.avg_pool_same(p))
        x5 = self.add(sep(h, 3, "normal_left5"), h)
        return self.cat([p, x1, x2, x3, x4, x5]), ip

    def _reduction_cell(self, ip, p, filters, block_id):
        """(out, the new p, the tap relu(adjusted p))."""
        p = self._adjust(p, ip, filters, block_id)
        tap = self.relu(p)
        h = self.norm(self.conv(self.relu(ip), f"reduction_conv_1_{block_id}", filters),
                    f"reduction_bn_1_{block_id}")
        h3 = self._pad_for(h, 3)  # shared by the VALID stride-2 pools

        def sep(y, kernel, stride, name):
            return self._sep_block(y, filters, kernel, stride, f"{name}_{block_id}")

        x1 = self.add(sep(h, 5, 2, "reduction_left1"), sep(p, 7, 2, "reduction_right1"))
        x2 = self.add(self.max_pool(h3, 3, 2), sep(p, 7, 2, "reduction_right2"))
        x3 = self.add(self.avg_pool(h3, 3, 2), sep(p, 5, 2, "reduction_right3"))
        x4 = self.add(self.avg_pool_same(x1), x2)
        x5 = self.add(sep(x1, 3, 1, "reduction_left4"), self.max_pool(h3, 3, 2))
        return self.cat([x2, x3, x4, x5]), ip, tap

    def _net(self, x):
        repeats, penultimate, stem_filters, skip_red = _VARIANTS[self.variant]
        filters = penultimate // 24  # filter_multiplier 2
        x = self.norm(self.conv(x, "stem_conv1", stem_filters, 3, 2, "VALID"), "stem_bn1")
        taps = []
        x, p, tap = self._reduction_cell(x, None, filters // 4, "stem_1")
        taps.append(tap)
        x, p, tap = self._reduction_cell(x, p, filters // 2, "stem_2")
        taps.append(tap)
        for i in range(repeats):
            x, p = self._normal_cell(x, p, filters, f"{i}")
        x, p0, tap = self._reduction_cell(x, p, filters * 2, f"reduce_{repeats}")
        taps.append(tap)
        p = p if skip_red else p0
        for i in range(repeats):
            x, p = self._normal_cell(x, p, filters * 2, f"{repeats + i + 1}")
        x, p0, tap = self._reduction_cell(x, p, filters * 4, f"reduce_{2 * repeats}")
        taps.append(tap)
        p = p if skip_red else p0
        for i in range(repeats):
            x, p = self._normal_cell(x, p, filters * 4, f"{2 * repeats + i + 1}")
        taps.append(self.relu(x))
        return taps
