"""Correlation cost volume of PWC-Net (port of ``xpt_mde_tpu.ops.correlation``).

For every pixel, the channel mean of the left feature times the right
feature displaced by each (dy, dx) of the grid ``range(-md, md + 1,
stride)`` squared, dy-major; a displaced position outside the frame
counts as zero:

    out[b, k, y, x] = (1/C) sum_c cl[b, c, y, x] * cr[b, c, y + dy_k, x + dx_k]

On a spatial mesh (``parallel.spatial``) cl is a band of h rows and cr
the H_r rows that band reads (its halo or the whole map), ``row_offset``
rows apart: cl's row y meets cr's row y + row_offset + dy_k, and a row
outside cr's [0, H_r) counts as zero. The gradient of cr then covers cr's
H_r rows: the band's share, which the collective that gave cr sums back
to the rows' owners. ``row_offset`` 0 with h = H_r is the whole frame.

The port works channel-first (NCHW), the layout of its convolutions and
of the Pallas kernel; the JAX twin works channel-last. On a CUDA tensor
the cost volume is :class:`~xpt_mde_tpu_torch.ops.kernels.correlation.
Correlation` (kernel K2 forward, K3 and K4 backward), or where no
gradient is needed K2 alone through the registered operator
``torch.ops.xpt_mde.correlation_cost``, which ``torch.export`` records; on
a CPU tensor it is :func:`correlation_cost_plain` and its autograd. The plain versions of
the three kernels, their oracles on the card, are
:func:`correlation_cost_plain`, :func:`correlation_grad_cl_plain` and
:func:`correlation_grad_cr_plain`; the autograd of the first is a second
oracle of the other two.

Float32 and bfloat16 operands (the JAX package's default compute dtype)
are taken, as by the Pallas kernels: each operand is read as float32,
products are summed in float32 and divided by C, and the result is
rounded once to the operand dtype. (The JAX package's XLA fallback, its
CPU route, rounds every product to bfloat16 first; the kernels do not.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xpt_mde_tpu_torch.ops.kernels.correlation import Correlation, num_displacements
from xpt_mde_tpu_torch.utils.precision import at_least_f32


def _cr_window(cr: torch.Tensor, max_displacement: int, rows: int,
               row_offset: int) -> torch.Tensor:
    """cr's rows ``row_offset - md`` .. ``row_offset + rows - 1 + md`` and
    columns -md .. W - 1 + md, float32 at least, zero outside cr's frame:
    the window that ``rows`` rows of cl starting ``row_offset`` rows below
    cr's first row read. With ``row_offset`` 0 and ``rows`` cr's height it
    is cr zero-padded by md on every side."""
    md = max_displacement
    top = max(0, md - row_offset)
    bottom = max(0, row_offset + rows + md - cr.shape[-2])
    padded = F.pad(at_least_f32(cr), (md, md, top, bottom))
    return padded.narrow(-2, row_offset - md + top, rows + 2 * md)


def correlation_cost_plain(cl: torch.Tensor, cr: torch.Tensor,
                           max_displacement: int, stride: int = 1,
                           row_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch cost volume on any device (K2's oracle; its autograd
    is K3's and K4's).

    :param cl, cr: left and right features [B, C, h, W] and [B, C, H_r, W],
        both float32 or both bfloat16
    :param max_displacement: md, the largest displacement in pixels
    :param stride: the displacement grid's stride
    :param row_offset: cl's first row's global row minus cr's first row's
        (a band of a spatial mesh against the rows it reads); a displaced
        row outside cr's [0, H_r) counts as zero. 0 with h = H_r: the whole
        frame
    :return: [B, n^2, h, W] in the operands' dtype,
        n = len(range(-md, md + 1, stride))
    """
    height, width = cl.shape[-2:]
    md = max_displacement
    clf = at_least_f32(cl)
    cr_pad = _cr_window(cr, md, height, row_offset)
    offsets = range(-md, md + 1, stride)
    slices = [torch.sum(clf * cr_pad[:, :, md + dy: md + dy + height,
                                     md + dx: md + dx + width], dim=1)
              for dy in offsets for dx in offsets]
    return (torch.stack(slices, dim=1) / cl.shape[1]).to(cl.dtype)


def correlation_grad_cl_plain(grad_out: torch.Tensor, cr: torch.Tensor,
                              max_displacement: int, stride: int = 1,
                              row_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch gradient of the cost volume for the left features
    (K3's oracle): dcl = (1/C) sum_k g_k * (cr shifted by +(dy_k, dx_k)).

    :param grad_out: [B, n^2, h, W]; :param cr: [B, C, H_r, W], both
        float32 or both bfloat16; ``row_offset`` as for
        :func:`correlation_cost_plain`
    :return: dcl [B, C, h, W] in their dtype
    """
    height, width = grad_out.shape[-2:]
    md = max_displacement
    g = at_least_f32(grad_out)
    cr_pad = _cr_window(cr, md, height, row_offset)
    offsets = range(-md, md + 1, stride)
    acc = torch.zeros_like(cr_pad[:, :, :height, :width])
    for k, (dy, dx) in enumerate((dy, dx) for dy in offsets for dx in offsets):
        acc += g[:, k:k + 1] * cr_pad[:, :, md + dy: md + dy + height,
                                      md + dx: md + dx + width]
    return (acc / cr.shape[1]).to(cr.dtype)


def correlation_grad_cr_plain(grad_out: torch.Tensor, cl: torch.Tensor,
                              max_displacement: int, stride: int = 1,
                              row_offset: int = 0,
                              cr_height: int | None = None) -> torch.Tensor:
    """Plain PyTorch gradient of the cost volume for the right features
    (K4's oracle): dcr[y', x'] = (1/C) sum_k g_k * cl, both taken at
    (y' - dy_k, x' - dx_k), formed by adding each product into a padded
    frame at its displacement.

    :param grad_out: [B, n^2, h, W]; :param cl: [B, C, h, W], both float32
        or both bfloat16; ``row_offset`` as for
        :func:`correlation_cost_plain`, ``cr_height`` cr's rows H_r (h by
        default)
    :return: dcr [B, C, H_r, W] in their dtype: on a band, this band's
        share of the gradient of cr's rows
    """
    height, width = cl.shape[-2:]
    md = max_displacement
    cr_height = height if cr_height is None else cr_height
    g, clf = at_least_f32(grad_out), at_least_f32(cl)
    offsets = range(-md, md + 1, stride)
    acc = F.pad(torch.zeros_like(clf), (md, md, md, md))
    for k, (dy, dx) in enumerate((dy, dx) for dy in offsets for dx in offsets):
        acc[:, :, md + dy: md + dy + height, md + dx: md + dx + width] += \
            g[:, k:k + 1] * clf
    # acc's row r is cr's row row_offset - md + r
    first = row_offset - md
    lo = min(cr_height, max(0, first))
    hi = max(lo, min(cr_height, first + height + 2 * md))
    rows = acc[:, :, lo - first: hi - first, md: md + width]
    dcr = F.pad(rows, (0, 0, lo, cr_height - hi)) if (lo, hi) != (0, cr_height) else rows
    return (dcr / cl.shape[1]).to(cl.dtype)


def correlation_cost(cl: torch.Tensor, cr: torch.Tensor, max_displacement: int,
                     stride: int = 1, row_offset: int = 0) -> torch.Tensor:
    """The cost volume of :func:`correlation_cost_plain`: kernel K2 (K3
    and K4 in the backward) on CUDA tensors, the plain version on CPU
    tensors. There is no fallback: a CUDA input the kernels refuse raises.

    :param cl, cr: [B, C, h, W] and [B, C, H_r, W], ``row_offset`` as for
        :func:`correlation_cost_plain` (0 with h = H_r: the whole frame);
    :return: [B, n^2, h, W]
    """
    if cl.device.type == "cpu":
        return correlation_cost_plain(cl, cr, max_displacement, stride, row_offset)
    cl, cr = cl.contiguous(), cr.contiguous()
    if torch.is_grad_enabled() and (cl.requires_grad or cr.requires_grad):
        return Correlation.apply(cl, cr, max_displacement, stride, row_offset)
    # no gradient (a predict step, an exported predictor): the operator alone
    return torch.ops.xpt_mde.correlation_cost(cl, cr, max_displacement, stride, row_offset)


def correlation_channels(max_displacement: int, stride: int = 1) -> int:
    """The cost volume's channel count, n^2."""
    return num_displacements(max_displacement, stride) ** 2
