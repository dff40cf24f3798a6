"""Kernels K2, K3 and K4: the PWC-Net correlation cost volume on the card
and its two input gradients (``csrc/correlation.cu``).

Port of ``xpt_mde_tpu/ops/pallas/correlation.py``: K2 is the forward
kernel, K3 and K4 the kernels of its custom VJP (dcl and dcr). All three
take and give NCHW float32 tensors and compute exactly
:func:`xpt_mde_tpu_torch.ops.correlation.correlation_cost_plain` and its
autograd, up to the order of the float32 sums. :class:`Correlation` joins
them into one differentiable op. The TPU's routing gate (``_pallas_pays``),
its VMEM gates and the dy-row pre-slicing of its backward are not ported:
every level takes these kernels.
"""

from __future__ import annotations

import ctypes

import torch

from xpt_mde_tpu_torch.ops.kernels.build import load_library

SOURCE = "xpt_mde_tpu_torch/csrc/correlation.cu"
REPLACES = {"K2": "xpt_mde_tpu/ops/pallas/correlation.py:68",
            "K3": "xpt_mde_tpu/ops/pallas/correlation.py:88",
            "K4": "xpt_mde_tpu/ops/pallas/correlation.py:119"}


def num_displacements(max_displacement: int, stride: int) -> int:
    """n, the displacements per axis: ``len(range(-md, md + 1, stride))``;
    the cost volume has n * n channels."""
    return len(range(-max_displacement, max_displacement + 1, stride))


# K3's tiling (csrc/correlation.cu::corr_bwd_cl_kernel): a thread owns
# BWD_CL_PIX pixels one stride apart times BWD_CL_CHAN channels; a CUDA
# block one row of BWD_CL_TILE_X columns or fewer and a chunk of channels,
# split over more blocks until the grid has two blocks per SM. A stage
# copies one or more displacement rows' g and cr rows into shared memory:
# all of a block's in-frame rows at once where they fit BWD_CL_STAGE_BYTES,
# else one row per stage, double-buffered.
BWD_CL_PIX, BWD_CL_CHAN, BWD_CL_DISP = 4, 8, 9
BWD_CL_TILE_X = 128
BWD_CL_MIN_THREADS, BWD_CL_MAX_THREADS = 128, 256
BWD_CL_STAGE_BYTES = 80 * 1024
SMEM_LIMIT = 232448  # 227 KB, the most one block of an H100 may take
H100_SMS = 132


def _padded(col: int, stride: int) -> int:
    """The shared-memory index of staged column ``col`` (``padded`` in
    csrc/correlation.cu): ``stride % 32`` floats of padding per 32
    columns."""
    return col + (col >> 5) * (stride & 31)


def _bwd_cl_layout(tile_x: int, chan_blocks: int, n: int, stride: int, cb_skew: int):
    """(cr row pitch, channel-block pitch, g row pitch, floats per slot),
    as ``bwd_cl_layout`` in csrc/correlation.cu."""
    cr_pitch = _padded(tile_x + (n - 1) * stride - 1, stride) + 1
    cb_pitch = BWD_CL_CHAN * cr_pitch + cb_skew
    g_pitch = _padded(tile_x - 1, stride) + 1
    slot = -(-(chan_blocks * cb_pitch + n * g_pitch) // 4) * 4
    return cr_pitch, cb_pitch, g_pitch, slot


def bwd_cl_rows_max(n: int, stride: int, height: int) -> int:
    """The most in-frame displacement rows one image row can have."""
    return min(n, -(-height // stride))


def bwd_cl_smem_bytes(tile_x: int, chan_blocks: int, n: int, stride: int,
                      cb_skew: int = 0, rows_per_stage: int = 1, buffers: int = 2) -> int:
    """Shared memory of one K3 block: ``buffers`` buffers of
    ``rows_per_stage`` slots."""
    slot = _bwd_cl_layout(tile_x, chan_blocks, n, stride, cb_skew)[3]
    return buffers * rows_per_stage * slot * 4


def bwd_cl_bank_conflicts(tile_x: int, chan_blocks: int, n: int, stride: int,
                          cb_skew: int) -> int:
    """The most distinct shared-memory words that the first warp's lanes
    read from one bank in one load of their cr window (the kernel's
    ``row_q[w_addr[m]]``, any m): 1 means conflict-free."""
    _, cb_pitch, _, _ = _bwd_cl_layout(tile_x, chan_blocks, n, stride, cb_skew)
    groups = tile_x // BWD_CL_PIX
    lanes = [(t % groups, t // groups) for t in range(min(32, groups * chan_blocks))]
    worst = 1
    for m in range(BWD_CL_DISP + BWD_CL_PIX - 1):
        banks: dict[int, set] = {}
        for gi, cb in lanes:
            x0 = (gi // stride) * (BWD_CL_PIX * stride) + gi % stride
            addr = cb * cb_pitch + _padded(x0 + m * stride, stride)
            banks.setdefault(addr % 32, set()).add(addr)
        worst = max(worst, max(len(words) for words in banks.values()))
    return worst


def bwd_cl_plan(batch: int, channels: int, height: int, width: int,
                max_displacement: int, stride: int, num_sms: int = H100_SMS) -> dict:
    """K3's launch for these shapes: ``tile_x`` (a multiple of 4 * stride
    covering up to 128 columns), ``chan_blocks`` (blocks of 8 channels per
    CUDA block: as many as 256 threads and 227 KB allow, fewer where the
    grid would have under two blocks per SM), ``cb_skew`` (the spacing of
    the channel blocks in shared memory with the fewest bank conflicts),
    ``rows_per_stage`` and ``buffers`` (every in-frame displacement row in
    one buffer where that fits BWD_CL_STAGE_BYTES, else one row per stage
    in two), ``threads``, ``smem_bytes`` and ``grid``. Narrows
    the channels, then the tile, until one row per stage fits 227 KB;
    raises ValueError where even one cluster of one channel block does not,
    or the grid is too large."""
    n = num_displacements(max_displacement, stride)
    cluster = BWD_CL_PIX * stride
    tile_x = cluster * -(-min(width, BWD_CL_TILE_X) // cluster)
    all_blocks = -(-channels // BWD_CL_CHAN)
    rows_max = bwd_cl_rows_max(n, stride, height)

    def smem(chan_blocks, cb_skew=31, rows=1):  # skew 31: room for any skew
        buffers = 1 if rows >= rows_max else 2
        return bwd_cl_smem_bytes(tile_x, chan_blocks, n, stride, cb_skew, rows, buffers)

    while True:
        groups = tile_x // BWD_CL_PIX
        chan_blocks = min(all_blocks, max(1, BWD_CL_MAX_THREADS // groups))
        while chan_blocks > 1 and smem(chan_blocks) > SMEM_LIMIT:
            chan_blocks -= 1
        if smem(chan_blocks) <= SMEM_LIMIT or tile_x == cluster:
            break
        tile_x -= cluster
    rows = -(-width // tile_x) * height * batch
    if rows * -(-all_blocks // chan_blocks) < 2 * num_sms:
        chunks = min(all_blocks, -(-2 * num_sms // rows))
        chan_blocks = -(-all_blocks // chunks)
    skews = range(0, 32, 4) if stride % 4 == 0 else range(32)
    cb_skew = min(skews, key=lambda k: (
        bwd_cl_bank_conflicts(tile_x, chan_blocks, n, stride, k), k))
    rows_per_stage = next((r for r in range(rows_max, 0, -1)
                           if smem(chan_blocks, cb_skew, r) <= BWD_CL_STAGE_BYTES), 1)
    buffers = 1 if rows_per_stage >= rows_max else 2
    smem_bytes = smem(chan_blocks, cb_skew, rows_per_stage)
    threads = max(BWD_CL_MIN_THREADS, -(-groups * chan_blocks // 32) * 32)
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(f"K3 needs {smem_bytes} bytes of shared memory at md "
                         f"{max_displacement}, stride {stride}, more than {SMEM_LIMIT}")
    if threads > BWD_CL_MAX_THREADS:
        raise ValueError(f"K3 needs {threads} threads per block at stride {stride}, "
                         f"more than {BWD_CL_MAX_THREADS}")
    grid = (-(-width // tile_x), height, batch * -(-all_blocks // chan_blocks))
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"K3's grid {grid} exceeds 65535 rows or chunks")
    return {"tile_x": tile_x, "chan_blocks": chan_blocks, "cb_skew": cb_skew,
            "rows_per_stage": rows_per_stage, "buffers": buffers, "threads": threads,
            "smem_bytes": smem_bytes, "grid": grid}


def _check(feats, other, max_displacement, stride, grad_out=None):
    """Raise unless the kernels take these: two feature maps [B,C,H,W] of
    one shape, ``grad_out`` [B,n^2,H,W] or None, an int md >= 0 and an int
    stride >= 1; all float32, contiguous, on one CUDA device."""
    if not (isinstance(max_displacement, int) and max_displacement >= 0):
        raise ValueError(f"max_displacement must be an int >= 0, got {max_displacement!r}")
    if not (isinstance(stride, int) and stride >= 1):
        raise ValueError(f"stride must be an int >= 1, got {stride!r}")
    if feats.dim() != 4 or other.shape != feats.shape:
        raise ValueError(f"feature maps must be two [B,C,H,W] of one shape, got "
                         f"{tuple(feats.shape)} and {tuple(other.shape)}")
    tensors = [("features", feats), ("features", other)]
    if grad_out is not None:
        n = num_displacements(max_displacement, stride)
        batch, _, height, width = feats.shape
        if tuple(grad_out.shape) != (batch, n * n, height, width):
            raise ValueError(f"grad_out must be {(batch, n * n, height, width)}, "
                             f"got {tuple(grad_out.shape)}")
        tensors.append(("grad_out", grad_out))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} must be on one CUDA device, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _CorrEntry:
    """One C entry of ``correlation.cu``, built at first use. ``launches``
    counts the launches this wrapper made."""

    def __init__(self, name: str, entry: str, n_launch_ints: int = 0):
        self.name = name
        self.launches = 0
        self.build_log = ""
        self._entry = entry
        self._n_launch_ints = n_launch_ints
        self._fn = None

    def build(self):
        """Compile (or reuse) and load the library; return the C entry."""
        if self._fn is None:
            lib, self.build_log = load_library("correlation", ("correlation.cu",))
            fn = getattr(lib, self._entry)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (6 + self._n_launch_ints)
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, first, second, out, feats_shape, max_displacement, stride, launch=()):
        """Call the entry with the three pointers, the feature maps' shape,
        md, stride, the ``launch`` ints and the current stream; raise on a
        CUDA error."""
        fn = self.build()
        batch, channels, height, width = feats_shape
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = fn(first.data_ptr(), second.data_ptr(), out.data_ptr(),
                     batch, channels, height, width, max_displacement, stride, *launch,
                     stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {err}")
        self.launches += 1
        return out


class CorrKernel(_CorrEntry):
    """Launches K2."""

    def __init__(self):
        super().__init__("K2", "xpt_corr_fwd")

    def __call__(self, cl: torch.Tensor, cr: torch.Tensor, max_displacement: int,
                 stride: int) -> torch.Tensor:
        """:param cl, cr: [B,C,H,W] float32, contiguous, on one CUDA device.
        :return: [B,n^2,H,W]. Differentiable calls go through
        :class:`Correlation`."""
        _check(cl, cr, max_displacement, stride)
        if torch.is_grad_enabled() and (cl.requires_grad or cr.requires_grad):
            raise ValueError("K2 called directly drops the gradient: use "
                             "Correlation.apply (ops.correlation.correlation_cost)")
        n = num_displacements(max_displacement, stride)
        batch, _, height, width = cl.shape
        out = torch.empty((batch, n * n, height, width), dtype=cl.dtype, device=cl.device)
        return self._launch(cl, cr, out, cl.shape, max_displacement, stride)


class CorrGradKernel(_CorrEntry):
    """Launches K3 (the gradient of the left features, from the right
    ones) or K4 (the gradient of the right features, from the left ones)."""

    def __call__(self, grad_out: torch.Tensor, feats: torch.Tensor,
                 max_displacement: int, stride: int) -> torch.Tensor:
        """:param grad_out: [B,n^2,H,W], the cotangent of K2's output;
        :param feats: [B,C,H,W], cr for K3, cl for K4. :return: dcl (K3) or
        dcr (K4), [B,C,H,W]."""
        grad_out = grad_out.contiguous()
        _check(feats, feats, max_displacement, stride, grad_out)
        launch = self._plan(feats.shape, max_displacement, stride, feats.device)
        out = torch.empty_like(feats)
        return self._launch(grad_out, feats, out, feats.shape, max_displacement, stride,
                            launch)

    def _plan(self, feats_shape, max_displacement, stride, device) -> tuple:
        """The launch ints the entry takes after md and stride: none."""
        return ()


class CorrGradClKernel(CorrGradKernel):
    """Launches K3, tiled by :func:`bwd_cl_plan`."""

    def __init__(self):
        super().__init__("K3", "xpt_corr_bwd_cl", 7)

    def _plan(self, feats_shape, max_displacement, stride, device) -> tuple:
        num_sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = bwd_cl_plan(*feats_shape, max_displacement, stride, num_sms)
        return (plan["tile_x"], plan["chan_blocks"], plan["cb_skew"], plan["rows_per_stage"],
                plan["buffers"], plan["threads"], plan["smem_bytes"])


K2 = CorrKernel()
K3 = CorrGradClKernel()
K4 = CorrGradKernel("K4", "xpt_corr_bwd_cr")


class Correlation(torch.autograd.Function):
    """K2 forward; K3 and K4 backward, each only for an input that needs
    its gradient."""

    @staticmethod
    def forward(ctx, cl, cr, max_displacement, stride):
        ctx.save_for_backward(cl, cr)
        ctx.md_stride = (max_displacement, stride)
        return K2(cl, cr, max_displacement, stride)

    @staticmethod
    def backward(ctx, grad_out):
        cl, cr = ctx.saved_tensors
        md, stride = ctx.md_stride
        dcl = dcr = None
        if ctx.needs_input_grad[0]:
            dcl = K3(grad_out, cr, md, stride)
        if ctx.needs_input_grad[1]:
            dcr = K4(grad_out, cl, md, stride)
        return dcl, dcr, None, None
