"""Kernels K2, K3 and K4: the PWC-Net correlation cost volume on the card
and its two input gradients (``csrc/correlation.cu`` in float32,
``csrc/correlation_bf16.cu`` in bfloat16; one library).

Port of ``xpt_mde_tpu/ops/pallas/correlation.py``: K2 is the forward
kernel, K3 and K4 the kernels of its custom VJP (dcl and dcr). All three
take and give NCHW tensors, float32 or bfloat16, and compute exactly
:func:`xpt_mde_tpu_torch.ops.correlation.correlation_cost_plain` and its
autograd, up to the order of the float32 sums. Each dtype has its own C
entries and wrappers (``K2`` and ``K2_BF16``, ...), each with its own
launch count; the bfloat16 kernels read and write bfloat16 in global
memory, sum in float32, divide by C and round once. :class:`Correlation`
joins them into one differentiable op and picks the kernels by the
operands' dtype; its forward is the registered operator
``xpt_mde::correlation_cost`` (:func:`correlation_cost_op`), which an
exported predictor records and calls. The TPU's routing gate (``_pallas_pays``), its VMEM
gates and the dy-row pre-slicing of its backward are not ported: every
level takes these kernels.

The float32 kernels are tiled for FFMA from float32 shared memory: a
CUDA block owns one image row and a tile of up to 128 columns, stages the
rows it needs into shared memory with ``cp.async``, and a thread owns 4
pixels one stride apart, so that each staged value feeds several FMAs
from a register.

- K2 (:func:`fwd_plan`): the block stages its cl tile once and, per
  stage, the cr rows y + dy_i of its in-frame displacement rows i with
  their dx halo; a thread owns 4 pixels times the displacements j of one
  row i and walks a group of channels; the block's channel groups are
  summed through shared memory in a fixed order and the outputs go out
  as whole rows (float4 where aligned). Displacement rows outside the
  frame are written as zero planes without compute.
- K3 and K4 (:func:`bwd_plan`, one plan for both): the block also owns a
  chunk of channels and walks its in-frame displacement rows; a stage
  holds the feature rows (cr for K3, cl for K4) with their halo and the
  n g rows of the row (for K4 each from its own column window x' - dx_j
  and in reversed order, so the two kernels share one inner loop); a
  thread owns 4 pixels times 8 channels.

The bfloat16 K2, K3 and K4 run on the tensor cores instead: the
rows stay bfloat16 in shared memory, staged by TMA boxes whose zero fill
is the frame's outside (by the block's threads into the same layout
where TMA cannot take the shape), and the work is cut by residue class
of x mod stride, where the channel and window sums are small band
products (``mma.sync`` m16n8k16, float32 accumulators):

- K2-bf16 (:func:`fwd_plan_bf16`): a warp owns 16 pixels of one class
  and 9 displacements, a 16 x 24 product per 16 channels of which 9
  diagonals are outputs; a block holds up to 4 in-frame displacement
  rows, and the rows are split into groups over the grid so that it has
  two blocks an SM.
- K3-bf16 (:func:`bwd_cl_plan_bf16`) and K4-bf16
  (:func:`bwd_cr_plan_bf16`): a warp owns 16 pixels of one class and up
  to 64 channels, one m16n8k16 per 16 channels, 8 pixels and 16 window
  columns against a banded matrix built from the staged g rows (K3: those
  of the block's in-frame displacement rows at its own image row, staged
  once and read at the pixels' columns; K4: the n g rows at each cl row,
  read at the window's columns); the block's channels are a chunk, split
  over the grid.

Each C entry recomputes its plan's layout and refuses a plan that does
not match; a shape that no plan fits raises ``ValueError`` here, before
any launch.

On a spatial mesh's band (``parallel.spatial``) every kernel takes
``row_offset`` and cr's own height H_r (:func:`xpt_mde_tpu_torch.ops.
correlation.correlation_cost_plain`): cl, g and dcl hold the band's h
rows, cr and dcr H_r rows, and a displaced row is in the frame where it
lies in cr's [0, H_r). K2's and K3's grids run over h rows and K4's over
H_r; the plans take ``cr_height`` and bound a row's in-frame displacement
rows by the rows each kernel reads (K2, K3: cr's; K4: cl's).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from xpt_mde_tpu_torch.ops.kernels.build import load_library

SOURCE = "xpt_mde_tpu_torch/csrc/correlation.cu"
BF16_SOURCE = "xpt_mde_tpu_torch/csrc/correlation_bf16.cu"
# the one library's sources (csrc/): nvcc compiles them in one call
LIBRARY_SOURCES = ("correlation.cu", "correlation_bf16.cu")
REPLACES = {"K2": "xpt_mde_tpu/ops/pallas/correlation.py:68",
            "K3": "xpt_mde_tpu/ops/pallas/correlation.py:88",
            "K4": "xpt_mde_tpu/ops/pallas/correlation.py:119"}


def num_displacements(max_displacement: int, stride: int) -> int:
    """n, the displacements per axis: ``len(range(-md, md + 1, stride))``;
    the cost volume has n * n channels."""
    return len(range(-max_displacement, max_displacement + 1, stride))


SMEM_LIMIT = 232448  # 227 KB, the most one block of an H100 may take
SMEM_PER_SM = 233472  # 228 KB per SM, of which each resident block takes 1 KB more
H100_SMS = 132
# a thread's pixels (one stride apart) and the displacements it takes at once
PIX, DISP = 4, 9
TILE_X = 128
MIN_THREADS, MAX_THREADS = 128, 256

# K3's and K4's tiling (csrc/correlation.cu::corr_bwd_kernel): a thread
# owns PIX pixels times BWD_CHAN channels; a CUDA block one row of TILE_X
# columns or fewer and a chunk of channels, split over more blocks until
# the grid has two blocks per SM. A stage copies one or more displacement
# rows' g and feature rows into shared memory: all of a block's in-frame
# rows at once where they fit BWD_STAGE_BYTES, else one row per stage,
# double-buffered.
BWD_CHAN = 8
BWD_STAGE_BYTES = 80 * 1024
# K2's tiling (csrc/correlation.cu::corr_fwd_kernel): every in-frame
# displacement row in one stage where the block fits FWD_SMEM_BYTES (two
# blocks an SM), else one row a stage within FWD_ROW_SMEM_BYTES (four
# blocks an SM, which beat two at levels 2 and 3)
FWD_SMEM_BYTES = SMEM_PER_SM // 2 - 1024
FWD_ROW_SMEM_BYTES = SMEM_PER_SM // 4 - 1024
# the launch ints of the C entries, after md and stride
FWD_LAUNCH_KEYS = ("tile_x", "rows_per_stage", "chan_groups", "skew", "slot_skew", "threads",
                   "smem_bytes")
BWD_LAUNCH_KEYS = ("tile_x", "chan_blocks", "cb_skew", "rows_per_stage", "buffers", "threads",
                   "smem_bytes")


def _padded(col: int, stride: int) -> int:
    """The shared-memory index of staged column ``col`` (``padded`` in
    csrc/correlation.cu): ``stride % 32`` floats of padding per 32
    columns."""
    return col + (col >> 5) * (stride & 31)


def _round4(floats: int) -> int:
    return -(-floats // 4) * 4


def _row_pitch(cols: int, stride: int) -> int:
    """Floats of one staged row of ``cols`` columns, padding included."""
    return _padded(cols - 1, stride) + 1


def _cluster_tile(width: int, stride: int) -> tuple[int, int]:
    """(cluster, tile_x): a thread's 4 pixels one stride apart make
    clusters of 4 * stride columns; the tile is the fewest clusters that
    cover min(width, TILE_X)."""
    cluster = PIX * stride
    return cluster, cluster * -(-min(width, TILE_X) // cluster)


def rows_max(n: int, stride: int, height: int) -> int:
    """The most in-frame displacement rows one image row can have."""
    return min(n, -(-height // stride))


def _group_x0(gi: int, stride: int) -> int:
    """Pixel group ``gi``'s first column: groups tile the row in clusters
    of 4 * stride columns, ``stride`` groups per cluster."""
    return (gi // stride) * (PIX * stride) + gi % stride


def _bwd_layout(tile_x: int, chan_blocks: int, n: int, stride: int, cb_skew: int):
    """(feature row pitch, channel-block pitch, g row pitch, floats per
    slot), as ``bwd_layout`` in csrc/correlation.cu."""
    feat_pitch = _row_pitch(tile_x + (n - 1) * stride, stride)
    cb_pitch = BWD_CHAN * feat_pitch + cb_skew
    g_pitch = _row_pitch(tile_x, stride)
    slot = _round4(chan_blocks * cb_pitch + n * g_pitch)
    return feat_pitch, cb_pitch, g_pitch, slot


def bwd_smem_bytes(tile_x: int, chan_blocks: int, n: int, stride: int,
                   cb_skew: int = 0, rows_per_stage: int = 1, buffers: int = 2) -> int:
    """Shared memory of one K3 or K4 block: ``buffers`` buffers of
    ``rows_per_stage`` slots."""
    slot = _bwd_layout(tile_x, chan_blocks, n, stride, cb_skew)[3]
    return buffers * rows_per_stage * slot * 4


def _conflicts(addresses: np.ndarray) -> int:
    """The most distinct shared-memory words that one load's lanes read
    from one bank: ``addresses`` [loads, lanes]; 1 means conflict-free."""
    worst = 1
    for row in addresses:
        words = np.unique(row)
        worst = max(worst, int(np.bincount(words % 32, minlength=32).max()))
    return worst


def bwd_bank_conflicts(tile_x: int, chan_blocks: int, n: int, stride: int,
                       cb_skew: int) -> int:
    """The most distinct shared-memory words that the first warp's lanes
    read from one bank in one load of their feature window (the kernel's
    ``row_q[w_addr[m]]``, any m): 1 means conflict-free."""
    _, cb_pitch, _, _ = _bwd_layout(tile_x, chan_blocks, n, stride, cb_skew)
    groups = tile_x // PIX
    lanes = [(t % groups, t // groups) for t in range(min(32, groups * chan_blocks))]
    return _conflicts(np.array([
        [cb * cb_pitch + _padded(_group_x0(gi, stride) + m * stride, stride)
         for gi, cb in lanes] for m in range(DISP + PIX - 1)]))


def bwd_plan(batch: int, channels: int, height: int, width: int,
             max_displacement: int, stride: int, num_sms: int = H100_SMS,
             cr_height: int | None = None) -> dict:
    """K3's and K4's launch for these shapes: ``tile_x`` (a multiple of
    4 * stride covering up to 128 columns), ``chan_blocks`` (blocks of 8
    channels per CUDA block: as many as 256 threads and 227 KB allow, fewer
    where the grid would have under two blocks per SM), ``cb_skew`` (the
    spacing of the channel blocks in shared memory with the fewest bank
    conflicts), ``rows_per_stage`` and ``buffers`` (every in-frame
    displacement row in one buffer where that fits BWD_STAGE_BYTES, else
    one row per stage in two), ``threads``, ``smem_bytes`` and ``grid``.
    The two kernels read the same layout, so one plan serves both. Narrows
    the channels, then the tile, until one row per stage fits 227 KB;
    raises ValueError where even one cluster of one channel block does not,
    or the grid is too large. ``height``: the rows of cl and g (K3's
    grid); ``cr_height``: cr's (K4's grid; ``height`` by default); a row's
    in-frame displacement rows are bounded by the larger, as K3 reads cr
    and K4 cl. ``grid`` is K3's. Computed once per shape: the wrappers ask
    at every launch."""
    return dict(_bwd_plan(batch, channels, height, width, max_displacement, stride, num_sms,
                          height if cr_height is None else cr_height))


@functools.lru_cache(maxsize=None)
def _bwd_plan(batch: int, channels: int, height: int, width: int, max_displacement: int,
              stride: int, num_sms: int, cr_height: int) -> tuple:
    n = num_displacements(max_displacement, stride)
    cluster, tile_x = _cluster_tile(width, stride)
    all_blocks = -(-channels // BWD_CHAN)
    most_rows = rows_max(n, stride, max(height, cr_height))

    def smem(chan_blocks, cb_skew=31, rows=1):  # skew 31: room for any skew
        buffers = 1 if rows >= most_rows else 2
        return bwd_smem_bytes(tile_x, chan_blocks, n, stride, cb_skew, rows, buffers)

    while True:
        groups = tile_x // PIX
        chan_blocks = min(all_blocks, max(1, MAX_THREADS // groups))
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
        bwd_bank_conflicts(tile_x, chan_blocks, n, stride, k), k))
    rows_per_stage = next((r for r in range(most_rows, 0, -1)
                           if smem(chan_blocks, cb_skew, r) <= BWD_STAGE_BYTES), 1)
    buffers = 1 if rows_per_stage >= most_rows else 2
    smem_bytes = smem(chan_blocks, cb_skew, rows_per_stage)
    threads = max(MIN_THREADS, -(-groups * chan_blocks // 32) * 32)
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(f"K3/K4 need {smem_bytes} bytes of shared memory at md "
                         f"{max_displacement}, stride {stride}, more than {SMEM_LIMIT}")
    if threads > MAX_THREADS:
        raise ValueError(f"K3/K4 need {threads} threads per block at stride {stride}, "
                         f"more than {MAX_THREADS}")
    grid = (-(-width // tile_x), height, batch * -(-all_blocks // chan_blocks))
    if max(height, cr_height) > 65535 or grid[2] > 65535:
        raise ValueError(f"K3/K4's grid {grid} exceeds 65535 rows or chunks")
    return (("tile_x", tile_x), ("chan_blocks", chan_blocks), ("cb_skew", cb_skew),
            ("rows_per_stage", rows_per_stage), ("buffers", buffers), ("threads", threads),
            ("smem_bytes", smem_bytes), ("grid", grid))


def _fwd_layout(tile_x: int, n: int, stride: int, chan_groups: int, chans_per_group: int,
                rows_per_stage: int, skew: int, slot_skew: int) -> dict:
    """K2's shared memory in floats, as ``fwd_layout`` in
    csrc/correlation.cu: the cl tile (one row of ``cl_pitch`` per
    channel), then the stage slots (one per displacement row: one cr row
    of ``cr_pitch`` per channel, its dx halo included), then, from a
    float4 boundary, the channel groups' partial sums (``part_pitch`` per
    output row)."""
    chans = chan_groups * chans_per_group
    cl_pitch = _row_pitch(tile_x, stride) + skew
    cr_pitch = _row_pitch(tile_x + (n - 1) * stride, stride) + skew
    return {"cl_pitch": cl_pitch, "cr_pitch": cr_pitch, "cl_area": _round4(chans * cl_pitch),
            "slot": _round4(chans * cr_pitch) + slot_skew,
            "part_pitch": _row_pitch(tile_x, stride),
            "part": chan_groups * rows_per_stage * n * _row_pitch(tile_x, stride)}


def fwd_smem_bytes(tile_x: int, n: int, stride: int, chan_groups: int, chans_per_group: int,
                   rows_per_stage: int, skew: int = 0, slot_skew: int = 0) -> int:
    """Shared memory of one K2 block."""
    lay = _fwd_layout(tile_x, n, stride, chan_groups, chans_per_group, rows_per_stage,
                      skew, slot_skew)
    return (_round4(lay["cl_area"] + rows_per_stage * lay["slot"]) + lay["part"]) * 4


def fwd_bank_conflicts(tile_x: int, n: int, stride: int, chan_groups: int,
                       chans_per_group: int, rows_per_stage: int, skew: int,
                       slot_skew: int) -> int:
    """The most distinct shared-memory words that one warp's lanes read
    from one bank in one load of K2's inner loop (its cl values and its
    cr window, any warp of the block): 1 means conflict-free."""
    lay = _fwd_layout(tile_x, n, stride, chan_groups, chans_per_group, rows_per_stage,
                      skew, slot_skew)
    groups = tile_x // PIX
    working = groups * rows_per_stage * chan_groups
    t = np.arange(working)
    x0 = _group_x0(t % groups, stride)
    row = t // groups % rows_per_stage
    chan = t // (groups * rows_per_stage) * chans_per_group
    loads = [chan * lay["cl_pitch"] + _padded(x0 + p * stride, stride) for p in range(PIX)]
    loads += [row * lay["slot"] + chan * lay["cr_pitch"] + _padded(x0 + m * stride, stride)
              for m in range(DISP + PIX - 1)]
    loads = np.stack(loads)
    return max(_conflicts(loads[:, w:w + 32]) for w in range(0, working, 32))


@functools.lru_cache(maxsize=None)
def _fwd_plan(batch: int, channels: int, height: int, width: int, max_displacement: int,
              stride: int, cr_height: int) -> tuple:
    if min(channels, width) < 1:
        raise ValueError(f"K2 needs at least one channel and one column, got {channels} "
                         f"and {width}")
    n = num_displacements(max_displacement, stride)
    cluster, tile_x = _cluster_tile(width, stride)
    most_rows = rows_max(n, stride, cr_height)

    def smem(rows, chan_groups):
        return fwd_smem_bytes(tile_x, n, stride, chan_groups, -(-channels // chan_groups),
                              rows)

    # the widest tile whose cl tile and one displacement row fit 227 KB
    while smem(1, 1) > SMEM_LIMIT and tile_x > cluster:
        tile_x -= cluster
    groups = tile_x // PIX
    if smem(1, 1) > SMEM_LIMIT:
        raise ValueError(f"K2 needs {smem(1, 1)} bytes of shared memory for {channels} "
                         f"channels at md {max_displacement}, stride {stride}, more than "
                         f"{SMEM_LIMIT}")
    if groups > MAX_THREADS:
        raise ValueError(f"K2 needs {groups} threads per block at stride {stride}, more "
                         f"than {MAX_THREADS}")
    # every in-frame row in one stage where two blocks still fit an SM, with
    # as many channel groups as 256 threads and that budget allow; else one
    # row a stage and as many groups as 128 threads and four blocks an SM
    # allow
    if smem(most_rows, 1) <= FWD_SMEM_BYTES:
        rows, budget, threads = most_rows, FWD_SMEM_BYTES, MAX_THREADS
    else:
        rows, budget, threads = 1, max(FWD_ROW_SMEM_BYTES, smem(1, 1)), MIN_THREADS
    chan_groups = next((c for c in range(min(channels, threads // (groups * rows)), 0, -1)
                        if smem(rows, c) <= budget), 1)
    launch = fwd_launch(channels, height, width, max_displacement, stride, tile_x, rows,
                        chan_groups, budget)
    grid = (-(-width // tile_x), height, batch)
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"K2's grid {grid} exceeds 65535 rows or images")
    return tuple(launch.items()) + (("grid", grid),)


def fwd_launch(channels: int, height: int, width: int, max_displacement: int, stride: int,
               tile_x: int, rows_per_stage: int, chan_groups: int,
               budget: int = SMEM_LIMIT) -> dict:
    """K2's launch ints for a chosen tile, rows per stage and channel
    groups (:func:`fwd_plan`'s choice, or another one to time): the
    groups evened out so that none is empty, the skews with the fewest
    bank conflicts that keep the block within ``budget`` bytes,
    ``threads`` and ``smem_bytes``, in the C entry's order."""
    n = num_displacements(max_displacement, stride)
    rows = rows_per_stage
    per_group = -(-channels // chan_groups)
    chan_groups = -(-channels // per_group)  # no group left empty
    steps = range(0, 32, 4) if stride % 4 == 0 else range(32)

    def smem(skew, slot_skew):
        return fwd_smem_bytes(tile_x, n, stride, chan_groups, per_group, rows, skew, slot_skew)

    def best(candidates):
        return min((k for k in candidates if smem(*k) <= max(budget, smem(0, 0))),
                   key=lambda k: (fwd_bank_conflicts(tile_x, n, stride, chan_groups,
                                                     per_group, rows, *k), k))

    skew = best((k, 0) for k in steps)[0]
    slot_skew = best((skew, k) for k in steps)[1] if rows > 1 else 0
    working = tile_x // PIX * rows * chan_groups
    threads = max(MIN_THREADS, -(-working // 32) * 32)
    return {"tile_x": tile_x, "rows_per_stage": rows, "chan_groups": chan_groups,
            "skew": skew, "slot_skew": slot_skew, "threads": threads,
            "smem_bytes": smem(skew, slot_skew)}


def fwd_plan(batch: int, channels: int, height: int, width: int,
             max_displacement: int, stride: int, cr_height: int | None = None) -> dict:
    """K2's launch for these shapes: ``tile_x`` (a multiple of 4 * stride
    covering up to 128 columns, narrower where the cl tile and one cr row
    would not fit 227 KB), ``rows_per_stage`` (every in-frame
    displacement row where the block then still fits FWD_SMEM_BYTES, so
    two blocks share an SM, else one), ``chan_groups`` (the thread groups
    that split the channel sum: as many as 256 threads and that budget
    allow, or with one row a stage 128 threads and FWD_ROW_SMEM_BYTES, so
    four blocks share an SM), ``skew`` and
    ``slot_skew`` (padding of the channel rows and of the stage slots with
    the fewest bank conflicts), ``threads``, ``smem_bytes`` and ``grid``.
    Raises ValueError where even one cluster of columns does not fit, or
    the grid is too large. ``height``: cl's rows (the grid's);
    ``cr_height``: cr's (``height`` by default), which bound a row's
    in-frame displacement rows. Computed once per shape: the wrapper asks
    at every launch."""
    return dict(_fwd_plan(batch, channels, height, width, max_displacement, stride,
                          height if cr_height is None else cr_height))


# The bfloat16 K2, K3 and K4 (csrc/correlation_bf16.cu): a warp owns one
# tile of BF16_TILE_P pixels of one residue class of x mod stride and takes
# the displacements BF16_DISP at a time (K2: a 16 x 24 band product, K3 and
# K4: one k16 step of window columns); a block holds up to BF16_FWD_ROWS
# in-frame displacement rows (K2) or stages BF16_ROWS_PER_STAGE at a time
# (K3, K4), and has at most BF16_MAX_WARPS warps, one a tile; a K3 or K4
# warp accumulates up to BF16_GROUP_BLOCKS blocks of 16 channels. TMA_BOX:
# the most elements a TMA box spans in one dimension.
BF16_TILE_P, BF16_DISP = 16, 9
BF16_FWD_ROWS, BF16_ROWS_PER_STAGE, BF16_GROUP_BLOCKS, BF16_MAX_WARPS = 4, 4, 4, 8
TMA_BOX = 256
# A plan splits its blocks further, where the work allows, until an SM holds
# this many warps of them: a block's phases (copies, MMAs, stores) overlap
# only with other resident blocks'. K3 and K4 stop earlier, as each channel
# chunk stages g again (K4's and K2's numbers timed on the card at the PWC
# levels). BF16_REGS: registers a thread (launch bounds of three 8-warp
# blocks an SM; ptxas allocates 8 at a time, so at most 80).
BF16_FWD_WARPS_PER_SM, BF16_BWD_WARPS_PER_SM, BF16_REGS = 24, 16, 80
FWD_BF16_LAUNCH_KEYS = ("tile_x", "groups", "threads", "smem_bytes")
BWD_BF16_LAUNCH_KEYS = ("tile_x", "chan_blocks", "rows_per_stage", "threads", "smem_bytes")


def stage_pitch(cols: int) -> int:
    """Elements of one staged bfloat16 row of ``cols`` columns: whole
    16-byte units, an odd count of them (``stage_pitch`` in
    csrc/correlation_bf16.cu)."""
    return (-(-cols // 8) | 1) * 8


def _align128(nbytes: int) -> int:
    return -(-nbytes // 128) * 128


def bf16_window_cols(tile_x: int, stride: int, n: int) -> int:
    """Staged columns of one row: the tile and the window that the last
    chunk of BF16_DISP displacements reads, and up to 7 more on the left:
    a row's box starts at the multiple of 8 columns at or left of its
    window (a TMA box starts 16-byte aligned in its row)."""
    return tile_x + stride * (BF16_DISP * -(-n // BF16_DISP) - 1) + 7


def lead8(col: int) -> int:
    """How far frame column ``col`` lies right of the multiple of 8 at or
    left of it: the staged column of a window's first column."""
    return col % 8


def chan_boxes(channels: int) -> tuple[int, int]:
    """(box, count): K2-bf16 stages a row's channels, rounded up to 16, as
    ``count`` TMA boxes of ``box`` channels (a multiple of 8, at most 256)."""
    padded = -(-channels // 16) * 16
    count = -(-padded // TMA_BOX)
    per_box = -(-padded // count)
    return -(-per_box // 8) * 8, count


def fwd_bf16_layout(channels: int, height: int, stride: int, n: int, tile_x: int,
                    groups: int) -> dict:
    """K2-bf16's shared memory, as ``fwd_layout`` in csrc/correlation_bf16.cu:
    the cl tile [chans][cl_pitch] and ``rows`` cr rows [chans][row_pitch]
    of bfloat16, the float32 sums [rows * n][part_pitch] in the rows'
    region afterwards, 128 bytes to align the base."""
    box, count = chan_boxes(channels)
    lay = {"chans": box * count, "cl_pitch": stage_pitch(tile_x),
           "row_pitch": stage_pitch(bf16_window_cols(tile_x, stride, n)),
           "part_pitch": tile_x + 4, "rows": -(-rows_max(n, stride, height) // groups)}
    lay["cl_bytes"] = lay["chans"] * lay["cl_pitch"] * 2
    lay["row_bytes"] = lay["chans"] * lay["row_pitch"] * 2
    lay["total"] = 128 + lay["cl_bytes"] + max(
        lay["rows"] * lay["row_bytes"], _align128(lay["rows"] * n * lay["part_pitch"] * 4))
    return lay


def plane_boxes(planes: int) -> tuple[int, int]:
    """(box, count): K3-bf16 stages the planes of its g tile as ``count``
    TMA boxes of ``box`` planes (a multiple of 8, so that each box starts
    128-byte aligned, at most 256)."""
    count = -(-planes // TMA_BOX)
    per_box = -(-planes // count)
    return -(-per_box // 8) * 8, count


def bwd_cl_bf16_layout(stride: int, n: int, tile_x: int, chan_blocks: int, rows: int,
                       height: int) -> dict:
    """K3-bf16's shared memory, as ``bwd_cl_layout`` in
    csrc/correlation_bf16.cu: the g tile [g_planes][g_pitch] (the n g rows
    of each of the rows_max displacement rows that can lie in the frame,
    over the tile, as :func:`plane_boxes` stages them), then ``rows`` slots
    of the chunk's cr row [chans][pitch], bfloat16; the float32 sums
    [chans][part_pitch] afterwards, 128 bytes to align the base. ``g_box``:
    the planes of one g box."""
    box, count = plane_boxes(rows_max(n, stride, height) * n)
    lay = {"chans": chan_blocks * 16, "pitch": stage_pitch(bf16_window_cols(tile_x, stride, n)),
           "g_pitch": stage_pitch(tile_x), "g_planes": box * count, "g_box": box,
           "part_pitch": tile_x + 4}
    lay["g_bytes"] = _align128(lay["g_planes"] * lay["g_pitch"] * 2)
    lay["row_bytes"] = lay["chans"] * lay["pitch"] * 2
    lay["total"] = 128 + max(lay["g_bytes"] + rows * lay["row_bytes"],
                             _align128(lay["chans"] * lay["part_pitch"] * 4))
    return lay


def bwd_cr_bf16_layout(stride: int, n: int, tile_x: int, chan_blocks: int, rows: int,
                       height: int | None = None) -> dict:
    """K4-bf16's shared memory, as ``bwd_layout`` in csrc/correlation_bf16.cu:
    ``rows`` slots of one displacement row's cl rows [chans][pitch] and n g
    rows [n][pitch] of bfloat16, the float32 sums [chans][part_pitch]
    afterwards, 128 bytes to align the base. ``g_box``: the planes of one
    g box (n). ``height`` does not change it; it is taken so that K4's and
    K3's layouts are called alike."""
    lay = {"chans": chan_blocks * 16, "pitch": stage_pitch(bf16_window_cols(tile_x, stride, n)),
           "g_box": n, "part_pitch": tile_x + 4}
    lay["cl_bytes"] = lay["chans"] * lay["pitch"] * 2
    lay["g_bytes"] = _align128(n * lay["pitch"] * 2)
    lay["slot"] = lay["cl_bytes"] + lay["g_bytes"]
    lay["total"] = 128 + max(rows * lay["slot"],
                             _align128(lay["chans"] * lay["part_pitch"] * 4))
    return lay


def tma_staged(width: int, *pitches: int) -> bool:
    """Whether the bfloat16 K2, K3 and K4 stage rows of these pitches by TMA
    (given 16-byte aligned operands, which the C entries check): a row of
    the frame is whole 16-byte units (W % 8 == 0) and a box spans at most
    TMA_BOX columns."""
    return width % 8 == 0 and max(pitches) <= TMA_BOX


def resident_warps(threads: int, smem_bytes: int) -> int:
    """Warps of blocks of ``threads`` threads and ``smem_bytes`` of shared
    memory that one SM of an H100 holds at once (shared memory, registers
    at BF16_REGS a thread, 2048 threads, 32 blocks)."""
    blocks = min(SMEM_PER_SM // (smem_bytes + 1024), 65536 // (BF16_REGS * threads),
                 2048 // threads, 32)
    return blocks * threads // 32


def _bf16_tile(width: int, stride: int, per_tile: int, what: str) -> tuple[int, int]:
    """(span, tile_x): a class tile of every residue class spans 16 *
    stride columns; the tile is the fewest spans that cover min(width,
    TILE_X), fewer where ``per_tile`` warps a span-sixteenth would exceed
    BF16_MAX_WARPS."""
    span = BF16_TILE_P * stride
    if span // BF16_TILE_P * per_tile > BF16_MAX_WARPS:
        raise ValueError(f"{what} needs {span // BF16_TILE_P * per_tile} warps (threads "
                         f"{32 * span // BF16_TILE_P * per_tile}) a block at stride {stride}, "
                         f"more than {BF16_MAX_WARPS}")
    tile_x = span * -(-min(width, TILE_X) // span)
    while tile_x // BF16_TILE_P * per_tile > BF16_MAX_WARPS:
        tile_x -= span
    return span, tile_x


@functools.lru_cache(maxsize=None)
def _fwd_plan_bf16(batch: int, channels: int, height: int, width: int, max_displacement: int,
                   stride: int, num_sms: int, cr_height: int) -> tuple:
    if min(channels, width) < 1:
        raise ValueError(f"K2-bf16 needs at least one channel and one column, got {channels} "
                         f"and {width}")
    n = num_displacements(max_displacement, stride)
    chunks = -(-n // BF16_DISP)
    span, tile_x = _bf16_tile(width, stride, chunks, "K2-bf16")
    most_rows = rows_max(n, stride, cr_height)

    def groups_for(tile):
        image_rows = -(-width // tile) * height * batch
        return min(n, max(-(-most_rows // BF16_FWD_ROWS), -(-2 * num_sms // image_rows)))

    groups = groups_for(tile_x)
    while True:
        lay = fwd_bf16_layout(channels, cr_height, stride, n, tile_x, groups)
        if lay["total"] <= SMEM_LIMIT:
            break
        if tile_x > span:
            tile_x -= span
            groups = max(groups, groups_for(tile_x))
        elif lay["rows"] > 1:
            groups += 1
        else:
            raise ValueError(f"K2-bf16 needs {lay['total']} bytes of shared memory for "
                             f"{channels} channels at md {max_displacement}, stride {stride}, "
                             f"more than {SMEM_LIMIT}")
    threads = 32 * tile_x // BF16_TILE_P * chunks
    while lay["rows"] > 1 and resident_warps(threads, lay["total"]) < BF16_FWD_WARPS_PER_SM:
        groups += 1
        lay = fwd_bf16_layout(channels, cr_height, stride, n, tile_x, groups)
    grid = (-(-width // tile_x), height, batch * groups)
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"K2-bf16's grid {grid} exceeds 65535 rows or images x groups")
    return (("tile_x", tile_x), ("groups", groups), ("threads", threads),
            ("smem_bytes", lay["total"]),
            ("grid", grid), ("rows_per_group", lay["rows"]),
            ("tma", tma_staged(width, lay["cl_pitch"], lay["row_pitch"])))


def fwd_plan_bf16(batch: int, channels: int, height: int, width: int, max_displacement: int,
                  stride: int, num_sms: int = H100_SMS, cr_height: int | None = None) -> dict:
    """K2-bf16's launch for these shapes: ``tile_x`` (a multiple of 16 *
    stride covering up to 128 columns, one warp per class tile and chunk
    of 9 displacements, at most 8), ``groups`` (the displacement rows'
    groups over the grid: enough that a block holds at most 4 in-frame
    rows, the grid has two blocks per SM and, where the rows allow, an SM
    holds BF16_FWD_WARPS_PER_SM warps of them), ``threads``,
    ``smem_bytes`` and ``grid``; ``rows_per_group`` and ``tma`` (the rows
    staged by TMA, given aligned operands) for the record. Narrows the
    tile, then the groups, until 227 KB fit; raises ValueError where even
    one class tile and one row do not, where one class tile needs more
    than 8 warps, or the grid is too large. ``height``: cl's rows (the
    grid's); ``cr_height``: cr's (``height`` by default), which set the
    layout's rows (the C entry computes it from them)."""
    return dict(_fwd_plan_bf16(batch, channels, height, width, max_displacement, stride,
                               num_sms, height if cr_height is None else cr_height))


@functools.lru_cache(maxsize=None)
def _bwd_plan_bf16(kernel: str, kernel_layout, rows_first: bool, batch: int, channels: int,
                   height: int, width: int, max_displacement: int, stride: int,
                   num_sms: int, read_rows: int) -> tuple:
    """The plan of ``kernel`` (K3-bf16 or K4-bf16, named in errors): one
    search over its layout ``kernel_layout`` (:func:`bwd_cl_bf16_layout` or
    :func:`bwd_cr_bf16_layout`), as both take the same launch. Where an SM
    would hold too few warps, it stages fewer rows at a time before it
    splits the channels further where ``rows_first``, else only splits the
    channels. ``height``: the grid's rows; ``read_rows``: those of the map
    read at the displaced rows, which bound a row's in-frame displacement
    rows (and K3's layout)."""
    n = num_displacements(max_displacement, stride)

    def layout(tile, blocks, stage_rows):
        return kernel_layout(stride, n, tile, blocks, stage_rows, read_rows)

    span, tile_x = _bf16_tile(width, stride, 1, kernel)
    all_blocks = -(-channels // 16)
    rows = min(rows_max(n, stride, read_rows), BF16_ROWS_PER_STAGE)

    def blocks_for(tile):
        most = BF16_GROUP_BLOCKS * (BF16_MAX_WARPS // (tile // BF16_TILE_P))
        cbb = min(all_blocks, most, TMA_BOX // 16)
        image_rows = -(-width // tile) * height * batch
        while cbb > 1 and image_rows * -(-all_blocks // cbb) < 2 * num_sms:
            cbb -= 1
        return -(-all_blocks // -(-all_blocks // cbb))  # the chunks evened out

    chan_blocks = blocks_for(tile_x)
    while layout(tile_x, chan_blocks, rows)["total"] > SMEM_LIMIT:
        if rows > 1:
            rows -= 1
        elif chan_blocks > 1:
            chan_blocks -= 1
        elif tile_x > span:
            tile_x -= span
        else:
            total = layout(tile_x, chan_blocks, rows)["total"]
            raise ValueError(f"{kernel} needs {total} bytes of shared memory at md "
                             f"{max_displacement}, stride {stride}, more than {SMEM_LIMIT}")
    lay = layout(tile_x, chan_blocks, rows)
    warps = tile_x // BF16_TILE_P * -(-chan_blocks // BF16_GROUP_BLOCKS)
    while resident_warps(32 * warps, lay["total"]) < BF16_BWD_WARPS_PER_SM:
        if rows_first and rows > 1:
            rows -= 1
        elif chan_blocks > 1:
            chan_blocks = -(-all_blocks // (-(-all_blocks // (chan_blocks - 1))))  # evened out
        else:
            break
        lay = layout(tile_x, chan_blocks, rows)
        warps = tile_x // BF16_TILE_P * -(-chan_blocks // BF16_GROUP_BLOCKS)
    grid = (-(-width // tile_x), height, batch * -(-all_blocks // chan_blocks))
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"{kernel}'s grid {grid} exceeds 65535 rows or chunks")
    tma = tma_staged(width, lay["pitch"]) and lay["g_box"] <= TMA_BOX
    return (("tile_x", tile_x), ("chan_blocks", chan_blocks), ("rows_per_stage", rows),
            ("threads", 32 * warps), ("smem_bytes", lay["total"]), ("grid", grid),
            ("tma", tma))


def bwd_cl_plan_bf16(batch: int, channels: int, height: int, width: int,
                     max_displacement: int, stride: int, num_sms: int = H100_SMS,
                     cr_height: int | None = None) -> dict:
    """K3-bf16's launch for these shapes, chosen as :func:`bwd_cr_plan_bf16`
    chooses K4-bf16's, for K3's layout (:func:`bwd_cl_bf16_layout`), but
    with fewer rows a stage before fewer channels a block where an SM would
    hold too few warps. Each channel chunk stages the block's g tile again,
    the n g rows of each in-frame displacement row over the tile, 2 * n *
    tile_x bytes a row: at the flow stage's levels 4-6, where the channels
    are split into 2-5 chunks so that the grid has two blocks an SM,
    0.2-0.6 KB a row against 3.8-5.4 KB of the chunk's cr row; the chunks
    after the first find g in L2. Levels 2 and 3 take all channels in one
    chunk; at level 3 fewer rows a stage let the grid's 512 one-chunk
    blocks be resident at once (``tools/corr_sweep.py``). Raises as
    :func:`bwd_cr_plan_bf16` does. ``height``: the rows of g and cl (the
    grid's); ``cr_height``: cr's, which it reads (``height`` by
    default)."""
    return dict(_bwd_plan_bf16("K3-bf16", bwd_cl_bf16_layout, True, batch, channels, height, width,
                               max_displacement, stride, num_sms,
                               height if cr_height is None else cr_height))


def bwd_cr_plan_bf16(batch: int, channels: int, height: int, width: int,
                     max_displacement: int, stride: int, num_sms: int = H100_SMS,
                     cr_height: int | None = None) -> dict:
    """K4-bf16's launch for these shapes: ``tile_x`` (a multiple of 16 *
    stride covering up to 128 columns), ``chan_blocks`` (16-channel blocks
    a CUDA block: as many as 8 warps of 4 blocks allow, fewer, evened out,
    where the grid would have under two blocks per SM or an SM would hold
    under BF16_BWD_WARPS_PER_SM warps of them), ``rows_per_stage``
    (in-frame displacement rows a stage holds, at most 4), ``threads``
    (a warp per class tile and group of 4 blocks), ``smem_bytes`` and
    ``grid``; ``tma`` for the record. Narrows the stage, the channels and
    the tile until 227 KB fit; raises ValueError where one row of one
    block does not, where one class tile needs more than 8 warps, or the
    grid is too large. ``height``: the rows of g and cl, which it reads;
    ``cr_height``: dcr's (the grid's; ``height`` by default)."""
    return dict(_bwd_plan_bf16("K4-bf16", bwd_cr_bf16_layout, False, batch, channels,
                               height if cr_height is None else cr_height, width,
                               max_displacement, stride, num_sms, height))


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(feats, other, max_displacement, stride, grad_out=None, dtype=None, row_offset=0,
           grad_rows=None):
    """Raise unless the kernels take these: two feature maps [B,C,*,W] that
    agree but in their rows (a band's cl and the rows of cr it reads),
    ``grad_out`` [B,n^2,``grad_rows``,W] or None, an int md >= 0, an int
    stride >= 1 and an int ``row_offset``; all float32 or all bfloat16
    (``dtype`` where given), contiguous, on one CUDA device."""
    dtype = feats.dtype if dtype is None else dtype
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"the correlation kernels take float32 or bfloat16, got {dtype}")
    if not (isinstance(max_displacement, int) and max_displacement >= 0):
        raise ValueError(f"max_displacement must be an int >= 0, got {max_displacement!r}")
    if not (isinstance(stride, int) and stride >= 1):
        raise ValueError(f"stride must be an int >= 1, got {stride!r}")
    if not isinstance(row_offset, int) or abs(row_offset) >= 2 ** 30:
        raise ValueError(f"row_offset must be an int, got {row_offset!r}")
    if feats.dim() != 4 or other.dim() != 4 or (
            other.shape[:2] + other.shape[3:]) != (feats.shape[:2] + feats.shape[3:]):
        raise ValueError(f"feature maps must be two [B,C,H,W] of one shape but their rows, got "
                         f"{tuple(feats.shape)} and {tuple(other.shape)}")
    tensors = [("features", feats), ("features", other)]
    if grad_out is not None:
        n = num_displacements(max_displacement, stride)
        batch, _, _, width = feats.shape
        if tuple(grad_out.shape) != (batch, n * n, grad_rows, width):
            raise ValueError(f"grad_out must be {(batch, n * n, grad_rows, width)}, "
                             f"got {tuple(grad_out.shape)}")
        tensors.append(("grad_out", grad_out))
    for name, t in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _CorrEntry:
    """One C entry of the correlation library for operands of ``dtype``,
    built at first use (``library_path``); ``source`` is the kernel's file.
    ``launches`` counts the launches this wrapper made; ``launch_keys`` are
    its plan's launch ints, in the entry's order."""

    launch_keys: tuple = ()

    def __init__(self, name: str, entry: str, dtype: torch.dtype, source: str = SOURCE):
        self.name = name
        self.dtype = dtype
        self.source = source
        self.launches = 0
        self.build_log = ""
        self.library_path = None
        self._entry = entry
        self._fn = None

    def build(self):
        """Compile (or reuse) and load the library; return the C entry."""
        if self._fn is None:
            lib, self.build_log = load_library("correlation", LIBRARY_SOURCES)
            self.library_path = lib._name
            fn = getattr(lib, self._entry)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (8 + len(self.launch_keys))
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, first, second, out, feats_shape, max_displacement, stride, plan,
                cr_height=None, row_offset=0):
        """Call the entry with the three pointers, the shape of cl (and g),
        cr's rows (``cr_height``, cl's by default) and ``row_offset``, md,
        stride, the ``plan``'s launch ints and the current stream; raise on
        a CUDA error."""
        fn = self.build()
        batch, channels, height, width = feats_shape
        cr_height = height if cr_height is None else cr_height
        launch = tuple(plan[k] for k in self.launch_keys)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = fn(first.data_ptr(), second.data_ptr(), out.data_ptr(),
                     batch, channels, height, width, cr_height, row_offset, max_displacement,
                     stride, *launch, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {err}")
        self.launches += 1
        return out


class CorrKernel(_CorrEntry):
    """Launches K2 (its float32 entry, tiled by :func:`fwd_plan`)."""

    launch_keys = FWD_LAUNCH_KEYS

    def plan(self, shape, max_displacement, stride, device, cr_height=None) -> dict:
        """The launch plan for cl of ``shape`` and cr of ``cr_height`` rows
        (cl's by default) on ``device``."""
        return fwd_plan(*shape, max_displacement, stride, cr_height)

    def __call__(self, cl: torch.Tensor, cr: torch.Tensor, max_displacement: int,
                 stride: int, row_offset: int = 0) -> torch.Tensor:
        """:param cl, cr: [B,C,h,W] and [B,C,H_r,W] in the kernel's dtype,
        contiguous, on one CUDA device; ``row_offset``: cl's first global row
        minus cr's (0 with h = H_r: the whole frame). :return: [B,n^2,h,W].
        Differentiable calls go through :class:`Correlation`."""
        _check(cl, cr, max_displacement, stride, dtype=self.dtype, row_offset=row_offset)
        if torch.is_grad_enabled() and (cl.requires_grad or cr.requires_grad):
            raise ValueError("K2 called directly drops the gradient: use "
                             "Correlation.apply (ops.correlation.correlation_cost)")
        n = num_displacements(max_displacement, stride)
        batch, _, height, width = cl.shape
        out = torch.empty((batch, n * n, height, width), dtype=cl.dtype, device=cl.device)
        if out.numel() == 0:
            return out
        if cr.numel() == 0:  # no row of cr: every term lies outside the frame
            return out.zero_()
        plan = self.plan(cl.shape, max_displacement, stride, cl.device, cr.shape[2])
        return self.launch(cl, cr, out, max_displacement, stride, plan, row_offset)

    def launch(self, cl, cr, out, max_displacement, stride, plan, row_offset=0):
        """Launch with ``plan`` (the plan's keys, or for the float32 K2
        :func:`fwd_launch`'s) on checked inputs and ``out``."""
        return self._launch(cl, cr, out, cl.shape, max_displacement, stride, plan, cr.shape[2],
                            row_offset)


class CorrKernelBf16(CorrKernel):
    """Launches K2-bf16 (``csrc/correlation_bf16.cu``), tiled by
    :func:`fwd_plan_bf16`."""

    launch_keys = FWD_BF16_LAUNCH_KEYS

    def plan(self, shape, max_displacement, stride, device, cr_height=None) -> dict:
        return fwd_plan_bf16(*shape, max_displacement, stride, _num_sms(device.index or 0),
                             cr_height)


class CorrGradKernel(_CorrEntry):
    """Launches K3 (the gradient of the left features, from the right
    ones) or K4 (``dcr``: the gradient of the right features, from the
    left ones), both tiled by :func:`bwd_plan`, for operands of
    ``dtype``."""

    launch_keys = BWD_LAUNCH_KEYS

    def __init__(self, name: str, entry: str, dtype: torch.dtype, source: str = SOURCE,
                 dcr: bool = False):
        super().__init__(name, entry, dtype, source)
        self.dcr = dcr

    def plan(self, shape, max_displacement, stride, device, cr_height=None) -> dict:
        """The launch plan for g and cl of ``shape`` and cr of
        ``cr_height`` rows (cl's by default) on ``device``."""
        return bwd_plan(*shape, max_displacement, stride, _num_sms(device.index or 0),
                        cr_height=cr_height)

    def __call__(self, grad_out: torch.Tensor, feats: torch.Tensor, max_displacement: int,
                 stride: int, row_offset: int = 0, cr_height: int | None = None) -> torch.Tensor:
        """:param grad_out: [B,n^2,h,W], the cotangent of K2's output;
        :param feats: cr [B,C,H_r,W] for K3, cl [B,C,h,W] for K4;
        ``row_offset`` as for K2; ``cr_height``: K4's H_r (h by default).
        :return: dcl [B,C,h,W] (K3) or dcr [B,C,H_r,W] (K4)."""
        grad_out = grad_out.contiguous()
        batch, channels, _, width = feats.shape
        height = grad_out.shape[2] if grad_out.dim() == 4 else -1
        if not self.dcr:
            cr_height = feats.shape[2]
        elif cr_height is None:
            cr_height = height
        _check(feats, feats, max_displacement, stride, grad_out, dtype=self.dtype,
               row_offset=row_offset, grad_rows=feats.shape[2] if self.dcr else height)
        if not (isinstance(cr_height, int) and cr_height >= 0):
            raise ValueError(f"cr_height must be an int >= 0, got {cr_height!r}")
        out = torch.empty((batch, channels, cr_height if self.dcr else height, width),
                          dtype=feats.dtype, device=feats.device)
        if out.numel() == 0:
            return out
        if feats.numel() == 0:  # no row to read: every term lies outside the frame
            return out.zero_()
        shape = (batch, channels, height, width)
        plan = self.plan(shape, max_displacement, stride, feats.device, cr_height)
        return self.launch(grad_out, feats, out, max_displacement, stride, plan, row_offset,
                           cr_height)

    def launch(self, grad_out, feats, out, max_displacement, stride, plan, row_offset=0,
               cr_height=None):
        """Launch with ``plan`` (the plan's keys) on checked inputs and
        ``out`` (``cr_height``: K4's; K3 takes cr's rows)."""
        height = grad_out.shape[2]
        if not self.dcr:
            cr_height = feats.shape[2]
        return self._launch(grad_out, feats, out, (feats.shape[0], feats.shape[1], height,
                                                   feats.shape[3]),
                            max_displacement, stride, plan, cr_height, row_offset)


class CorrGradKernelBf16(CorrGradKernel):
    """Launches K3-bf16 or K4-bf16 (``csrc/correlation_bf16.cu``), tiled by
    ``plan_fn`` (:func:`bwd_cl_plan_bf16` or :func:`bwd_cr_plan_bf16`)."""

    launch_keys = BWD_BF16_LAUNCH_KEYS

    def __init__(self, name: str, entry: str, plan_fn, dcr: bool = False):
        super().__init__(name, entry, torch.bfloat16, BF16_SOURCE, dcr)
        self._plan_fn = plan_fn

    def plan(self, shape, max_displacement, stride, device, cr_height=None) -> dict:
        return self._plan_fn(*shape, max_displacement, stride, _num_sms(device.index or 0),
                             cr_height)


K2 = CorrKernel("K2", "xpt_corr_fwd", torch.float32)
K3 = CorrGradKernel("K3", "xpt_corr_bwd_cl", torch.float32)
K4 = CorrGradKernel("K4", "xpt_corr_bwd_cr", torch.float32, dcr=True)
K2_BF16 = CorrKernelBf16("K2-bf16", "xpt_corr_fwd_bf16", torch.bfloat16, BF16_SOURCE)
K3_BF16 = CorrGradKernelBf16("K3-bf16", "xpt_corr_bwd_cl_bf16", bwd_cl_plan_bf16)
K4_BF16 = CorrGradKernelBf16("K4-bf16", "xpt_corr_bwd_cr_bf16", bwd_cr_plan_bf16, dcr=True)


def kernels_for(dtype: torch.dtype) -> tuple:
    """(K2, K3, K4) for operands of ``dtype`` (looked up at each call)."""
    if dtype == torch.float32:
        return K2, K3, K4
    if dtype == torch.bfloat16:
        return K2_BF16, K3_BF16, K4_BF16
    raise ValueError(f"the correlation kernels take float32 or bfloat16, got {dtype}")


@torch.library.custom_op("xpt_mde::correlation_cost", mutates_args=())
def correlation_cost_op(cl: torch.Tensor, cr: torch.Tensor, max_displacement: int,
                        stride: int, row_offset: int = 0) -> torch.Tensor:
    """K2, or K2-bf16 on bfloat16 operands, as the registered operator
    ``torch.ops.xpt_mde.correlation_cost``: ``torch.export`` records it in
    a graph (a ctypes launch cannot be traced), and a loaded artifact calls
    it, so its launches count as any other's. Forward only: the gradients
    are :class:`Correlation`'s. ``row_offset`` (0 by default, the whole
    frame; an artifact's calls leave it out): a band's, as K2 takes it.
    Registered when this module is imported; nothing is built until the
    first call."""
    with torch.no_grad():
        return kernels_for(cl.dtype)[0](cl, cr, max_displacement, stride, row_offset)


@correlation_cost_op.register_fake
def _correlation_cost_shape(cl, cr, max_displacement, stride, row_offset=0):
    n = num_displacements(max_displacement, stride)
    return cl.new_empty((cl.shape[0], n * n, cl.shape[2], cl.shape[3]))


class Correlation(torch.autograd.Function):
    """K2 forward (through :func:`correlation_cost_op`); K3 and K4
    backward, each only for an input that needs its gradient: the float32
    kernels on float32 operands, the bfloat16 ones on bfloat16 operands;
    other or mixed dtypes raise. ``apply(cl, cr, md, stride,
    row_offset)``: cl a band of h rows, cr its H_r rows (K4's dcr covers
    them)."""

    @staticmethod
    def forward(ctx, cl, cr, max_displacement, stride, row_offset=0):
        if cr.dtype != cl.dtype:
            raise ValueError(f"the correlation kernels take two feature maps of one dtype, "
                             f"got {cl.dtype} and {cr.dtype}")
        ctx.save_for_backward(cl, cr)
        ctx.md_stride = (max_displacement, stride, row_offset)
        return torch.ops.xpt_mde.correlation_cost(cl, cr, max_displacement, stride, row_offset)

    @staticmethod
    def backward(ctx, grad_out):
        cl, cr = ctx.saved_tensors
        md, stride, row_offset = ctx.md_stride
        _, k3, k4 = kernels_for(cl.dtype)
        dcl = dcr = None
        if ctx.needs_input_grad[0]:
            dcl = k3(grad_out, cr, md, stride, row_offset)
        if ctx.needs_input_grad[1]:
            dcr = k4(grad_out, cl, md, stride, row_offset, cr.shape[2])
        return dcl, dcr, None, None, None
