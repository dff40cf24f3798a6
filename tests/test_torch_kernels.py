"""Kernels K1 and K1-bwd (``ops/kernels/warp.py`` + ``csrc/warp.cu``) and
K2, K3 and K4 (``ops/kernels/correlation.py`` + ``csrc/correlation.cu``)
against their plain PyTorch versions, their launch plans, and the
launches of the rigid and flow train steps.

This file imports torch and numpy only, so it also runs on a GPU machine
without JAX. Tests marked ``gpu`` need a CUDA card and skip without one;
run them there with

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest.py configures JAX). Tolerance
1e-5 absolute for K1 and K1-bwd: each kernel and its plain version form
the same float32 products; only FMA contraction differs, a few ulp of
values in [-1, 1] (K1) or of |du|, |dv| <= 6 (K1-bwd: 3 channels,
|g| <= 1, |D| <= 2). K2, K3 and K4: 1e-5 of the largest plain value, as
they sum the same products in another order over up to 196 channels or
81 displacements. Their bfloat16 forms: one bfloat16 ulp of the plain
value, plus 1e-6 of the largest value for a sum that cancels, as both
round one float32 sum once (``chip_smoke.bf16_ulp_excess``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from xpt_mde_tpu_torch.config import FLOW_NET, SCALE_WEIGHT_T1
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.losses.photometric import photometric_loss_ssim
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
from xpt_mde_tpu_torch.models.layers import avg_pool_same_excluding_pad
from xpt_mde_tpu_torch.ops import correlation as corr
from xpt_mde_tpu_torch.ops.kernels import build
from xpt_mde_tpu_torch.ops.kernels import correlation as kcorr
from xpt_mde_tpu_torch.ops.kernels import warp as k1
from xpt_mde_tpu_torch.ops.warp import (bilinear_sample, bilinear_sample_plain,
                                        warp_coord_grad_plain)
from xpt_mde_tpu_torch.training import (make_eval_step, make_predict_step, make_train_step,
                                        optimizer_factory)
from xpt_mde_tpu_torch.utils.precision import full_f32

HEADLINE = [(128, 512), (64, 256), (32, 128), (16, 64)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    with full_f32():
        yield torch.device("cuda")


def _case(batch, numsrc, height, width, seed, rows=2, device="cpu", channels=3):
    """Coords over in-frame, out-of-frame and border-exact positions and
    a mask with ~20% zeros."""
    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (batch, numsrc, height, width, channels)).astype(np.float32)
    u = rng.uniform(-4, width + 4, (batch, numsrc, 1, height * width))
    v = rng.uniform(-4, height + 4, (batch, numsrc, 1, height * width))
    coords = [u, v] + ([np.ones_like(u)] if rows == 3 else [])
    coords = np.concatenate(coords, axis=2).astype(np.float32)
    coords[:, :, 0, :6] = [0.0, width - 1.0, 0.0, width - 2.0, -1e-6, 3.5]
    coords[:, :, 1, :6] = [0.0, 0.0, height - 1.0, height - 2.0, 1.0, -0.5]
    mask = (rng.rand(batch, height, width, 1) > 0.2).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (image, coords, mask)]


def test_k1_checks_its_inputs_before_launching():
    image, coords, mask = _case(1, 2, 4, 8, seed=0)
    before = k1.K1.launches
    with pytest.raises(ValueError, match="CUDA"):
        k1.K1(image, coords, mask)
    with pytest.raises(ValueError, match="coords"):
        k1.K1(image, coords[:, :, :1], mask)
    with pytest.raises(ValueError, match="coords"):
        k1.K1(image, coords[:, :1], mask)
    with pytest.raises(ValueError, match="valid_mask"):
        k1.K1(image, coords, mask[:, :2])
    with pytest.raises(ValueError, match="image"):
        k1.K1(image[0], coords, mask)
    assert k1.K1.launches == before


def test_k1_bwd_checks_its_inputs_before_launching():
    image, coords, mask = _case(1, 2, 4, 8, seed=0)
    before = k1.K1_BWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        k1.K1_BWD(image, coords, mask, torch.zeros_like(image))
    with pytest.raises(ValueError, match="grad_out"):
        k1.K1_BWD(image, coords, mask, image[:, :1])
    with pytest.raises(ValueError, match="coords"):
        k1.K1_BWD(image, coords[:, :, :1], mask, torch.zeros_like(image))
    assert k1.K1_BWD.launches == before


@pytest.mark.parametrize("height,width,threads", [(128, 512, 256), (64, 256, 256),
                                                  (32, 128, 64), (16, 64, 64)])
def test_k1_block_size_fills_the_card(height, width, threads):
    """K1's block shrinks with the plane so that the headline scales
    (32 planes) give two blocks per SM of an H100, or the 64-thread
    floor."""
    hw = height * width
    assert k1.fwd_threads(32, hw, 132) == threads
    blocks = -(-hw // (threads // 32 * k1.WARP_PIXELS)) * 32
    assert blocks >= 2 * 132 or threads == 64


@pytest.mark.parametrize("height,width,threads", [(128, 512, 256), (64, 256, 64),
                                                  (32, 128, 64), (16, 64, 64)])
def test_k1_block_size_at_the_cross_synthesis_shape(height, width, threads):
    """The stereo cross-synthesis warps one source per sample: 8 planes at
    batch 8. The finest scale still gives two 256-thread blocks per SM;
    the coarser ones take the 64-thread floor, whose grid covers each
    plane whole."""
    hw = height * width
    assert k1.fwd_threads(8, hw, 132) == threads
    per_block = threads // 32 * k1.WARP_PIXELS
    blocks = -(-hw // per_block) * 8
    assert blocks >= 2 * 132 or threads == 64
    assert blocks * per_block >= 8 * hw


@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
def test_k3_plan_fits_at_pwc_levels(level):
    """K3's tiling at the flow stage's shapes: one block per image row
    and channel chunk, at least two blocks per SM of an H100, 227 KB at
    most, tiles that cover the row, at most 2-way bank conflicts, and
    one stage for all displacement rows where it fits."""
    md, stride = level_displacement(level)
    chans, height, width = ENCODER_CHANNELS[level - 1], 128 >> level, 512 >> level
    plan = kcorr.bwd_plan(32, chans, height, width, md, stride)
    n = kcorr.num_displacements(md, stride)
    groups = plan["tile_x"] // kcorr.PIX
    chunks = plan["grid"][2] // 32
    assert plan["tile_x"] % (kcorr.PIX * stride) == 0
    assert plan["tile_x"] >= width and plan["grid"] == (1, height, 32 * chunks)
    assert height * 32 * chunks >= 2 * kcorr.H100_SMS
    assert chunks * plan["chan_blocks"] * kcorr.BWD_CHAN >= chans
    assert max(groups * plan["chan_blocks"], kcorr.MIN_THREADS) <= plan["threads"]
    assert plan["threads"] <= kcorr.MAX_THREADS
    assert plan["threads"] % 32 == 0
    assert plan["smem_bytes"] == kcorr.bwd_smem_bytes(
        plan["tile_x"], plan["chan_blocks"], n, stride, plan["cb_skew"],
        plan["rows_per_stage"], plan["buffers"])
    assert plan["smem_bytes"] <= kcorr.SMEM_LIMIT
    # levels 4-6 stage every in-frame displacement row at once; 2-3 one a
    # stage, double-buffered
    rows_max = kcorr.rows_max(n, stride, height)
    assert (plan["rows_per_stage"], plan["buffers"]) == ((rows_max, 1) if level >= 4 else (1, 2))
    assert kcorr.bwd_bank_conflicts(plan["tile_x"], plan["chan_blocks"], n, stride,
                                       plan["cb_skew"]) <= 2


@pytest.mark.parametrize("shape,md,stride,num_sms,tiles", [
    ((1, 5, 5, 7), 4, 3, 1, (1, 1)),       # a stride that does not divide md
    ((2, 8, 3, 130), 0, 1, 1, (2, 1)),     # md 0; two x tiles
    ((1, 300, 4, 128), 4, 1, 1, (1, 5)),   # five channel chunks of 64
    ((1, 512, 4, 64), 64, 1, 1, (1, 6)),   # 12 of 16 channel blocks, to fit 227 KB
    ((1, 300, 4, 128), 4, 1, 132, (1, 38)),  # one channel block each, to fill 132 SMs
])
def test_k3_plan_at_edge_shapes(shape, md, stride, num_sms, tiles):
    plan = kcorr.bwd_plan(*shape, md, stride, num_sms)
    batch, chans, height, width = shape
    assert (plan["grid"][0], plan["grid"][2] // batch) == tiles
    assert plan["grid"][0] * plan["tile_x"] >= width
    assert plan["grid"][2] // batch * plan["chan_blocks"] * kcorr.BWD_CHAN >= chans
    assert plan["smem_bytes"] <= kcorr.SMEM_LIMIT


def test_k3_plan_refuses_what_cannot_fit():
    """Too many displacements for 227 KB, or a stride whose pixel cluster
    needs more than 256 threads: the plan raises, and so the wrapper
    does before it launches."""
    with pytest.raises(ValueError, match="shared memory"):
        kcorr.bwd_plan(1, 8, 4, 64, 2000, 1)
    with pytest.raises(ValueError, match="threads"):
        kcorr.bwd_plan(1, 8, 4, 64, 300, 300)


@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
def test_k2_plan_fits_at_pwc_levels(level):
    """K2's tiling at the flow stage's shapes: one block per image row
    and tile covering it, at most 256 threads with every channel group
    non-empty, at most 2-way bank conflicts; levels 4-6 stage every
    in-frame displacement row at once with two blocks per SM of an H100,
    levels 2-3 one row a stage with four."""
    md, stride = level_displacement(level)
    chans, height, width = ENCODER_CHANNELS[level - 1], 128 >> level, 512 >> level
    plan = kcorr.fwd_plan(32, chans, height, width, md, stride)
    n = kcorr.num_displacements(md, stride)
    per_group = -(-chans // plan["chan_groups"])
    assert plan["tile_x"] % (kcorr.PIX * stride) == 0
    assert plan["tile_x"] >= width and plan["grid"] == (1, height, 32)
    assert (plan["chan_groups"] - 1) * per_group < chans <= plan["chan_groups"] * per_group
    working = plan["tile_x"] // kcorr.PIX * plan["rows_per_stage"] * plan["chan_groups"]
    assert max(working, kcorr.MIN_THREADS) <= plan["threads"] <= kcorr.MAX_THREADS
    assert plan["threads"] % 32 == 0
    assert plan["smem_bytes"] == kcorr.fwd_smem_bytes(
        plan["tile_x"], n, stride, plan["chan_groups"], per_group, plan["rows_per_stage"],
        plan["skew"], plan["slot_skew"])
    rows, per_sm = (kcorr.rows_max(n, stride, height), 2) if level >= 4 else (1, 4)
    assert plan["rows_per_stage"] == rows
    assert per_sm * (plan["smem_bytes"] + 1024) <= kcorr.SMEM_PER_SM
    assert kcorr.fwd_bank_conflicts(plan["tile_x"], n, stride, plan["chan_groups"], per_group,
                                    plan["rows_per_stage"], plan["skew"],
                                    plan["slot_skew"]) <= 2


@pytest.mark.parametrize("shape,md,stride,tiles,rows", [
    ((1, 5, 5, 7), 4, 3, 1, 2),         # a stride that does not divide md
    ((2, 8, 3, 130), 0, 1, 2, 1),       # md 0; two x tiles
    ((1, 300, 4, 128), 4, 1, 2, 1),     # narrower tiles, to fit 227 KB
    ((1, 2000, 4, 64), 8, 1, 16, 1),    # the narrowest tile, one cluster
    ((1, 13, 3, 4), 4, 1, 1, 3),        # H and W below 2 * md + 1
    ((1, 12, 6, 20), 8, 1, 1, 6),       # n = 17: displacements 9 at a time
])
def test_k2_plan_at_edge_shapes(shape, md, stride, tiles, rows):
    plan = kcorr.fwd_plan(*shape, md, stride)
    batch, chans, height, width = shape
    assert plan["grid"] == (tiles, height, batch)
    assert plan["grid"][0] * plan["tile_x"] >= width
    assert plan["rows_per_stage"] == rows
    assert plan["chan_groups"] * -(-chans // plan["chan_groups"]) >= chans
    assert plan["smem_bytes"] <= kcorr.SMEM_LIMIT


def test_k2_plan_refuses_what_cannot_fit():
    """A cl tile and one cr row over 227 KB even at the narrowest tile, a
    stride whose pixel cluster needs more than 256 threads, or no channel:
    the plan raises, and so the wrapper does before it launches."""
    with pytest.raises(ValueError, match="shared memory"):
        kcorr.fwd_plan(1, 512, 4, 64, 64, 1)
    with pytest.raises(ValueError, match="shared memory"):
        kcorr.fwd_plan(1, 4000, 4, 64, 8, 1)
    with pytest.raises(ValueError, match="threads"):
        kcorr.fwd_plan(1, 8, 4, 64, 300, 300)
    with pytest.raises(ValueError, match="channel"):
        kcorr.fwd_plan(1, 0, 4, 64, 4, 1)


@pytest.mark.parametrize("stride", [1, 2, 3, 4, 8])
def test_pixel_groups_tile_the_row(stride):
    """The threads' pixels x0 + p * stride (p < 4) over the tile's groups
    cover each column of the tile once."""
    tile_x = kcorr.PIX * stride * 3
    cols = sorted(kcorr._group_x0(gi, stride) + p * stride
                  for gi in range(tile_x // kcorr.PIX) for p in range(kcorr.PIX))
    assert cols == list(range(tile_x))


def _emulate_k2(cl, cr, md, stride, tile_x):
    """K2's staging in numpy, block by block (csrc/correlation.cu::
    corr_fwd_kernel): the cl tile, each in-frame displacement row's cr row
    from column xt - md with the frame's outside zero, zero planes for the
    other rows."""
    batch, chans, height, width = cl.shape
    n = kcorr.num_displacements(md, stride)
    row_len = tile_x + (n - 1) * stride
    out = np.full((batch, n * n, height, width), np.nan, np.float32)
    for b in range(batch):
        for y in range(height):
            i_lo = -(-(md - y) // stride) if md > y else 0
            i_hi = min(n - 1, (height - 1 - y + md) // stride)
            for xt in range(0, width, tile_x):
                x_hi = min(tile_x, width - xt)
                l_lo, l_hi = max(0, md - xt), min(row_len, width - xt + md)
                tile = np.zeros((chans, tile_x), np.float32)
                tile[:, :x_hi] = cl[b, :, y, xt:xt + x_hi]
                out[b, :, y, xt:xt + x_hi] = 0
                for i in range(i_lo, i_hi + 1):
                    win = np.zeros((chans, row_len), np.float32)
                    win[:, l_lo:l_hi] = cr[b, :, y - md + i * stride, xt - md + l_lo:xt - md + l_hi]
                    for j in range(n):
                        vals = (tile * win[:, j * stride:j * stride + tile_x]).sum(0) / chans
                        out[b, i * n + j, y, xt:xt + x_hi] = vals[:x_hi]
    return out


def _emulate_bwd(g, feats, md, stride, tile_x, dcr):
    """K3's (dcr False) or K4's (True) staging in numpy, block by block
    (csrc/correlation.cu::corr_bwd_kernel): the feature row from column
    xt - lead, the g rows (K4: slot m holds row j = n - 1 - m from column
    x' - o_j), the frame's outside zero; pixel x at slot m reads window
    column x + m * stride."""
    batch, chans, height, width = feats.shape
    n = kcorr.num_displacements(md, stride)
    row_len = tile_x + (n - 1) * stride
    lead = (n - 1) * stride - md if dcr else md
    out = np.zeros_like(feats)
    for b in range(batch):
        for y in range(height):
            if dcr:
                i_lo = -(-(y + md - height + 1) // stride) if y + md > height - 1 else 0
                i_hi = min(n - 1, (y + md) // stride)
            else:
                i_lo = -(-(md - y) // stride) if md > y else 0
                i_hi = min(n - 1, (height - 1 - y + md) // stride)
            for xt in range(0, width, tile_x):
                x_hi = min(tile_x, width - xt)
                l_lo, l_hi = max(0, lead - xt), min(row_len, width - xt + lead)
                acc = np.zeros((chans, tile_x), np.float32)
                for i in range(i_lo, i_hi + 1):
                    row = y + md - i * stride if dcr else y - md + i * stride
                    win = np.zeros((chans, row_len), np.float32)
                    win[:, l_lo:l_hi] = feats[b, :, row, xt - lead + l_lo:xt - lead + l_hi]
                    gs = np.zeros((n, tile_x), np.float32)
                    for m in range(n):
                        if dcr:
                            o = (n - 1 - m) * stride - md
                            lo, hi = max(0, o - xt), min(x_hi, width - xt + o)
                            if hi > lo:
                                gs[m, lo:hi] = g[b, i * n + n - 1 - m, row, xt - o + lo:xt - o + hi]
                        else:
                            gs[m, :x_hi] = g[b, i * n + m, y, xt:xt + x_hi]
                    for m in range(n):
                        acc += gs[m] * win[:, m * stride:m * stride + tile_x]
                out[b, :, y, xt:xt + x_hi] = acc[:, :x_hi] / chans
    return out


# the card tests' edge shapes, and levels 2 and 6 of the flow stage cut to
# two pairs
EDGE_SHAPES = [
    ((1, 5, 5, 7), 4, 3),      # a stride that does not divide md, batch 1
    ((2, 8, 3, 130), 0, 1),    # md 0, two x tiles
    ((1, 13, 3, 4), 4, 1),     # H and W below 2 * md + 1
    ((2, 20, 6, 24), 6, 2),    # C not a multiple of 8
    ((1, 12, 6, 20), 8, 1),    # n = 17: displacements 9 at a time
    ((2, 16, 5, 34), 8, 4),    # W % 4 != 0 at stride 4: the scalar paths
]


@pytest.mark.parametrize("shape,md,stride", EDGE_SHAPES + [
    ((2, 32, 32, 128), 32, 8), ((2, 196, 2, 8), 2, 1)])
def test_k2_k3_k4_tilings_match_plain_on_the_cpu(shape, md, stride):
    """The index math of the three kernels' staging (row ranges, window
    origins, K4's per-row g windows), emulated in numpy with each plan's
    tile, against the plain versions: the arithmetic the card then does
    on those staged rows is checked by the gpu tests."""
    rng = np.random.RandomState(sum(shape))
    cl, cr = (rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2))
    n2 = corr.correlation_channels(md, stride)
    g = rng.uniform(-1, 1, (shape[0], n2) + shape[2:]).astype(np.float32)
    t_cl, t_cr, t_g = (torch.from_numpy(a) for a in (cl, cr, g))
    k2_tile = kcorr.fwd_plan(*shape, md, stride)["tile_x"]
    bwd_tile = kcorr.bwd_plan(*shape, md, stride)["tile_x"]
    got = {"K2": _emulate_k2(cl, cr, md, stride, k2_tile),
           "K3": _emulate_bwd(g, cr, md, stride, bwd_tile, dcr=False),
           "K4": _emulate_bwd(g, cl, md, stride, bwd_tile, dcr=True)}
    ref = {"K2": corr.correlation_cost_plain(t_cl, t_cr, md, stride),
           "K3": corr.correlation_grad_cl_plain(t_g, t_cr, md, stride),
           "K4": corr.correlation_grad_cr_plain(t_g, t_cl, md, stride)}
    for name in ("K2", "K3", "K4"):
        r = ref[name].numpy()
        assert float(np.abs(got[name] - r).max()) <= 1e-5 * float(np.abs(r).max()), name


def test_nvcc_missing_is_reported(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


@pytest.mark.gpu
@pytest.mark.parametrize("height,width", HEADLINE)
@pytest.mark.parametrize("rows", [2, 3])
def test_k1_matches_plain_at_headline_scales(cuda, height, width, rows):
    image, coords, mask = _case(8, 4, height, width, seed=height, rows=rows,
                                device=cuda)
    for m in (mask, None):
        before = k1.K1.launches
        got = k1.K1(image, coords, m)
        assert k1.K1.launches == before + 1
        ref = bilinear_sample_plain(image, coords, m)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5
        assert bool((got[ref == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("height,width", HEADLINE)
@pytest.mark.parametrize("rows", [2, 3])
def test_k1_bwd_matches_plain_at_headline_scales(cuda, height, width, rows):
    image, coords, mask = _case(8, 4, height, width, seed=height + 1, rows=rows,
                                device=cuda)
    grad_out = torch.rand(image.shape, generator=torch.Generator().manual_seed(rows))
    grad_out = (grad_out * 2 - 1).to(cuda)
    for m in (mask, None):
        before = k1.K1_BWD.launches
        got = k1.K1_BWD(image, coords, m, grad_out)
        assert k1.K1_BWD.launches == before + 1
        ref = warp_coord_grad_plain(image, coords, m, grad_out)
        leaf = coords.clone().requires_grad_(True)
        bilinear_sample_plain(image, leaf, m).backward(grad_out)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5
        assert float((got - leaf.grad).abs().max()) <= 1e-5
        if rows == 3:
            assert bool((got[:, :, 2] == 0).all())


def _offset_copy(t, offset):
    """``t`` as a contiguous view ``offset`` floats into a larger buffer:
    its data_ptr is not 16-byte aligned for offset 1."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("batch,numsrc,height,width,rows,channels", [
    (1, 4, 5, 7, 2, 3),      # H*W % 4 != 0: the scalar path
    (2, 3, 3, 130, 3, 3),    # H*W % 4 != 0, 3 coord rows
    (1, 1, 16, 64, 2, 3),    # batch 1, one source
    (8, 1, 32, 128, 2, 3),   # the stereo cross-synthesis: 8 planes of one source
    (3, 2, 9, 28, 3, 3),     # H*W % 4 == 0, a ragged last warp
    (2, 2, 8, 24, 2, 5),     # C other than 3, on the float4 path
    (2, 2, 8, 24, 2, 12),    # C above 8: the scalar path
])
def test_k1_matches_plain_at_edge_shapes(cuda, batch, numsrc, height, width, rows, channels):
    """K1 against the plain sampler with and without a mask, on aligned
    inputs and on views whose data_ptr is not 16-byte aligned (its scalar
    path); both paths give the same bits."""
    image, coords, mask = _case(batch, numsrc, height, width, seed=width, rows=rows,
                                device=cuda, channels=channels)
    for m in (mask, None):
        ref = bilinear_sample_plain(image, coords, m)
        got = k1.K1(image, coords, m)
        shifted = k1.K1(_offset_copy(image, 1), _offset_copy(coords, 1),
                        None if m is None else _offset_copy(m, 1))
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5
        assert bool((got[ref == 0] == 0).all())
        assert torch.equal(got, shifted)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,md,stride", [
    ((1, 5, 5, 7), 4, 3),      # a stride that does not divide md, batch 1
    ((2, 8, 3, 130), 0, 1),    # md 0, two x tiles
    ((1, 13, 3, 4), 4, 1),     # H and W below 2 * md + 1
    ((2, 300, 4, 40), 4, 1),   # several channel chunks
    ((2, 20, 6, 24), 6, 2),    # C not a multiple of 8
])
def test_k3_matches_plain_at_edge_shapes(cuda, shape, md, stride):
    """K3 against the plain gradient and the plain cost volume's
    autograd, on aligned inputs and on views offset by one float."""
    generator = torch.Generator().manual_seed(sum(shape))
    cr = (torch.rand(shape, generator=generator) * 2 - 1).to(cuda)
    n2 = corr.correlation_channels(md, stride)
    g = (torch.rand((shape[0], n2) + shape[2:], generator=generator) * 2 - 1).to(cuda)
    ref = corr.correlation_grad_cl_plain(g, cr, md, stride)
    leaf = cr.clone().requires_grad_(True)
    (autograd,) = torch.autograd.grad(
        corr.correlation_cost_plain(leaf, cr, md, stride), leaf, g)
    got = kcorr.K3(g, cr, md, stride)
    shifted = kcorr.K3(_offset_copy(g, 1), _offset_copy(cr, 1), md, stride)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert float((got - autograd).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, shifted)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,md,stride", EDGE_SHAPES + [
    ((2, 300, 4, 40), 4, 1),   # several channel chunks (K4), many channel groups (K2)
    ((1, 300, 4, 128), 4, 1),  # K2: narrower tiles, one row a stage
    ((2, 24, 6, 40), 8, 4),    # stride, md and W multiples of 4: the float4 paths
])
def test_k2_k4_match_plain_at_edge_shapes(cuda, shape, md, stride):
    """K2 against the plain cost volume, K4 against the plain gradient and
    the plain cost volume's autograd, on aligned inputs and on views
    offset by one float (the scalar staging path): the same bits."""
    generator = torch.Generator().manual_seed(sum(shape) + 1)
    cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(cuda) for _ in range(2))
    n2 = corr.correlation_channels(md, stride)
    g = (torch.rand((shape[0], n2) + shape[2:], generator=generator) * 2 - 1).to(cuda)
    ref = {"K2": corr.correlation_cost_plain(cl, cr, md, stride),
           "K4": corr.correlation_grad_cr_plain(g, cl, md, stride)}
    leaf = cr.clone().requires_grad_(True)
    (autograd,) = torch.autograd.grad(
        corr.correlation_cost_plain(cl, leaf, md, stride), leaf, g)
    before = _corr_counts()
    got = {"K2": kcorr.K2(cl, cr, md, stride), "K4": kcorr.K4(g, cl, md, stride)}
    shifted = {"K2": kcorr.K2(_offset_copy(cl, 1), _offset_copy(cr, 1), md, stride),
               "K4": kcorr.K4(_offset_copy(g, 1), _offset_copy(cl, 1), md, stride)}
    assert _corr_counts() == (before[0] + 2, before[1], before[2] + 2)
    torch.cuda.synchronize()
    for name in ("K2", "K4"):
        scale = float(ref[name].abs().max())
        assert float((got[name] - ref[name]).abs().max()) <= 1e-5 * scale, name
        assert torch.equal(got[name], shifted[name]), name
    assert float((got["K4"] - autograd).abs().max()) <= 1e-5 * float(ref["K4"].abs().max())


@pytest.mark.gpu
def test_cuda_routing_and_refusals(cuda):
    image, coords, mask = _case(2, 4, 16, 64, seed=1, device=cuda)
    before = (k1.K1.launches, k1.K1_BWD.launches)
    got = bilinear_sample(image, coords, mask, const_src=True)
    torch.testing.assert_close(got, bilinear_sample_plain(image, coords, mask),
                               atol=1e-5, rtol=0)
    # differentiable: K1 forward, K1-bwd backward, no image or mask gradient
    image.requires_grad_(True)
    mask.requires_grad_(True)
    leaf = coords.clone().requires_grad_(True)
    bilinear_sample(image, leaf, mask, const_src=True).sum().backward()
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 2, before[1] + 1)
    assert image.grad is None and mask.grad is None
    ref = warp_coord_grad_plain(image.detach(), coords, mask.detach(), torch.ones_like(got))
    torch.testing.assert_close(leaf.grad, ref, atol=1e-5, rtol=0)
    image, mask = image.detach(), mask.detach()
    # the image-differentiable warp is plain gathers, no kernel
    torch.testing.assert_close(bilinear_sample(image, coords, mask),
                               bilinear_sample_plain(image, coords, mask), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="WarpConstSrc"):
        k1.K1(image, coords.clone().requires_grad_(True), mask)
    with pytest.raises(ValueError, match="float32"):
        k1.K1(image.double(), coords, mask)
    with pytest.raises(ValueError, match="contiguous"):
        k1.K1(image.transpose(2, 3).contiguous().transpose(2, 3), coords, mask)
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.gpu
def test_cuda_train_step_launches_both_kernels(cuda):
    """A train step of B0 at 64x128 on the card: 4 K1 and 4 K1-bwd
    launches (one per scale); an eval step: 4 K1 and no K1-bwd."""
    dataset = SyntheticDataset(batch_size=2, height=64, width=128, num_batches=1, seed=0)
    keys = dataset.config_keys()
    model = ModelFactory(keys, {"depth": "EfficientNetB0", "camera": "PoseNetImproved"},
                         stereo=False, device=cuda).get_model()
    loss = loss_factory(keys, {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}, SCALE_WEIGHT_T1,
                        stereo=False, batch_size=2)
    step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model))
    features = {k: torch.from_numpy(v).to(cuda) for k, v in next(iter(dataset)).items()}
    before = (k1.K1.launches, k1.K1_BWD.launches)
    metrics = step(features)
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 4, before[1] + 4)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    make_eval_step(model, loss)(features)
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 8, before[1] + 4)


@pytest.mark.gpu
def test_ssim_gradient_on_the_card_matches_the_cpu(cuda):
    """The SSIM pools' backward on the card: given a channels-last view,
    CUDA's avg_pool2d backward disagreed with the CPU's while its forward
    agreed; the loss now pools a contiguous NCHW copy."""
    rng = np.random.RandomState(3)
    synth = rng.uniform(-1, 1, (2, 4, 32, 64, 3)).astype(np.float32)
    synth[rng.rand(2, 4, 32, 64) < 0.2] = 0.0
    target = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    cot = rng.uniform(-1, 1, synth.shape).astype(np.float32)
    grads = []
    for device in (cuda, torch.device("cpu")):
        s = torch.from_numpy(synth).to(device).requires_grad_(True)
        out = photometric_loss_ssim(s, torch.from_numpy(target).to(device), reduce=False)
        out.backward(torch.from_numpy(cot).to(device))
        grads.append(s.grad.cpu())
    # float32 sums in another order
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("channels_last", [False, True])
def test_count_excluding_pool_gradient_on_the_card(cuda, channels_last):
    """NASNet's count-excluding SAME pool (``avg_pool_same_excluding_pad``)
    on the card against the CPU, forward and backward, on either layout:
    given the channels-last tensors that cuDNN's convolutions hand on,
    CUDA's avg_pool2d backward with that padding was wrong while its
    forward agreed; the pool now takes a contiguous copy."""
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (2, 44, 16, 64)).astype(np.float32)
    cot = rng.uniform(-1, 1, x.shape).astype(np.float32)
    results = []
    for device in (cuda, torch.device("cpu")):
        leaf = torch.from_numpy(x).to(device)
        if channels_last:
            leaf = leaf.to(memory_format=torch.channels_last)
        leaf.requires_grad_(True)
        out = avg_pool_same_excluding_pad(leaf, 3)
        out.backward(torch.from_numpy(cot).to(device))
        results.append((out.detach().cpu(), leaf.grad.cpu()))
    # float32 sums of 4 to 9 values in another order
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)

def _corr_counts():
    return (kcorr.K2.launches, kcorr.K3.launches, kcorr.K4.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
def test_correlation_kernels_match_plain_at_pwc_levels(cuda, level):
    """The flow stage's shapes: 32 pairs at 128x512 inputs, C and (md,
    stride) of each level; K3 and K4 also against the plain autograd."""
    md, stride = level_displacement(level)
    shape = (32, ENCODER_CHANNELS[level - 1], 128 >> level, 512 >> level)
    generator = torch.Generator().manual_seed(level)
    cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(cuda) for _ in range(2))
    n2 = corr.correlation_channels(md, stride)
    g = (torch.rand((32, n2) + shape[2:], generator=generator) * 2 - 1).to(cuda)
    before = _corr_counts()
    got = [kcorr.K2(cl, cr, md, stride), kcorr.K3(g, cr, md, stride), kcorr.K4(g, cl, md, stride)]
    assert _corr_counts() == tuple(c + 1 for c in before)
    ref = [corr.correlation_cost_plain(cl, cr, md, stride),
           corr.correlation_grad_cl_plain(g, cr, md, stride),
           corr.correlation_grad_cr_plain(g, cl, md, stride)]
    leaves = [cl.clone().requires_grad_(True), cr.clone().requires_grad_(True)]
    autograd = torch.autograd.grad(corr.correlation_cost_plain(*leaves, md, stride), leaves, g)
    torch.cuda.synchronize()
    for name, x, r in zip(("K2", "K3", "K4"), got, ref):
        assert tuple(x.shape) == tuple(r.shape)
        assert float((x - r).abs().max()) <= 1e-5 * float(r.abs().max()), name
    for name, x, r in zip(("K3", "K4"), got[1:], autograd):
        assert float((x - r).abs().max()) <= 1e-5 * float(r.abs().max()), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("md,stride,first", [(4, 2, 0), (4, 2, 8), (12, 4, 0), (12, 4, 8)])
def test_correlation_kernels_on_a_band_match_plain(cuda, dtype, md, stride, first):
    """A spatial mesh's band: 8 of a 16-row map's rows from ``first``,
    against the rows of cr that ``spatial.correlation_rows`` gives it (md
    rows beyond each side, zeros outside the frame, where md fits the
    band; else the whole map) with their row offset: K2, K3 and K4 (their
    bf16 forms in bf16) against the plain versions with that offset,
    float32 within 1e-5 of the largest value, bf16 within one ulp."""
    import torch.nn.functional as F

    rows, height = 8, 16
    generator = torch.Generator().manual_seed(md + first)
    cl, cr = ((torch.rand((4, 24, height, 40), generator=generator) * 2 - 1).to(cuda, dtype)
              for _ in range(2))
    g = (torch.rand((4, corr.correlation_channels(md, stride), rows, 40),
                    generator=generator) * 2 - 1).to(cuda, dtype)
    if md <= rows:
        top, bottom = max(0, md - first), max(0, first + rows + md - height)
        cr_rows = F.pad(cr, (0, 0, top, bottom))[:, :, first - md + top:
                                                 first + rows + md + top].contiguous()
        offset = md
    else:
        cr_rows, offset = cr, first
    cl_band = cl[:, :, first: first + rows].contiguous()
    k2, k3, k4 = kcorr.kernels_for(dtype)
    got = [k2(cl_band, cr_rows, md, stride, offset), k3(g, cr_rows, md, stride, offset),
           k4(g, cl_band, md, stride, offset, cr_rows.shape[2])]
    ref = [corr.correlation_cost_plain(cl_band, cr_rows, md, stride, offset),
           corr.correlation_grad_cl_plain(g, cr_rows, md, stride, offset),
           corr.correlation_grad_cr_plain(g, cl_band, md, stride, offset, cr_rows.shape[2])]
    torch.cuda.synchronize()
    for name, x, r in zip(("K2", "K3", "K4"), got, ref):
        assert x.shape == r.shape and x.dtype == dtype, name
        if dtype == torch.bfloat16:
            assert chip_smoke.bf16_ulp_excess(x, r)[1] <= 1.0, name
        else:
            assert float((x - r).abs().max()) <= 1e-5 * float(r.abs().max()), name


@pytest.mark.gpu
def test_correlation_routing_and_refusals(cuda):
    rng = np.random.RandomState(5)
    cl, cr = (torch.from_numpy(rng.uniform(-1, 1, (2, 8, 6, 10)).astype(np.float32)).to(cuda)
              for _ in range(2))
    before = _corr_counts()
    out = corr.correlation_cost(cl, cr, 4, 2)
    torch.testing.assert_close(out, corr.correlation_cost_plain(cl, cr, 4, 2), atol=1e-6, rtol=0)
    # differentiable: K2 forward, then K3 and K4 only for the inputs that need them
    a, b = cl.clone().requires_grad_(True), cr.clone().requires_grad_(True)
    corr.correlation_cost(a, b, 4, 2).sum().backward()
    corr.correlation_cost(cl, b, 4, 2).sum().backward()
    assert _corr_counts() == (before[0] + 3, before[1] + 1, before[2] + 2)
    g = torch.ones_like(out)
    torch.testing.assert_close(a.grad, corr.correlation_grad_cl_plain(g, cr, 4, 2),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(b.grad, 2 * corr.correlation_grad_cr_plain(g, cl, 4, 2),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="Correlation"):
        kcorr.K2(a, cr, 4, 2)
    with pytest.raises(ValueError, match="float32"):
        kcorr.K2(cl.double(), cr.double(), 4, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kcorr.K2(cl.transpose(2, 3).contiguous().transpose(2, 3), cr, 4, 2)
    with pytest.raises(ValueError, match="grad_out"):
        kcorr.K4(g[:, :5], cl, 4, 2)
    assert _corr_counts() == (before[0] + 3, before[1] + 1, before[2] + 2)


@pytest.mark.gpu
def test_cuda_flow_steps_launch_every_kernel(cuda):
    """PWC-Net at 64x128, batch 2: a forward launches K2 at the 5 levels
    and nothing else; a flow train step K2, K3 and K4 5 times each and
    K1 and K1-bwd 4 times each (the flowL2 warps)."""
    dataset = SyntheticDataset(batch_size=2, height=64, width=128, num_batches=1, seed=0)
    keys = dataset.config_keys()
    model = ModelFactory(keys, FLOW_NET, stereo=False, device=cuda).get_model()
    loss = loss_factory(keys, {"flowL2": 1.0, "flow_reg": 4e-7}, SCALE_WEIGHT_T1,
                        stereo=False, batch_size=2)
    features = {k: torch.from_numpy(v).to(cuda) for k, v in next(iter(dataset)).items()}

    def counts():
        return (k1.K1.launches, k1.K1_BWD.launches) + _corr_counts()

    before = counts()
    preds = make_predict_step(model)(features)
    assert [tuple(f.shape) for f in preds["flow_ms"]] == [
        (2, 4, 64 >> s, 128 >> s, 2) for s in (2, 3, 4, 5)]
    assert counts() == (before[0], before[1], before[2] + 5, before[3], before[4])
    step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model),
                           regularize_net="flownet")
    before = counts()
    metrics = step(features)
    assert counts() == tuple(c + n for c, n in zip(before, (4, 4, 5, 5, 5)))
    assert set(metrics) == {"loss", "loss/flowL2", "loss/flow_reg"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.gpu
def test_cuda_joint_train_step_launches_no_flow_backward(cuda):
    """EfficientNetB0 + PoseNetImproved + PWCNet at 64x128, batch 2, the
    flownet frozen: a joint train step launches K2 5 times (forward
    only), K1 8 times (4 synthesis and 4 flow warps) and K1-bwd 4 times
    (the synthesis warps), never K3 or K4; the flownet stays unchanged."""
    dataset = SyntheticDataset(batch_size=2, height=64, width=128, num_batches=1, seed=0)
    keys = dataset.config_keys()
    nets = {"depth": "EfficientNetB0", "camera": "PoseNetImproved", "flow": "PWCNet"}
    model = ModelFactory(keys, nets, stereo=False, device=cuda).get_model()
    loss = loss_factory(keys, {"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 20.0},
                        SCALE_WEIGHT_T1, stereo=False, batch_size=2)
    features = {k: torch.from_numpy(v).to(cuda) for k, v in next(iter(dataset)).items()}
    flow_before = {k: v.clone() for k, v in model.flownet.state_dict().items()}
    step = make_train_step(
        model, loss, optimizer_factory("adam_constant", 1e-4, model, frozen_nets=["flownet"]),
        frozen_nets=["flownet"])

    def counts():
        return (k1.K1.launches, k1.K1_BWD.launches) + _corr_counts()

    before = counts()
    metrics = step(features)
    assert counts() == tuple(c + n for c, n in zip(before, (8, 4, 5, 0, 0)))
    assert {"loss/cmbL1", "loss/cmbSSIM"} <= set(metrics)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(torch.equal(v, model.flownet.state_dict()[k]) for k, v in flow_before.items())


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    return chip_smoke.bf16_ulp_excess(got, want)[1] <= 1.0


def _bf16_corr_counts():
    return tuple(k.launches for k in kcorr.kernels_for(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
def test_bf16_correlation_kernels_match_plain_at_pwc_levels(cuda, level):
    """The bfloat16 K2, K3 and K4 at the flow stage's shapes (32 pairs at
    128x512 inputs) against their plain versions on the same bfloat16
    inputs, and K3 and K4 against the plain autograd; the float32 kernels
    are not launched."""
    md, stride = level_displacement(level)
    shape = (32, ENCODER_CHANNELS[level - 1], 128 >> level, 512 >> level)
    generator = torch.Generator().manual_seed(level)
    cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(cuda, torch.bfloat16)
              for _ in range(2))
    n2 = corr.correlation_channels(md, stride)
    g = (torch.rand((32, n2) + shape[2:], generator=generator) * 2 - 1).to(cuda, torch.bfloat16)
    before, before_f32 = _bf16_corr_counts(), _corr_counts()
    got = [kcorr.K2_BF16(cl, cr, md, stride), kcorr.K3_BF16(g, cr, md, stride),
           kcorr.K4_BF16(g, cl, md, stride)]
    assert _bf16_corr_counts() == tuple(c + 1 for c in before)
    assert _corr_counts() == before_f32
    ref = [corr.correlation_cost_plain(cl, cr, md, stride),
           corr.correlation_grad_cl_plain(g, cr, md, stride),
           corr.correlation_grad_cr_plain(g, cl, md, stride)]
    leaves = [cl.clone().requires_grad_(True), cr.clone().requires_grad_(True)]
    autograd = torch.autograd.grad(corr.correlation_cost_plain(*leaves, md, stride), leaves, g)
    torch.cuda.synchronize()
    for name, x, r in zip(("K2", "K3", "K4"), got, ref):
        assert x.dtype == torch.bfloat16 and tuple(x.shape) == tuple(r.shape), name
        assert bf16_close(x, r), name
    for name, x, r in zip(("K3", "K4"), got[1:], autograd):
        assert bf16_close(x, r), name


@pytest.mark.gpu
@pytest.mark.parametrize("shape,md,stride", EDGE_SHAPES + [
    ((2, 300, 4, 40), 4, 1),   # several channel chunks (K3, K4), many channel groups (K2)
    ((1, 300, 4, 128), 4, 1),  # K2: narrower tiles, one row a stage
    ((2, 24, 6, 40), 8, 4),    # stride, md and W multiples of 4: the vector paths
])
def test_bf16_k2_k3_k4_match_plain_at_edge_shapes(cuda, shape, md, stride):
    """The bfloat16 kernels at the edge shapes, on aligned inputs and on
    views offset by one value (the scalar staging and store paths): within
    one ulp of the plain versions, and the same bits on both."""
    generator = torch.Generator().manual_seed(sum(shape) + 2)
    cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(cuda, torch.bfloat16)
              for _ in range(2))
    n2 = corr.correlation_channels(md, stride)
    g = (torch.rand((shape[0], n2) + shape[2:], generator=generator) * 2 - 1).to(
        cuda, torch.bfloat16)
    ref = {"K2": corr.correlation_cost_plain(cl, cr, md, stride),
           "K3": corr.correlation_grad_cl_plain(g, cr, md, stride),
           "K4": corr.correlation_grad_cr_plain(g, cl, md, stride)}
    got = {"K2": kcorr.K2_BF16(cl, cr, md, stride), "K3": kcorr.K3_BF16(g, cr, md, stride),
           "K4": kcorr.K4_BF16(g, cl, md, stride)}
    shifted = {"K2": kcorr.K2_BF16(_offset_copy(cl, 1), _offset_copy(cr, 1), md, stride),
               "K3": kcorr.K3_BF16(_offset_copy(g, 1), _offset_copy(cr, 1), md, stride),
               "K4": kcorr.K4_BF16(_offset_copy(g, 1), _offset_copy(cl, 1), md, stride)}
    torch.cuda.synchronize()
    for name in ("K2", "K3", "K4"):
        assert bf16_close(got[name], ref[name]), name
        assert torch.equal(got[name], shifted[name]), name


@pytest.mark.gpu
def test_cuda_bf16_flow_steps_launch_the_bf16_kernels(cuda):
    """A bfloat16 PWC-Net at 64x128, batch 2: the forward launches the
    bfloat16 K2 at the 5 levels, a flow train step the bfloat16 K2, K3 and
    K4 5 times each, and never a float32 correlation kernel; the flows are
    float32 and the parameters and their gradients stay float32."""
    dataset = SyntheticDataset(batch_size=2, height=64, width=128, num_batches=1, seed=0)
    keys = dataset.config_keys()
    model = ModelFactory(keys, FLOW_NET, stereo=False, compute_dtype="bfloat16",
                         device=cuda).get_model()
    loss = loss_factory(keys, {"flowL2": 1.0, "flow_reg": 4e-7}, SCALE_WEIGHT_T1,
                        stereo=False, batch_size=2)
    features = {k: torch.from_numpy(v).to(cuda) for k, v in next(iter(dataset)).items()}
    before, before_f32 = _bf16_corr_counts(), _corr_counts()
    preds = make_predict_step(model)(features)
    assert all(f.dtype == torch.float32 for f in preds["flow_ms"])
    assert _bf16_corr_counts() == (before[0] + 5, before[1], before[2])
    step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model),
                           regularize_net="flownet")
    before = _bf16_corr_counts()
    metrics = step(features)
    assert _bf16_corr_counts() == tuple(c + 5 for c in before)
    assert _corr_counts() == before_f32
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
