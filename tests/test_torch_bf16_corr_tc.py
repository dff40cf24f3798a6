"""The tensor-core tilings of the bfloat16 correlation kernels K2-bf16,
K3-bf16 and K4-bf16 (``csrc/correlation_bf16.cu``) on the CPU: their
launch plans (``fwd_plan_bf16``, ``bwd_cl_plan_bf16``,
``bwd_cr_plan_bf16``) and numpy emulations of their algebra, block by
block with each plan's tile: the rows staged as a TMA box stages them
(zeros outside the frame and past the last channel), the work cut by
residue class of x mod stride, K2's 16 x 24 band product per 16 channels
with its diagonals taken as outputs, K3's and K4's m16n8k16 products
against the banded matrix built from the staged g rows (K3: those of its
in-frame displacement rows at the block's own image row, over its tile,
staged once; K4: those at each cl row over the window), float32 partial
sums added per 16-wide K step in the kernels' order.

The emulations are held to the plain versions on float32 inputs (1e-5 of
the largest plain value: the same products summed in another order) and,
on bfloat16 inputs, to the JAX Pallas kernel and its VJP in interpret mode
under the one-ulp rule of ``chip_smoke.bf16_ulp_excess``: both read the
operands as float32, sum in float32, divide by C and round once.

The card tests (marked ``gpu``) run the kernels themselves at the PWC
levels and at the tile edges, on aligned inputs (TMA staging where W % 8
== 0) and on views offset by one value (the threads' staging), which must
give the same bits. Run them on a card with

    python -m pytest tests/test_torch_bf16_corr_tc.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
from xpt_mde_tpu_torch.ops import correlation as corr
from xpt_mde_tpu_torch.ops.kernels import correlation as kcorr

P, J = kcorr.BF16_TILE_P, kcorr.BF16_DISP

# the card tests' edge shapes (tests/test_torch_kernels.py) and the new
# tiles' edges: C % 16 != 0 with TMA staging, W below one 16-pixel class
# tile, n = 5 and n = 17 with TMA, stride 2 with W % 8 == 0, several
# channel boxes, an image row with no in-frame displacement row
EDGE_SHAPES = [
    ((1, 5, 5, 7), 4, 3),      # a stride that does not divide md; W % 8 != 0
    ((2, 8, 3, 130), 0, 1),    # md 0, two x tiles
    ((1, 13, 3, 4), 4, 1),     # H and W below 2 * md + 1
    ((2, 20, 6, 24), 6, 2),    # C not a multiple of 16, TMA
    ((1, 12, 6, 20), 8, 1),    # n = 17: two chunks of displacements
    ((2, 16, 5, 34), 8, 4),    # W % 8 != 0 at stride 4
    ((2, 20, 4, 40), 2, 1),    # n = 5 with TMA
    ((1, 24, 5, 8), 8, 1),     # n = 17 with TMA, W below one class tile
    ((2, 36, 6, 96), 12, 4),   # stride 4, n = 7, 4 classes of 24 pixels
    ((2, 20, 2, 24), 4, 3),    # offsets -4, -1, 2: row 0 has no in-frame row
]
LEVELS = [6, 5, 4, 3, 2]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _level_shape(level, batch=32):
    md, stride = level_displacement(level)
    return (batch, ENCODER_CHANNELS[level - 1], 128 >> level, 512 >> level), md, stride


def _stage(rows, col0, pitch, chans):
    """A staged box: ``rows`` [R, W] from frame column col0 on, ``pitch``
    columns and ``chans`` rows, zeros outside the frame and past R."""
    out = np.zeros((chans, pitch), np.float32)
    width = rows.shape[1]
    lo, hi = max(0, -col0), min(pitch, width - col0)
    if hi > lo:
        out[:rows.shape[0], lo:hi] = rows[:, col0 + lo:col0 + hi]
    return out


def _emulate_k2_bf16(cl, cr, md, stride, plan):
    """K2-bf16 (corr_fwd_bf16_kernel) in numpy with ``plan``'s tile and
    groups; float32 sums, divided by C (not rounded)."""
    batch, chans, height, width = cl.shape
    s, n = stride, kcorr.num_displacements(md, stride)
    chunks = -(-n // J)
    tile_x, groups = plan["tile_x"], plan["groups"]
    lay = kcorr.fwd_bf16_layout(chans, height, s, n, tile_x, groups)
    assert lay["rows"] <= kcorr.BF16_FWD_ROWS
    warps = tile_x // P * chunks
    out = np.full((batch, n * n, height, width), np.nan, np.float32)
    ksteps = -(-chans // 16)
    pp, qq = np.meshgrid(np.arange(P), np.arange(3 * 8), indexing="ij")
    for b in range(batch):
        for y in range(height):
            lo_y = -(-(md - y) // s) if md > y else 0
            hi_y = min(n - 1, (height - 1 - y + md) // s)
            for xt in range(0, width, tile_x):
                x_hi = min(tile_x, width - xt)
                for grp in range(groups):
                    c_lo = lo_y + grp * lay["rows"]
                    rows = max(0, min(hi_y, c_lo + lay["rows"] - 1) - c_lo + 1)
                    tile = _stage(cl[b, :, y], xt, lay["cl_pitch"], lay["chans"])
                    sh = kcorr.lead8(xt - md)
                    staged = [_stage(cr[b, :, y - md + (c_lo + k) * s], xt - md - sh,
                                     lay["row_pitch"], lay["chans"]) for k in range(rows)]
                    part = np.full((rows * n, tile_x), np.nan, np.float32)
                    for warp in range(warps):
                        j0 = warp % chunks * J
                        cls, ct = warp // chunks % s, warp // chunks // s
                        px = cls + s * (P * ct + np.arange(P))
                        wcol = sh + cls + s * (P * ct + j0 + np.arange(24))
                        jl = qq - pp
                        keep = (jl >= 0) & (jl < J) & (j0 + jl < n)
                        for r in range(rows):
                            acc = np.zeros((P, 24), np.float32)
                            for k16 in range(ksteps):
                                ch = slice(16 * k16, 16 * k16 + 16)
                                acc += tile[ch][:, px].T @ staged[r][ch][:, wcol]
                            part[r * n + j0 + jl[keep], px[pp[keep]]] = acc[keep]
                    if rows:
                        planes = slice(c_lo * n, (c_lo + rows) * n)
                        out[b, planes, y, xt:xt + x_hi] = part[:, :x_hi] / np.float32(chans)
                    for i in range(grp, n, groups):
                        if i < lo_y or i > hi_y:
                            out[b, i * n:(i + 1) * n, y, xt:xt + x_hi] = 0
    assert not np.isnan(out).any(), "an output the kernel never writes"
    return out


def _emulate_k4_bf16(g, cl, md, stride, plan):
    """K4-bf16 (corr_bwd_cr_bf16_kernel) in numpy with ``plan``'s tile and
    channel blocks; float32 sums, divided by C (not rounded)."""
    batch, chans, height, width = cl.shape
    s, n = stride, kcorr.num_displacements(md, stride)
    tile_x, chan_blocks = plan["tile_x"], plan["chan_blocks"]
    lay = kcorr.bwd_cr_bf16_layout(s, n, tile_x, chan_blocks, plan["rows_per_stage"])
    cc, pitch = lay["chans"], lay["pitch"]
    out = np.full(cl.shape, np.nan, np.float32)
    kk = np.arange(16)[:, None]
    pp = np.arange(8)[None, :]
    for b in range(batch):
        for y in range(height):
            over = y + md - (height - 1)
            i_lo = -(-over // s) if over > 0 else 0
            i_hi = min(n - 1, (y + md) // s)
            for xt in range(0, width, tile_x):
                x_hi = min(tile_x, width - xt)
                col0 = xt - ((n - 1) * s - md)
                sh = kcorr.lead8(col0)
                for c0 in range(0, chans, cc):
                    acc = np.zeros((cc, tile_x), np.float32)
                    for i in range(i_lo, i_hi + 1):
                        row = y + md - i * s
                        feat = _stage(cl[b, c0:c0 + cc, row], col0 - sh, pitch, cc)
                        grows = _stage(g[b, i * n:(i + 1) * n, row], col0 - sh, pitch, n)
                        for tile in range(tile_x // P):
                            cls, ct = tile % s, tile // s
                            for m0 in range(0, n, J):
                                for pt in range(2):
                                    wcol = sh + cls + s * (P * ct + 8 * pt + m0 + kk[:, 0])
                                    m = m0 + kk - pp
                                    on = (m >= m0) & (m < m0 + J) & (m < n)
                                    band = np.where(on, grows[np.where(on, n - 1 - m, 0),
                                                              wcol[:, None]], 0)
                                    px = cls + s * (P * ct + 8 * pt + np.arange(8))
                                    acc[:, px] += feat[:, wcol] @ band.astype(np.float32)
                    keep = min(cc, chans - c0)
                    out[b, c0:c0 + keep, y, xt:xt + x_hi] = acc[:keep, :x_hi] / np.float32(chans)
    assert not np.isnan(out).any(), "an output the kernel never writes"
    return out


def _emulate_k3_bf16(g, cr, md, stride, plan):
    """K3-bf16 (corr_bwd_cl_bf16_kernel) in numpy with ``plan``'s tile and
    channel blocks: the block's g tile (the g rows of image row y from its
    first in-frame displacement row on, over the tile) staged once, each
    in-frame row's cr row over the window; float32 sums, divided by C (not
    rounded)."""
    batch, chans, height, width = cr.shape
    s, n = stride, kcorr.num_displacements(md, stride)
    tile_x, chan_blocks = plan["tile_x"], plan["chan_blocks"]
    lay = kcorr.bwd_cl_bf16_layout(s, n, tile_x, chan_blocks, plan["rows_per_stage"], height)
    cc, pitch = lay["chans"], lay["pitch"]
    out = np.full(cr.shape, np.nan, np.float32)
    kk = np.arange(16)[:, None]
    pp = np.arange(8)[None, :]
    for b in range(batch):
        for y in range(height):
            i_lo = -(-(md - y) // s) if md > y else 0
            i_hi = min(n - 1, (height - 1 - y + md) // s)
            for xt in range(0, width, tile_x):
                x_hi = min(tile_x, width - xt)
                col0 = xt - md
                sh = kcorr.lead8(col0)
                g_tile = _stage(g[b, i_lo * n:i_lo * n + lay["g_planes"], y], xt, lay["g_pitch"],
                                lay["g_planes"])
                for c0 in range(0, chans, cc):
                    acc = np.zeros((cc, tile_x), np.float32)
                    for i in range(i_lo, i_hi + 1):
                        feat = _stage(cr[b, c0:c0 + cc, y - md + i * s], col0 - sh, pitch, cc)
                        grows = g_tile[(i - i_lo) * n:(i - i_lo + 1) * n]
                        for tile in range(tile_x // P):
                            cls, ct = tile % s, tile // s
                            for m0 in range(0, n, J):
                                for pt in range(2):
                                    wcol = sh + cls + s * (P * ct + 8 * pt + m0 + kk[:, 0])
                                    px = cls + s * (P * ct + 8 * pt + np.arange(8))
                                    j = m0 + kk - pp
                                    on = (j >= m0) & (j < m0 + J) & (j < n)
                                    band = np.where(on, grows[np.where(on, j, 0), px[None, :]],
                                                    0)
                                    acc[:, px] += feat[:, wcol] @ band.astype(np.float32)
                    keep = min(cc, chans - c0)
                    out[b, c0:c0 + keep, y, xt:xt + x_hi] = acc[:keep, :x_hi] / np.float32(chans)
    assert not np.isnan(out).any(), "an output the kernel never writes"
    return out


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("level", LEVELS)
def test_bf16_plans_fit_and_fill_the_card_at_pwc_levels(level):
    """At the flow stage's shapes (32 pairs at 128x512): at most 227 KB of
    shared memory and 8 warps, at least two blocks per SM of an H100, at
    most 4 in-frame rows a K2 block, the rows staged by TMA, and the
    entries' layouts."""
    shape, md, stride = _level_shape(level)
    n = kcorr.num_displacements(md, stride)
    for name, plan in (("K2", kcorr.fwd_plan_bf16(*shape, md, stride)),
                       ("K3", kcorr.bwd_cl_plan_bf16(*shape, md, stride)),
                       ("K4", kcorr.bwd_cr_plan_bf16(*shape, md, stride))):
        assert plan["tile_x"] % (P * stride) == 0 and plan["tile_x"] >= shape[3], name
        assert plan["grid"][0] * plan["grid"][1] * plan["grid"][2] >= 2 * kcorr.H100_SMS, name
        assert max(plan["grid"][1:]) <= 65535, name
        assert plan["threads"] % 32 == 0 and plan["threads"] <= 32 * kcorr.BF16_MAX_WARPS, name
        assert plan["smem_bytes"] <= kcorr.SMEM_LIMIT, name
        assert plan["tma"], name
    k2 = kcorr.fwd_plan_bf16(*shape, md, stride)
    lay = kcorr.fwd_bf16_layout(shape[1], shape[2], stride, n, k2["tile_x"], k2["groups"])
    assert k2["smem_bytes"] == lay["total"] and lay["rows"] == k2["rows_per_group"] <= 4
    assert k2["threads"] == 32 * k2["tile_x"] // P
    k4 = kcorr.bwd_cr_plan_bf16(*shape, md, stride)
    assert k4["smem_bytes"] == kcorr.bwd_cr_bf16_layout(stride, n, k4["tile_x"],
                                                        k4["chan_blocks"],
                                                        k4["rows_per_stage"])["total"]
    k3 = kcorr.bwd_cl_plan_bf16(*shape, md, stride)
    assert k3["smem_bytes"] == kcorr.bwd_cl_bf16_layout(stride, n, k3["tile_x"],
                                                        k3["chan_blocks"],
                                                        k3["rows_per_stage"],
                                                        shape[2])["total"]
    assert k4["rows_per_stage"] == kcorr.rows_max(n, stride, shape[2])
    # K3 stages fewer rows at a time before it splits its channels further
    assert 1 <= k3["rows_per_stage"] <= kcorr.rows_max(n, stride, shape[2])
    assert k3["chan_blocks"] == -(-shape[1] // 16) or level > 3
    for plan in (k3, k4):
        assert plan["grid"][2] == 32 * -(-shape[1] // (16 * plan["chan_blocks"]))
        assert (kcorr.resident_warps(plan["threads"], plan["smem_bytes"])
                >= kcorr.BF16_BWD_WARPS_PER_SM or plan["chan_blocks"] == 1)
    # split until an SM holds enough warps, where the rows or channels allow
    assert (kcorr.resident_warps(k2["threads"], k2["smem_bytes"])
            >= kcorr.BF16_FWD_WARPS_PER_SM or lay["rows"] == 1)


@pytest.mark.parametrize("shape,md,stride", EDGE_SHAPES)
def test_bf16_plans_at_edge_shapes(shape, md, stride):
    """TMA staging exactly where W % 8 == 0 and the rows fit one box; the
    tile covers the row in class tiles; one warp a tile; at most 227 KB;
    the layouts the entries recompute."""
    n = kcorr.num_displacements(md, stride)
    k2 = kcorr.fwd_plan_bf16(*shape, md, stride)
    k3 = kcorr.bwd_cl_plan_bf16(*shape, md, stride)
    k4 = kcorr.bwd_cr_plan_bf16(*shape, md, stride)
    width = shape[3]
    for plan in (k2, k3, k4):
        assert plan["tile_x"] % (P * stride) == 0
        assert plan["grid"][0] * plan["tile_x"] >= width
        assert plan["tma"] == (width % 8 == 0)
        assert plan["smem_bytes"] <= kcorr.SMEM_LIMIT
    assert k2["threads"] == 32 * k2["tile_x"] // P * -(-n // J)
    assert 1 <= k2["groups"] <= n and k2["rows_per_group"] <= kcorr.BF16_FWD_ROWS
    layouts = {"K3": kcorr.bwd_cl_bf16_layout(stride, n, k3["tile_x"], k3["chan_blocks"],
                                              k3["rows_per_stage"], shape[2]),
               "K4": kcorr.bwd_cr_bf16_layout(stride, n, k4["tile_x"], k4["chan_blocks"],
                                              k4["rows_per_stage"])}
    for name, plan in (("K3", k3), ("K4", k4)):
        assert plan["threads"] == 32 * plan["tile_x"] // P * -(-plan["chan_blocks"] // 4)
        assert 1 <= plan["rows_per_stage"] <= kcorr.BF16_ROWS_PER_STAGE
        assert plan["smem_bytes"] == layouts[name]["total"], name


def test_bf16_plans_refuse_what_cannot_fit():
    """Rows over 227 KB even at one class tile, one row and one channel
    block, or a stride whose class tile needs more than 8 warps: the plans
    raise, and so the wrappers do before they launch."""
    with pytest.raises(ValueError, match="shared memory"):
        kcorr.fwd_plan_bf16(1, 4000, 4, 64, 8, 1)
    with pytest.raises(ValueError, match="shared memory"):
        kcorr.bwd_cr_plan_bf16(1, 8, 4, 64, 2000, 1)
    with pytest.raises(ValueError, match="K3-bf16 needs .* shared memory"):
        kcorr.bwd_cl_plan_bf16(1, 8, 4, 64, 2000, 1)
    with pytest.raises(ValueError, match="threads"):
        kcorr.fwd_plan_bf16(1, 8, 4, 64, 40, 3)  # 3 classes x 3 chunks of 9 displacements
    with pytest.raises(ValueError, match="threads"):
        kcorr.bwd_cr_plan_bf16(1, 8, 4, 64, 300, 300)
    with pytest.raises(ValueError, match="threads"):
        kcorr.bwd_cl_plan_bf16(1, 8, 4, 64, 300, 300)
    with pytest.raises(ValueError, match="channel"):
        kcorr.fwd_plan_bf16(1, 0, 4, 64, 4, 1)


def test_stage_pitch_and_channel_boxes():
    """Staged rows are whole 16-byte units, an odd count (the lanes'
    gathers spread over the banks); K2's channel boxes are at most 256
    channels, multiples of 8, covering C rounded up to 16."""
    for cols in range(1, 300):
        pitch = kcorr.stage_pitch(cols)
        assert pitch >= cols and pitch % 8 == 0 and (pitch // 8) % 2 == 1
        assert pitch - cols < 24
    for channels in range(1, 1100, 7):
        box, count = kcorr.chan_boxes(channels)
        assert box % 8 == 0 and box <= kcorr.TMA_BOX
        assert box * count >= -(-channels // 16) * 16
        assert count == -(-(-(-channels // 16) * 16) // kcorr.TMA_BOX)


# ------------------------------------------------------------ emulations


def _plain_f32(shape, md, stride, seed):
    rng = np.random.RandomState(seed)
    cl, cr = (rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2))
    n2 = corr.correlation_channels(md, stride)
    g = rng.uniform(-1, 1, (shape[0], n2) + shape[2:]).astype(np.float32)
    t_cl, t_cr, t_g = (torch.from_numpy(a) for a in (cl, cr, g))
    ref = {"K2": corr.correlation_cost_plain(t_cl, t_cr, md, stride).numpy(),
           "K3": corr.correlation_grad_cl_plain(t_g, t_cr, md, stride).numpy(),
           "K4": corr.correlation_grad_cr_plain(t_g, t_cl, md, stride).numpy()}
    return cl, cr, g, ref


@pytest.mark.parametrize("shape,md,stride,plan_shape", [
    (shape, md, stride, shape) for shape, md, stride in EDGE_SHAPES] + [
    (_level_shape(level, 2)[0],) + _level_shape(level)[1:] + (_level_shape(level)[0],)
    for level in (2, 6)])
def test_bf16_tilings_match_plain_on_the_cpu(shape, md, stride, plan_shape):
    """The band products of K2-bf16, K3-bf16 and K4-bf16, emulated with the
    plan of ``plan_shape`` (the levels' own 32-pair plans on 2 pairs),
    against the plain versions on float32 inputs: within 1e-5 of the
    largest value."""
    cl, cr, g, ref = _plain_f32(shape, md, stride, sum(shape))
    got = {"K2": _emulate_k2_bf16(cl, cr, md, stride, kcorr.fwd_plan_bf16(*plan_shape, md,
                                                                          stride)),
           "K3": _emulate_k3_bf16(g, cr, md, stride, kcorr.bwd_cl_plan_bf16(*plan_shape, md,
                                                                           stride)),
           "K4": _emulate_k4_bf16(g, cl, md, stride, kcorr.bwd_cr_plan_bf16(*plan_shape, md,
                                                                           stride))}
    for name in ("K2", "K3", "K4"):
        scale = float(np.abs(ref[name]).max())
        assert float(np.abs(got[name] - ref[name]).max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("level", LEVELS)
def test_bf16_tilings_match_the_pallas_kernels(level):
    """On bfloat16 inputs at each level's (md, stride), the emulations
    rounded once to bfloat16 against the JAX Pallas kernel and its VJP (dcl
    for K3, dcr for K4) in interpret mode: within one bfloat16 ulp + 1e-6 x
    max |JAX|."""
    import jax
    import jax.numpy as jnp

    from xpt_mde_tpu.ops.pallas.correlation import correlation_cost_pallas

    _, md, stride = _level_shape(level)
    shape_nhwc = (2, 8, 16, 12)
    n2 = corr.correlation_channels(md, stride)
    rng = np.random.RandomState(level)
    cl, cr, cot = (np.asarray(jnp.asarray(rng.uniform(-1, 1, s), jnp.bfloat16))
                   for s in (shape_nhwc, shape_nhwc, shape_nhwc[:3] + (n2,)))
    out, vjp = jax.vjp(lambda a, b: correlation_cost_pallas(a, b, md, stride, interpret=True),
                       jnp.asarray(cl), jnp.asarray(cr))
    dcl, dcr = vjp(jnp.asarray(cot))

    def nchw(x):
        return np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2))

    plan_shape = (32,) + _level_shape(level)[0][1:]  # the level's own plan
    got = {"K2": _emulate_k2_bf16(nchw(cl), nchw(cr), md, stride,
                                  kcorr.fwd_plan_bf16(*plan_shape, md, stride)),
           "K3": _emulate_k3_bf16(nchw(cot), nchw(cr), md, stride,
                                  kcorr.bwd_cl_plan_bf16(*plan_shape, md, stride)),
           "K4": _emulate_k4_bf16(nchw(cot), nchw(cl), md, stride,
                                  kcorr.bwd_cr_plan_bf16(*plan_shape, md, stride))}
    for name, want in (("K2", out), ("K3", dcl), ("K4", dcr)):
        rounded = torch.from_numpy(got[name]).to(torch.bfloat16).float()
        err, excess = chip_smoke.bf16_ulp_excess(rounded, torch.from_numpy(nchw(want)))
        assert excess <= 1.0, (name, err, excess)


# --------------------------------------------------------------- the card


@pytest.mark.parametrize("shape,md,stride", EDGE_SHAPES + [((1, 4, 8, 16), 4, 2)])
def test_the_gradients_need_g_only_at_the_terms_the_bound_counts(shape, md, stride):
    """``chip_smoke._valid_terms`` counts the (pixel, displacement) terms
    whose displaced position lies in the frame, and K3 and K4 read g only
    there: g zeroed at every other term gives the same dcl and dcr. The
    byte count of their bound takes g at those terms alone."""
    batch, chans, height, width = shape
    n = kcorr.num_displacements(md, stride)
    rng = np.random.RandomState(7)
    cl, cr = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
              for _ in range(2))
    g = torch.from_numpy(rng.uniform(-1, 1, (batch, n * n, height, width)).astype(np.float32))
    ones = torch.ones((1, 1, height, width))
    in_frame = corr.correlation_cost_plain(ones, ones, md, stride) != 0
    assert int(in_frame.sum()) == chip_smoke._valid_terms(height, width, md, stride)
    g_in = g * in_frame
    assert torch.equal(corr.correlation_grad_cl_plain(g_in, cr, md, stride),
                       corr.correlation_grad_cl_plain(g, cr, md, stride))
    assert torch.equal(corr.correlation_grad_cr_plain(g_in, cl, md, stride),
                       corr.correlation_grad_cr_plain(g, cl, md, stride))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    yield torch.device("cuda")


def _offset_copy(t):
    """``t`` as a contiguous view one value into a larger buffer: not
    16-byte aligned, so the kernels stage it with their threads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _card_case(shape, md, stride, seed, device):
    generator = torch.Generator().manual_seed(seed)
    cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(device, torch.bfloat16)
              for _ in range(2))
    n2 = corr.correlation_channels(md, stride)
    g = (torch.rand((shape[0], n2) + shape[2:], generator=generator) * 2 - 1).to(
        device, torch.bfloat16)
    return cl, cr, g


def _check_on_card(cl, cr, g, md, stride):
    ref = {"K2": corr.correlation_cost_plain(cl, cr, md, stride),
           "K3": corr.correlation_grad_cl_plain(g, cr, md, stride),
           "K4": corr.correlation_grad_cr_plain(g, cl, md, stride)}
    kernels = (kcorr.K2_BF16, kcorr.K3_BF16, kcorr.K4_BF16)
    before = [k.launches for k in kernels]
    got = {"K2": kcorr.K2_BF16(cl, cr, md, stride), "K3": kcorr.K3_BF16(g, cr, md, stride),
           "K4": kcorr.K4_BF16(g, cl, md, stride)}
    shifted = {"K2": kcorr.K2_BF16(_offset_copy(cl), _offset_copy(cr), md, stride),
               "K3": kcorr.K3_BF16(_offset_copy(g), _offset_copy(cr), md, stride),
               "K4": kcorr.K4_BF16(_offset_copy(g), _offset_copy(cl), md, stride)}
    assert [k.launches for k in kernels] == [c + 2 for c in before]
    leaves = [cl.clone().requires_grad_(True), cr.clone().requires_grad_(True)]
    auto = dict(zip(("K3", "K4"), torch.autograd.grad(
        corr.correlation_cost_plain(*leaves, md, stride), leaves, g)))
    torch.cuda.synchronize()
    for name in ("K2", "K3", "K4"):
        assert got[name].dtype == torch.bfloat16, name
        assert chip_smoke.bf16_ulp_excess(got[name], ref[name])[1] <= 1.0, name
        assert torch.equal(got[name], shifted[name]), name
    for name in ("K3", "K4"):
        assert chip_smoke.bf16_ulp_excess(got[name], auto[name])[1] <= 1.0, name


@pytest.mark.gpu
@pytest.mark.parametrize("level", LEVELS)
def test_bf16_tc_kernels_match_plain_at_pwc_levels(cuda, level):
    """K2-bf16, K3-bf16 and K4-bf16 at the flow stage's shapes: one ulp of
    the plain versions (K3 and K4 also of the plain autograd), offset runs
    bit-equal."""
    shape, md, stride = _level_shape(level)
    _check_on_card(*_card_case(shape, md, stride, level + 10, cuda), md, stride)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,md,stride", EDGE_SHAPES)
def test_bf16_tc_kernels_match_plain_at_edge_shapes(cuda, shape, md, stride):
    _check_on_card(*_card_case(shape, md, stride, sum(shape) + 3, cuda), md, stride)
