"""The band modules of a spatial mesh (``parallel.spatial``) against their
one-process selves: each module runs on its bands in the ranks of a
spatial group, forward and backward, and on the whole map in one process,
from the same seeded inputs, weights and cotangents.

``rank_modules`` is the rank side (``tools.ddp_check.run_ranks`` spawns
it), on the rank's device, the map modules in float32 or bfloat16;
``errors`` gives each result's distance from the whole map, which
``tests/test_torch_spatial.py`` and ``chip_smoke.py`` phase 30 hold to
FLOAT32_RTOL and BF16_RTOL. A module's input is a band of an H-row map
and its output a band or, where its height does not divide, the whole
map; the loss terms give each rank its bands' share of every sample's
value (summed over the ranks here).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# (name, H) of each case's input; W = 12, batch 2
_HEIGHTS = {"odd": 10, "even": 16}
# a loss case's frame that two bands do not divide: every rank holds it whole
_WHOLE_HEIGHTS = {"nine": 9}
WIDTH = 12
# the bands' result against the whole map's, the largest difference over
# the largest value: float32, the same sums grouped by band; bfloat16 (the
# map modules of a bf16 step), each result rounded to bf16 in both runs
# (2^-8 of a value at most) and the bands' partial sums (a halo row's
# gradient, a parameter's over the rows, a pool's window) rounded apart
# before they add: a few such ulps of the largest value. A band that
# drops or misplaces a halo row, or a collective whose backward loses a
# rank's share, is off by the size of that contribution, O(0.1-1)
FLOAT32_RTOL = 4e-6
BF16_RTOL = 2.0 ** -5


def _conv(k, s, groups=1, channels=4):
    from xpt_mde_tpu_torch.models.layers import Conv2dSame

    def build(gen, dtype):
        conv = Conv2dSame(channels, 4 if groups == 1 else channels, k, s, groups=groups,
                          dtype=dtype)
        conv.init_weights(gen)
        with torch.no_grad():
            conv.bias.normal_(generator=gen)
        return conv, (channels,)
    return build


def _batch_norm(gen, dtype):
    from xpt_mde_tpu_torch.models.layers import BatchNorm2d
    norm = BatchNorm2d(4, dtype)
    with torch.no_grad():
        norm.weight.normal_(generator=gen)
        norm.bias.normal_(generator=gen)
    return norm, (4,)


def _squeeze_excite(gen, dtype):
    from xpt_mde_tpu_torch.models.backbones.efficientnet import SqueezeExcite
    from xpt_mde_tpu_torch.models.layers import Conv2dSame
    se = SqueezeExcite(8, 2, dtype)
    for m in se.modules():
        if isinstance(m, Conv2dSame):
            m.init_weights(gen)
    return se, (8,)


def _conv_transpose(gen, dtype):
    from xpt_mde_tpu_torch.models.layers import ConvTranspose
    up = ConvTranspose(4, 4, dtype)
    up.init_weights(gen)
    with torch.no_grad():
        up.bias.normal_(generator=gen)
    return up, (4,)


def _dilated(dilation):
    def build(gen, dtype):
        from xpt_mde_tpu_torch.models.layers import Conv
        conv = Conv(4, 4, dilation=dilation, dtype=dtype)
        conv.Conv_0.init_weights(gen)
        with torch.no_grad():
            conv.Conv_0.bias.normal_(generator=gen)
        return conv, (4,)
    return build


def _cost_volume(md, stride):
    """PWC-Net's cost volume of the input's first 4 channels (cl) against
    its last 4 (cr): on a band, against cr's rows the band reads
    (``spatial.correlation_rows``: the halo where md is at most the band's
    rows, else the whole map)."""
    def f(x):
        from xpt_mde_tpu_torch.ops.correlation import correlation_cost
        from xpt_mde_tpu_torch.parallel import spatial
        cr, row_offset = spatial.correlation_rows(x[:, 4:].contiguous(), md)
        return correlation_cost(x[:, :4].contiguous(), cr, md, stride, row_offset)
    return f


def _feature_warp(x):
    """PWC-Net's feature warp: the input's last 4 channels (the features,
    gathered whole on a band) sampled at grid - flow, the flow its first 2
    channels in float32 (pixels of order 1), at the band's target rows."""
    from xpt_mde_tpu_torch.ops.flow_warp import flow_bilinear_sample
    from xpt_mde_tpu_torch.utils.precision import at_least_f32
    feats = x[:, 2:].permute(0, 2, 3, 1)
    flow = at_least_f32(x[:, :2]).permute(0, 2, 3, 1)
    return flow_bilinear_sample(feats, flow).permute(0, 3, 1, 2)


def _flow_coords(x):
    """The flow's pixel coordinates (grid - flow) at the band's global rows,
    as a [N, 2, H, W] map."""
    from xpt_mde_tpu_torch.ops.flow_warp import flow_to_pixel_coords
    flow = x.permute(0, 2, 3, 1)[:, None]
    return flow_to_pixel_coords(flow).reshape(x.shape)


def _fn(f, channels=3):
    def build(gen, dtype):
        return f, (channels,)
    return build


def _upsample_nearest(x):
    from xpt_mde_tpu_torch.models.layers import upsample_2x_nchw
    return upsample_2x_nchw(x, "nearest")


def _upsample_bilinear(x):
    from xpt_mde_tpu_torch.models.layers import upsample_2x_nchw
    return upsample_2x_nchw(x, "bilinear")


def _resize_half(x):
    from xpt_mde_tpu_torch.parallel import spatial
    from xpt_mde_tpu_torch.utils.image import resize_nchw
    return resize_nchw(x, spatial.global_rows(x) // 2, x.shape[-1] // 2, "bilinear")


def _max_pool(x):
    from xpt_mde_tpu_torch.models.layers import max_pool_same
    return max_pool_same(x, 3, 2)


def _avg_pool(x):
    from xpt_mde_tpu_torch.models.layers import avg_pool_same_excluding_pad
    return avg_pool_same_excluding_pad(x, 3)


# the map modules: name -> (build(generator, compute dtype) -> (module or
# function, (C,)), height)
MAP_CASES = {
    **{f"conv k{k} s{s} {h}": (_conv(k, s), h) for k in (1, 3, 5) for s in (1, 2)
       for h in _HEIGHTS},
    "depthwise k3 s1 odd": (_conv(3, 1, groups=4), "odd"),
    "depthwise k5 s2 even": (_conv(5, 2, groups=4), "even"),
    "depthwise k5 s1 even": (_conv(5, 1, groups=4), "even"),
    "batch norm even": (_batch_norm, "even"),
    "batch norm odd": (_batch_norm, "odd"),
    "squeeze excite even": (_squeeze_excite, "even"),
    "upsample nearest even": (_fn(_upsample_nearest), "even"),
    "upsample bilinear odd": (_fn(_upsample_bilinear), "odd"),
    "resize half even": (_fn(_resize_half), "even"),
    "max pool k3 s2 even": (_fn(_max_pool), "even"),
    "count-excluding pool k3 odd": (_fn(_avg_pool), "odd"),
    # the flow stage's (PWC-Net's) band modules: the 2x upsampler, a
    # dilated context conv whose halo fits the band and one (dilation 16)
    # that takes the gather rule, the cost volume on the halo route (md 4
    # against 8-row bands) and on the gathered one (md 12), the feature warp
    # and the flow's pixel coordinates
    "conv transpose 4x4 s2 even": (_conv_transpose, "even"),
    "conv k3 dilation 4 even": (_dilated(4), "even"),
    "conv k3 dilation 16 even": (_dilated(16), "even"),
    "cost volume halo md 4 s2 even": (_fn(_cost_volume(4, 2), 8), "even"),
    "cost volume gathered md 12 s4 even": (_fn(_cost_volume(12, 4), 8), "even"),
    "feature warp even": (_fn(_feature_warp, 6), "even"),
    "flow coords even": (_fn(_flow_coords, 2), "even"),
}
# the loss terms, per sample: name -> H; the joint step's full-resolution
# terms (their views at full and half size, the flow-warped views at half
# size: bands at 16 rows, the half-size maps whole at 10, every map whole
# at 9)
LOSS_CASES = {"ssim even": "even", "ssim odd": "odd", "smoothness even": "even",
              "smoothness odd": "odd", "flowL2 even": "even", "flow_reg even": "even",
              **{f"{kind}{method} even": "even" for kind in ("cmb", "md2", "md2cmb")
                 for method in ("L1", "SSIM")},
              "cmbSSIM odd": "odd", "md2cmbL1 odd": "odd", "md2cmbL1 nine": "nine",
              "md2SSIM nine": "nine"}


def _whole(t: torch.Tensor, mesh, dim: int) -> np.ndarray:
    """A band of every rank, gathered along ``dim`` (no autograd), float32."""
    buf = torch.zeros((mesh.spatial,) + tuple(t.shape), dtype=torch.float32, device=t.device)
    buf[mesh.spatial_index] = t
    dist.all_reduce(buf, group=mesh.spatial_group)
    return torch.cat(buf.unbind(0), dim).cpu().numpy()


def _summed(t: torch.Tensor, mesh) -> np.ndarray:
    t = t.float().clone()
    dist.all_reduce(t, group=mesh.spatial_group)
    return t.cpu().numpy()


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _band(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    rows = x.shape[dim] // mesh.spatial
    return x.narrow(dim, mesh.spatial_index * rows, rows).contiguous()


def _map_case(mesh, name: str, seed: int, dtype: torch.dtype) -> dict:
    from xpt_mde_tpu_torch.parallel import spatial
    from xpt_mde_tpu_torch.parallel.multihost import reducing_over

    build, height = MAP_CASES[name]
    rows = _HEIGHTS[height]
    gen = torch.Generator().manual_seed(seed)
    module, (channels,) = build(gen, dtype)
    params = list(module.parameters()) if isinstance(module, torch.nn.Module) else []
    if isinstance(module, torch.nn.Module):
        module.to(mesh.device).train()
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((2, channels, rows, WIDTH)).astype(np.float32))
    x = x.to(mesh.device, dtype)

    # one process
    xw = x.clone().requires_grad_()
    out = module(xw)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    g = g.to(mesh.device, out.dtype)
    (out * g).sum().backward()
    whole = {"out": _numpy(out), "dx": _numpy(xw.grad),
             "dparams": [_numpy(p.grad) for p in params]}
    for p in params:
        p.grad = None

    # on the bands
    xb = _band(x, mesh, 2).requires_grad_()
    with reducing_over(mesh.group), spatial.banded(mesh):
        spatial.register(xb, rows)
        out_b = module(xb)
        known = spatial.state(out_b)
        is_band = known is not None and known[1]
        share = _band(g, mesh, 2) if is_band else g * float(mesh.spatial_index == 0)
        (out_b * share).sum().backward()
    band = {"out": _whole(out_b.detach(), mesh, 2) if is_band else _numpy(out_b),
            "dx": _whole(xb.grad, mesh, 2),
            "dparams": [_summed(p.grad, mesh) for p in params],
            "out_is_band": is_band}
    return {"whole": whole, "band": band}


def _loss_case(mesh, name: str, seed: int, dtype: torch.dtype) -> dict:
    """A loss term in float32 (``dtype`` unused: a bf16 step's depth and
    frames reach the losses in float32). ``dims``: the rows' axes of the
    differentiated input and of the other one, each cut to bands, or None
    for one that every rank holds whole (its gradient then summed over the
    ranks). The bands run inside ``reducing_over`` the group, as a step
    does (md2cmb's kept-pixel count over the mesh)."""
    from xpt_mde_tpu_torch.losses.photometric import (photometric_loss_l2,
                                                      photometric_loss_ssim)
    from xpt_mde_tpu_torch.losses import total
    from xpt_mde_tpu_torch.ops.flow_warp import flow_warp_multi_scale
    from xpt_mde_tpu_torch.parallel import spatial
    from xpt_mde_tpu_torch.parallel.multihost import reducing_over
    from xpt_mde_tpu_torch.utils.image import multi_scale_like, resize_image

    rows = (_HEIGHTS | _WHOLE_HEIGHTS)[LOSS_CASES[name]]
    rng = np.random.RandomState(seed)
    if name.startswith("flowL2"):
        # the flow [B, N, H, W, 2] (pixels of order 1) warps the whole
        # sources; the L2 against the target at the flow's rows
        pred = rng.uniform(-1.5, 1.5, (2, 2, rows, WIDTH, 2)).astype(np.float32)
        other = rng.uniform(-1, 1, (2, 3, rows, WIDTH, 3)).astype(np.float32)
        dims = (2, None)

        def fn(p, o):
            spatial.register(o, rows, 2)
            target = multi_scale_like(o[:, -1], [p])[0]
            return photometric_loss_l2(flow_warp_multi_scale(o[:, :-1], [p])[0], target)
    elif name.startswith("flow_reg"):
        # weights that every rank holds whole
        pred = rng.standard_normal((3, 5)).astype(np.float32)
        other = rng.uniform(-1, 1, (2, 3, rows, WIDTH, 3)).astype(np.float32)
        dims = (None, None)

        def fn(p, o):
            return total.L2Regularizer()({"image5d": o}, {"regularize_weights": [p]}, {})
    elif name.startswith(("cmb", "md2")):
        # the synthesized views [B, N, H, W, 3] (10% black, invalid; whole
        # on every rank at 9 rows), and from them the half-size scale; the
        # frames whole on every rank: the target and the flow-warped views,
        # at half size (a band where its height allows)
        term = name.split()[0]
        method = "SSIM" if term.endswith("SSIM") else "L1"
        loss = {"cmb": total.CombinedLossMultiScale, "md2": total.MonoDepth2LossMultiScale,
                "md2cmb": total.MD2CombLossMultiScale}[term[:-len(method)]](method, [1.0, 0.5])
        pred = rng.uniform(-1, 1, (2, 2, rows, WIDTH, 3)).astype(np.float32)
        pred[rng.rand(2, 2, rows, WIDTH) < 0.1] = 0.0
        other = rng.uniform(-1, 1, (2, 3, rows, WIDTH, 3)).astype(np.float32)
        dims = (None if LOSS_CASES[name] in _WHOLE_HEIGHTS else 2, None)

        def fn(p, o):
            spatial.register(o, rows, 2)
            size = (rows // 2, WIDTH // 2)
            with spatial.suspended():
                warped = resize_image(o[:, :2], *size)
            return loss(None, None, {"synth_target_ms": [p, resize_image(p, *size)],
                                     "warped_target_ms": [spatial.to_band(warped, 2)],
                                     "target": o[:, -1]})
    elif name.startswith("ssim"):
        pred = rng.uniform(-1, 1, (2, 2, rows, WIDTH, 3)).astype(np.float32)
        pred[:, :, :2, :3] = 0.0  # black (invalid) pixels
        other = rng.uniform(-1, 1, (2, rows, WIDTH, 3)).astype(np.float32)
        dims = (2, 1)

        def fn(p, o):
            return photometric_loss_ssim(p, o)
    else:
        pred = rng.uniform(0.1, 2.0, (2, rows, WIDTH, 1)).astype(np.float32)
        other = rng.uniform(-1, 1, (2, rows, WIDTH, 3)).astype(np.float32)
        dims = (1, 1)
        smooth = total.SmoothenessLossMultiScale([1.0])

        def fn(p, o):
            return smooth.smootheness_loss(p, o)
    g = torch.from_numpy(rng.standard_normal(2).astype(np.float32)).to(mesh.device)
    pred, other = (torch.from_numpy(a).to(mesh.device) for a in (pred, other))

    pw = pred.clone().requires_grad_()
    out = fn(pw, other)
    (out * g).sum().backward()
    whole = {"out": _numpy(out), "dx": _numpy(pw.grad)}

    pb = (pred.clone() if dims[0] is None else _band(pred, mesh, dims[0])).requires_grad_()
    ob = other if dims[1] is None else _band(other, mesh, dims[1])
    with reducing_over(mesh.group), spatial.banded(mesh):
        for t, dim in zip((pb, ob), dims):
            if dim is not None:
                spatial.register(t, rows, dim)
        out_b = fn(pb, ob)
        (out_b * g).sum().backward()
    band = {"out": _summed(out_b.detach(), mesh),
            "dx": _summed(pb.grad, mesh) if dims[0] is None else _whole(pb.grad, mesh, dims[0])}
    return {"whole": whole, "band": band}


def rank_modules(mesh, names: list, seed: int = 0,
                 dtype: torch.dtype = torch.float32) -> dict:
    """Each case of ``names`` (MAP_CASES, LOSS_CASES) on this rank's bands
    of a spatial mesh ``{"data": 1, "spatial": W}`` and in one process, on
    the rank's device (float32 without TF32), the map modules computing in
    ``dtype``: {name: {"whole": ..., "band": ...}} with the outputs, the
    input's gradient and the parameters' gradients (summed over the
    ranks), float32 numpy."""
    from xpt_mde_tpu_torch.parallel import make_mesh
    from xpt_mde_tpu_torch.utils.precision import full_f32

    mesh = make_mesh({"data": 1, "spatial": mesh.world_size}, group=mesh.group,
                     device=mesh.device)
    out = {}
    with full_f32():
        for i, name in enumerate(names):
            case = _map_case if name in MAP_CASES else _loss_case
            out[name] = case(mesh, name, seed + i, dtype)
    return out


def errors(case: dict) -> dict:
    """{result: the largest difference of the bands' from the whole map's,
    over the latter's largest value} of one case of :func:`rank_modules`
    (``out``, ``dx``, ``dparam i``); raises where the shapes differ."""
    whole, band = case["whole"], case["band"]
    pairs = [("out", whole["out"], band["out"]), ("dx", whole["dx"], band["dx"])]
    pairs += [(f"dparam {i}", w, b) for i, (w, b) in enumerate(
        zip(whole.get("dparams", []), band.get("dparams", [])))]
    out = {}
    for label, want, got in pairs:
        if got.shape != want.shape:
            raise ValueError(f"{label}: the bands give {got.shape}, the whole map {want.shape}")
        out[label] = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6)
    return out
