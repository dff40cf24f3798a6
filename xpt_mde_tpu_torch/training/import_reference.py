"""Import reference (goodgodgd/xpt-mde-2021) keras H5 checkpoints (port of
``xpt_mde_tpu.training.import_reference``).

The reference saves each sub-net with ``keras.Model.save_weights`` into
``{depthnet,posenet,flownet}_{suffix}.h5``. Every weighted layer is named
there (``vo_conv*`` in the posenet, ``dp_*`` in the depth net, ``pwc_*``
in PWC-Net), so the map into the flax-layout trees of the JAX package's
modules, whose names the port's modules carry, is fixed by name.
:func:`read_keras_h5` reads the file (h5py, on the host);
:func:`convert_net_h5` and the ``*_params`` functions convert the weight
dict (numpy); :func:`import_reference_checkpoint` grafts the trees into
the model ``ModelFactory`` builds, leaf by leaf with shape checks, and
writes the port's own checkpoint layout (``{net}_{suffix}.pt`` with the
BatchNorm buffers, atomically), which ``train_by_plan`` and
``predict_by_plan`` load unchanged.

Weight layouts:
- keras Conv2D kernels are [kh, kw, in, out], as flax's;
- keras Conv2DTranspose kernels are [kh, kw, out, in] and the layer is
  the gradient of a convolution; flax's ConvTranspose is a fractionally
  strided convolution, so the kernel converts by a spatial flip and an
  in/out swap (:func:`deconv_kernel`);
- a DepthNetPretrained file keeps the keras-applications layer names of
  its backbone, converted by ``models/backbones/convert_keras.py``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

NETS = ("depthnet", "posenet", "flownet")


def read_keras_h5(path):
    """Read a keras legacy ``save_weights`` H5 file.

    :return: (layer_order, kw): ``kw`` maps each weighted layer's name to
        {short_weight_name: np.ndarray}, ``layer_order`` lists those names
        in model (creation) order. Nested models (the keras-applications
        backbone inside DepthNetPretrained) are flattened: a sub-layer's
        name is the second-to-last component of the saved weight path.
    """
    import h5py

    def _dec(value):
        return value.decode() if isinstance(value, bytes) else str(value)

    layer_order: list = []
    kw: dict = {}
    with h5py.File(path, "r") as f:
        group = f["model_weights"] if "model_weights" in f else f
        for top in [_dec(n) for n in group.attrs["layer_names"]]:
            grp = group[top]
            for wname in [_dec(n) for n in grp.attrs.get("weight_names", [])]:
                parts = wname.split("/")
                layer = parts[-2] if len(parts) >= 2 else top
                if layer not in kw:
                    kw[layer] = {}
                    layer_order.append(layer)
                kw[layer][parts[-1].split(":")[0]] = np.asarray(grp[wname])
    return layer_order, kw


def _conv(kw: dict, name: str) -> dict:
    """A named keras Conv2D -> the ``Conv`` module's subtree (one conv
    named ``Conv_0``)."""
    if name not in kw:
        raise KeyError(f"layer '{name}' missing from the H5 file")
    w = kw[name]
    leaf = {"kernel": w["kernel"]}
    if "bias" in w:
        leaf["bias"] = w["bias"]
    return {"Conv_0": leaf}


def deconv_kernel(kernel_tf: np.ndarray) -> np.ndarray:
    """keras Conv2DTranspose kernel [kh, kw, out, in] -> flax ConvTranspose
    kernel [kh, kw, in, out]: a spatial flip and an in/out swap."""
    return np.flip(kernel_tf, axis=(0, 1)).transpose(0, 1, 3, 2)


def _deconv(kw: dict, name: str) -> dict:
    w = kw[name]
    leaf = {"kernel": deconv_kernel(w["kernel"])}
    if "bias" in w:
        leaf["bias"] = w["bias"]
    return leaf


_POSE_ORDERS = {
    "PoseNetBasic": ["vo_conv1", "vo_conv2", "vo_conv3", "vo_conv4",
                     "vo_conv5", "vo_conv6", "vo_conv7"],
    "PoseNetImproved": ["vo_conv1", "vo_conv2", "vo_conv3", "vo_conv4",
                        "vo_conv5", "vo_conv6_1", "vo_conv6_2", "vo_conv6_3"],
    "PoseNetDeep": ["vo_conv0", "vo_conv1_1", "vo_conv1_2",
                    "vo_conv2_1", "vo_conv2_2", "vo_conv2_3",
                    "vo_conv3_1", "vo_conv3_2", "vo_conv3_3",
                    "vo_conv4_1", "vo_conv4_2", "vo_conv4_3",
                    "vo_conv5_1", "vo_conv5_2", "vo_conv5_3",
                    "vo_conv6_1", "vo_conv6_2", "vo_conv6_3"],
}


def posenet_params(kw: dict, variant: str = "PoseNetImproved", high_res: bool = False) -> dict:
    """H5 weights -> the params subtree of a pose net."""
    if variant not in _POSE_ORDERS:
        raise ValueError(f"unsupported posenet variant: {variant}")
    names = list(_POSE_ORDERS[variant])
    if high_res and variant != "PoseNetBasic":
        names += ["vo_conv7_1", "vo_conv7_2", "vo_conv7_3"]
    names.append("vo_conv8" if variant == "PoseNetBasic" else "vo_conv_last")
    return {f"Conv_{i}": _conv(kw, n) for i, n in enumerate(names)}


def _upconv_block(kw: dict, scope: str) -> dict:
    """dp_up{N}_conv1/_conv2 -> UpconvBlock."""
    return {"Conv_0": _conv(kw, scope + "_conv1"), "Conv_1": _conv(kw, scope + "_conv2")}


def _depth_head(kw: dict, scope: str) -> dict:
    """dp_depth{N}_conv -> ScaledDepthHead."""
    return {"Conv_0": _conv(kw, scope + "_conv")}


def _decoder_params(kw: dict) -> dict:
    """The shared 4-head decoder, in ``DepthDecoder``'s module order."""
    return {
        "UpconvBlock_0": _upconv_block(kw, "dp_up4"),
        "UpconvBlock_1": _upconv_block(kw, "dp_up3"),
        "ScaledDepthHead_0": _depth_head(kw, "dp_depth3"),
        "UpconvBlock_2": _upconv_block(kw, "dp_up2"),
        "ScaledDepthHead_1": _depth_head(kw, "dp_depth2"),
        "UpconvBlock_3": _upconv_block(kw, "dp_up1"),
        "ScaledDepthHead_2": _depth_head(kw, "dp_depth1"),
        "UpconvBlock_4": _upconv_block(kw, "dp_up0"),
        "ScaledDepthHead_3": _depth_head(kw, "dp_depth0"),
    }


_BASIC_ENCODER = ["dp_conv0b", "dp_conv1a", "dp_conv1b", "dp_conv2a",
                  "dp_conv2b", "dp_conv3a", "dp_conv3b", "dp_conv4a",
                  "dp_conv4b", "dp_conv5a", "dp_conv5b", "dp_conv6a",
                  "dp_conv6b", "dp_conv7a"]


def depthnet_params(kw: dict, layer_order, variant: str):
    """H5 weights -> (params, batch_stats) of a depth net.

    :param variant: the plan row's depth net name: DepthNetBasic,
        DepthNetNoResize or a backbone name (DepthNetPretrained)
    """
    if variant in ("DepthNetBasic", "DepthNetNoResize"):
        encoder = {f"Conv_{i}": _conv(kw, n) for i, n in enumerate(_BASIC_ENCODER)}
        params = {"BasicEncoder_0": encoder,
                  "UpconvBlock_0": _upconv_block(kw, "dp_up6"),
                  "UpconvBlock_1": _upconv_block(kw, "dp_up5"),
                  "DepthDecoder_0": _decoder_params(kw)}
        return params, {}

    # DepthNetPretrained: a keras-applications backbone + the dp_* decoder
    from xpt_mde_tpu_torch.models.backbones.convert_keras import convert_backbone_kw

    bb_kw = {k: v for k, v in kw.items() if not k.startswith("dp_")}
    bb_order = [k for k in layer_order if not k.startswith("dp_")]
    bb_params, bb_stats = convert_backbone_kw(bb_kw, bb_order, variant)
    params = {"backbone": bb_params, "DepthDecoder_0": _decoder_params(kw)}
    stats = {"backbone": bb_stats} if bb_stats else {}
    return params, stats


def _pwc_encoder(kw: dict, suffix: str) -> dict:
    """pwc_conv{1..6}{a,b,c}{suffix} -> PWCEncoder."""
    names = [f"pwc_conv{level}{sub}{suffix}" for level in range(1, 7) for sub in "abc"]
    return {f"Conv_{i}": _conv(kw, n) for i, n in enumerate(names)}


def _flow_predictor(kw: dict, prefix: str, dense32_name: str, up: bool) -> dict:
    """pwc_flow{p}_* -> FlowPredictor. The 32-channel dense conv is the
    reference's one unnamed layer (keras names it conv2d[_N]); its name
    comes in as ``dense32_name``."""
    params = {"Conv_0": _conv(kw, prefix + "c1"),
              "Conv_1": _conv(kw, prefix + "c2"),
              "Conv_2": _conv(kw, prefix + "c3"),
              "Conv_3": _conv(kw, prefix + "c4"),
              "Conv_4": _conv(kw, dense32_name),
              "Conv_5": _conv(kw, prefix + "out")}
    if up:
        params["ConvTranspose_0"] = _deconv(kw, prefix + "ct1")
        params["ConvTranspose_1"] = _deconv(kw, prefix + "ct2")
    return params


def flownet_params(kw: dict, layer_order) -> dict:
    """H5 weights -> the params subtree of PWC-Net."""
    # the five unnamed 32-channel predictor convs, in creation order
    # flow6 -> flow5 -> flow4 -> flow3 -> flow2
    unnamed = [n for n in layer_order if re.fullmatch(r"conv2d(_\d+)?", n)]
    if len(unnamed) != 5:
        raise ValueError(f"expected 5 auto-named predictor convs, found {unnamed}")
    params = {"encoder_l": _pwc_encoder(kw, "_l"), "encoder_r": _pwc_encoder(kw, "_r")}
    prefixes = ["pwc_flow6_", "pwc_flow5_", "pwc_flow4_", "pwc_flow3_", "pwc_flow2_"]
    for i, (prefix, d32) in enumerate(zip(prefixes, unnamed)):
        params[f"FlowPredictor_{i}"] = _flow_predictor(kw, prefix, d32, up=(i < 4))
    params["ContextNetwork_0"] = {f"Conv_{i}": _conv(kw, f"pwc_context_{i + 1}")
                                  for i in range(7)}
    return params


def convert_net_h5(path, net: str, net_names: dict, high_res: bool = False):
    """One reference H5 file -> the (params, batch_stats) subtrees of the
    matching net. ``net_names`` is the plan row's {"depth", "camera",
    "flow"} dict."""
    layer_order, kw = read_keras_h5(path)
    if net == "posenet":
        return posenet_params(kw, net_names["camera"], high_res), {}
    if net == "depthnet":
        return depthnet_params(kw, layer_order, net_names["depth"])
    if net == "flownet":
        if net_names.get("flow", "PWCNet") != "PWCNet":
            raise ValueError("only PWCNet flow checkpoints are supported")
        return flownet_params(kw, layer_order), {}
    raise ValueError(f"unknown net: {net}")


def import_reference_checkpoint(src_dir, out_dir, cfg, net_names: dict,
                                suffix: str = "latest") -> list:
    """Convert a reference checkpoint directory (``{net}_{suffix}.h5``
    files) into the port's per-net checkpoints ``{net}_{suffix}.pt``.

    The model is built from ``cfg`` and ``net_names`` as training builds
    it; each converted net is grafted leaf by leaf with shape checks and
    written with its BatchNorm buffers. The import computes nothing, so
    it builds on the CPU; the files load onto any device.

    :return: the imported net names
    """
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.models.backbones.convert_keras import load_into_variables
    from xpt_mde_tpu_torch.training.checkpoint import _save_atomic

    src_dir, out_dir = Path(src_dir), Path(out_dir)
    available = {net: src_dir / f"{net}_{suffix}.h5" for net in NETS
                 if (src_dir / f"{net}_{suffix}.h5").is_file()}
    if not available:
        raise FileNotFoundError(f"no {{net}}_{suffix}.h5 files under {src_dir}")

    model = ModelFactory({"image"}, net_names, cfg.depth_activation, stereo=False,
                         high_res=cfg.high_res, upsample_interp=cfg.depth_upsample_interp,
                         device="cpu").get_model()
    out_dir.mkdir(parents=True, exist_ok=True)
    imported = []
    for net, h5_path in available.items():
        module = getattr(model, net)
        if module is None:
            print(f"[import] {net} in checkpoint but not in net_names; skipped")
            continue
        net_params, net_stats = convert_net_h5(h5_path, net, net_names, cfg.high_res)
        load_into_variables(module, net_params, net_stats)
        _save_atomic(module.state_dict(), out_dir / f"{net}_{suffix}.pt")
        imported.append(net)
        print(f"[import] {net}: {h5_path.name} -> {net}_{suffix}.pt")
    return imported
