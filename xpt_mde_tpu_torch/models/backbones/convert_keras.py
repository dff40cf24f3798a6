"""keras backbone weights -> flax-layout numpy trees -> the port's modules
(port of ``xpt_mde_tpu.models.backbones.convert_keras``).

The JAX package initializes ``DepthNetPretrained`` backbones from keras
ImageNet weights: ``scripts/convert_backbone_weights.py`` converts a
``tf.keras.applications`` model into the flax ``(params, batch_stats)``
tree of its native twin and writes it to
``<datapath>/pretrained/<net>.msgpack``. This module yields the same
numpy trees, key for key and in the same order, so that the port writes
the same bytes (``utils/flax_msgpack.py``) and reads either package's
file; ``convert.py`` maps the trees onto the port's modules, which carry
the flax names.

Layout notes (keras -> flax):
- Conv2D kernels are [kh, kw, in, out] in both;
- DepthwiseConv2D kernels are [kh, kw, C, 1] -> grouped-conv [kh, kw, 1, C];
- SeparableConv2D -> ``{name}_dw`` + ``{name}_pw``;
- BN (gamma, beta, moving_mean, moving_variance) -> params (scale, bias)
  + batch_stats (mean, var);
- EfficientNet's input Rescaling/Normalization -> batch_stats
  ``input_mean`` / ``input_var``.

Nothing here imports TensorFlow: the keras model (or a weight dict read
from an H5 file, ``training/import_reference.py``) comes from the caller.
"""

from __future__ import annotations

import re

import numpy as np

from xpt_mde_tpu_torch.models.backbones.efficientnet import (_B0_STAGES, _SCALING,
                                                             round_repeats)

_BLOCK_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _short_name(weight_name: str) -> str:
    return weight_name.split("/")[-1].split(":")[0]


def _keras_weight_dict(keras_model) -> dict:
    """{layer_name: {short_weight_name: array}}, for keras 2 (prefixed
    weight names) and keras 3 (bare names) alike."""
    out = {}
    for layer in keras_model.layers:
        weights = {_short_name(w.name): np.asarray(w) for w in layer.weights}
        if weights:
            out[layer.name] = weights
    return out


def _bn(kw: dict, name: str):
    layer = kw[name]
    params = {"scale": layer["gamma"], "bias": layer["beta"]}
    stats = {"mean": layer["moving_mean"], "var": layer["moving_variance"]}
    return params, stats


def _conv(kw: dict, name: str, depthwise: bool = False, bias: bool = False):
    layer = kw[name]
    key = "depthwise_kernel" if ("depthwise_kernel" in layer) else "kernel"
    kernel = layer[key]
    if depthwise and kernel.shape[-1] == 1:  # [kh,kw,C,1] -> [kh,kw,1,C]
        kernel = np.transpose(kernel, (0, 1, 3, 2))
    out = {"kernel": kernel}
    if bias:
        out["bias"] = layer["bias"]
    return out


def convert_efficientnet(keras_model, variant: str = "B0"):
    """keras EfficientNet -> (params, batch_stats) of ``EfficientNet(variant)``.

    The input normalization is keras's Rescaling(1/255) + Normalization
    (+ the imagenet-only Rescaling(1/sqrt(std)), folded into the variance:
    ((x - m) / sqrt(v)) * r == (x - m) / sqrt(v / r^2)).

    :param keras_model: a ``tf.keras.applications.EfficientNetBx`` (any
        ``include_top``; ``weights`` None or 'imagenet')
    """
    mean = np.zeros(3, np.float32)
    var = np.ones(3, np.float32)
    for layer in keras_model.layers:
        cls = type(layer).__name__
        if cls == "Normalization" and layer.weights:
            w = {_short_name(v.name): np.asarray(v) for v in layer.weights}
            mean = w["mean"].reshape(3).astype(np.float32)
            var = w["variance"].reshape(3).astype(np.float32)
        elif cls == "Rescaling":
            scale = np.asarray(layer.get_config()["scale"], np.float32)
            if scale.ndim == 0 and np.isclose(scale, 1.0 / 255.0):
                continue  # the 0-255 rescale the module applies itself
            var = var / scale.reshape(3) ** 2
    return convert_efficientnet_kw(_keras_weight_dict(keras_model), variant, mean, var)


def convert_efficientnet_kw(kw: dict, variant: str = "B0", input_mean=None, input_var=None):
    """:func:`convert_efficientnet` over a weight dict ``{layer_name:
    {short_weight_name: array}}`` (an H5 file has no model object). The
    input normalization falls back to the dict's "normalization" layer
    (the TF-2.4 keras EfficientNet saves its mean and variance)."""
    params: dict = {}
    stats: dict = {}

    if input_mean is None:
        norm = kw.get("normalization", {})
        input_mean = norm.get("mean", np.zeros(3)).reshape(3).astype(np.float32)
        input_var = norm.get("variance", np.ones(3)).reshape(3).astype(np.float32)
    stats["input_mean"] = np.asarray(input_mean, np.float32).reshape(3)
    stats["input_var"] = np.asarray(input_var, np.float32).reshape(3)

    params["Conv_0"] = _conv(kw, "stem_conv")
    params["BatchNorm_0"], stats["BatchNorm_0"] = _bn(kw, "stem_bn")

    _, depth_mult = _SCALING[variant]
    mb_idx = 0
    for stage_idx, (expand, _, reps, _, _) in enumerate(_B0_STAGES):
        for rep in range(round_repeats(reps, depth_mult)):
            prefix = f"block{stage_idx + 1}{_BLOCK_LETTERS[rep]}"
            mb_params: dict = {}
            mb_stats: dict = {}
            conv_i = bn_i = 0
            if expand != 1:
                mb_params[f"Conv_{conv_i}"] = _conv(kw, f"{prefix}_expand_conv")
                mb_params[f"BatchNorm_{bn_i}"], mb_stats[f"BatchNorm_{bn_i}"] = _bn(
                    kw, f"{prefix}_expand_bn")
                conv_i += 1
                bn_i += 1
            mb_params[f"Conv_{conv_i}"] = _conv(kw, f"{prefix}_dwconv", depthwise=True)
            mb_params[f"BatchNorm_{bn_i}"], mb_stats[f"BatchNorm_{bn_i}"] = _bn(
                kw, f"{prefix}_bn")
            conv_i += 1
            bn_i += 1
            mb_params["SqueezeExcite_0"] = {
                "Conv_0": _conv(kw, f"{prefix}_se_reduce", bias=True),
                "Conv_1": _conv(kw, f"{prefix}_se_expand", bias=True),
            }
            mb_params[f"Conv_{conv_i}"] = _conv(kw, f"{prefix}_project_conv")
            mb_params[f"BatchNorm_{bn_i}"], mb_stats[f"BatchNorm_{bn_i}"] = _bn(
                kw, f"{prefix}_project_bn")
            params[f"MBConv_{mb_idx}"] = mb_params
            stats[f"MBConv_{mb_idx}"] = mb_stats
            mb_idx += 1
    return params, stats


def _autoname_map(layer_names) -> dict:
    """keras's auto-named layers (conv2d, conv2d_1, batch_normalization_3,
    ...) -> ``xres_conv_{i}`` / ``xres_bn_{i}`` by encounter order: their
    numeric suffixes come from a process-global keras counter, their order
    in the model does not. Xception's residual 1x1 convs and BNs are the
    unnamed ones.

    :param layer_names: layer names in model order (``model.layers`` or
        an H5 file's ``layer_names``)
    """
    mapping = {}
    conv_i = bn_i = 0
    for name in layer_names:
        if re.fullmatch(r"conv2d(_\d+)?", name):
            mapping[name] = f"xres_conv_{conv_i}"
            conv_i += 1
        elif re.fullmatch(r"batch_normalization(_\d+)?", name):
            mapping[name] = f"xres_bn_{bn_i}"
            bn_i += 1
    return mapping


def convert_keras_by_name(keras_model):
    """keras -> flax-layout trees for the flat keras-named backbones
    (ResNet50V2, DenseNet121, MobileNetV2, VGG16, Xception, NASNet).

    Their twins name every Conv and BatchNorm like the keras layer ("/"
    -> "_", keras-2.4 DenseNet style), so the conversion walks the layers:
    Conv2D / DepthwiseConv2D -> kernel (+ bias), SeparableConv2D ->
    ``{name}_dw`` + ``{name}_pw``, BatchNorm -> (scale, bias) params and
    (mean, var) batch_stats.

    :return: (params, batch_stats)
    """
    # keras 3 names DepthwiseConv2D kernels plain "kernel": found by class
    depthwise_layers = {layer.name for layer in keras_model.layers
                        if type(layer).__name__ == "DepthwiseConv2D"}
    return convert_keras_by_name_kw(_keras_weight_dict(keras_model),
                                    [layer.name for layer in keras_model.layers],
                                    depthwise_layers)


def convert_keras_by_name_kw(kw: dict, layer_order, depthwise_layers=()):
    """:func:`convert_keras_by_name` over a weight dict. TF-2.4 H5 files
    name depthwise kernels "depthwise_kernel"; ``depthwise_layers`` is
    needed only for keras-3 models, whose depthwise kernels are "kernel"."""
    rename = _autoname_map(layer_order)
    params: dict = {}
    stats: dict = {}
    for lname, w in kw.items():
        name = rename.get(lname, lname).replace("/", "_")
        if lname in depthwise_layers and "depthwise_kernel" not in w:
            w = dict(w)
            w["depthwise_kernel"] = w.pop("kernel")
        if "moving_mean" in w:
            p = {}
            if "gamma" in w:
                p["scale"] = w["gamma"]
            if "beta" in w:
                p["bias"] = w["beta"]
            params[name] = p
            stats[name] = {"mean": w["moving_mean"], "var": w["moving_variance"]}
        elif "depthwise_kernel" in w and "pointwise_kernel" in w:
            params[name + "_dw"] = {"kernel": np.transpose(w["depthwise_kernel"], (0, 1, 3, 2))}
            pw = {"kernel": w["pointwise_kernel"]}
            if "bias" in w:
                pw["bias"] = w["bias"]
            params[name + "_pw"] = pw
        elif "depthwise_kernel" in w:
            p = {"kernel": np.transpose(w["depthwise_kernel"], (0, 1, 3, 2))}
            if "bias" in w:
                p["bias"] = w["bias"]
            params[name] = p
        elif "kernel" in w:
            p = {"kernel": w["kernel"]}
            if "bias" in w:
                p["bias"] = w["bias"]
            params[name] = p
    return params, stats


def convert_backbone(keras_model, net_name: str):
    """EfficientNet by its structured converter, the others by name."""
    if net_name.startswith("EfficientNetB"):
        return convert_efficientnet(keras_model, net_name[-2:])
    return convert_keras_by_name(keras_model)


def convert_backbone_kw(kw: dict, layer_order, net_name: str):
    """:func:`convert_backbone` over a weight dict (an H5 file's)."""
    if net_name.startswith("EfficientNetB"):
        return convert_efficientnet_kw(kw, net_name[-2:])
    return convert_keras_by_name_kw(kw, layer_order)


def load_into_variables(module, params, batch_stats):
    """Graft converted (params, batch_stats) into ``module`` (in place),
    every converted leaf checked against its tensor's key and shape before
    any is loaded; tensors the trees do not name keep their values.

    :return: ``module``
    """
    from xpt_mde_tpu_torch.convert import _convert

    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    module.load_state_dict(_convert(variables, module.state_dict()), strict=False)
    return module
