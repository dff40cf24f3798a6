"""Flax variables -> the port's ``state_dict``.

The JAX model's variables are ``{"params": ..., "batch_stats": ...}``,
nested dicts of arrays whose paths name modules explicitly (``Conv_0``,
``MBConv_k/Conv_i``, ``DepthDecoder_0/UpconvBlock_j/...``). The port's
modules carry the same names, so each leaf maps by its path:

- conv ``kernel`` HWIO -> ``weight`` OIHW (a depthwise [kh, kw, 1, C]
  kernel becomes [C, 1, kh, kw] by the same transpose);
- transpose-conv (``ConvTranspose_*``) ``kernel`` HWIO -> ``weight``
  [in, out, kh, kw] with both spatial axes flipped: flax correlates the
  dilated input with the kernel as it is, ``conv_transpose2d`` flips it
  (``models/layers.py::ConvTranspose``);
- conv / BatchNorm ``bias`` -> ``bias``; BatchNorm ``scale`` -> ``weight``;
- BatchNorm ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- EfficientNet ``input_mean`` / ``input_var`` -> the buffers of that name.

Conversion fails if a flax leaf has no torch counterpart or the wrong
shape, or if a torch tensor is left unset. Parameters and statistics are
float32 on both sides whatever the compute dtype (a bfloat16 model casts
at call time), so a narrower floating tensor on either side fails too. :func:`flax_params_to_torch`
maps a params-only tree (gradients, updated parameters) the same way onto
``named_parameters()`` names. BatchNorm's
``num_batches_tracked`` has no flax counterpart (the momentum is fixed)
and is set to 0. :func:`state_dict_to_flax` runs the map backwards, so a
module's weights can be written in the flax layout (a pretrained
backbone file, ``utils/flax_msgpack.py``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var",
               "input_mean": "input_mean", "input_var": "input_var"}


def _leaves(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _map_leaf(collection: str, path: tuple[str, ...],
              value: np.ndarray) -> tuple[str, np.ndarray]:
    *modules, name = path
    names = {"params": _PARAM_NAMES, "batch_stats": _STAT_NAMES}.get(collection, {})
    if name not in names:
        raise KeyError(f"unmapped flax leaf {collection}/{'/'.join(path)}")
    if name == "kernel":
        if value.ndim != 4:
            raise ValueError(f"{'/'.join(path)}: expected a 4-D conv kernel, "
                             f"got shape {value.shape}")
        if modules and modules[-1].startswith("ConvTranspose"):
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            value = value.transpose(3, 2, 0, 1)
    return ".".join(modules + [names[name]]), value


def _check_wide(where: str, leaf_dtype: np.dtype, dtype: torch.dtype) -> None:
    """Refuse a floating leaf or tensor narrower than float32."""
    leaf_dtype = np.dtype(leaf_dtype)  # bfloat16 leaves have kind "V" (ml_dtypes)
    if (leaf_dtype.kind not in "iub" and leaf_dtype.itemsize < 4) or (
            dtype.is_floating_point and dtype.itemsize < 4):
        raise TypeError(f"{where}: parameters and statistics stay float32 (got the leaf in "
                        f"{leaf_dtype}, the tensor in {dtype})")


def _convert(variables: Mapping[str, Any],
             target: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Map every leaf of ``variables`` onto its key in ``target``, checking
    that the key exists, is hit once and has the leaf's shape."""
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            key, value = _map_leaf(collection, path, np.asarray(leaf))
            where = f"{collection}/{'/'.join(path)}"
            if key not in target:
                raise KeyError(f"flax leaf {where} has no torch tensor {key!r}")
            if key in out:
                raise KeyError(f"two flax leaves map to {key!r} (second: {where})")
            ref = target[key]
            _check_wide(where, value.dtype, ref.dtype)
            if tuple(value.shape) != tuple(ref.shape):
                raise ValueError(f"{where}: shape {value.shape} does not fit "
                                 f"{key} {tuple(ref.shape)}")
            out[key] = torch.tensor(np.ascontiguousarray(value), dtype=ref.dtype)
    return out


def _check_complete(out: Mapping[str, torch.Tensor], target) -> None:
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} torch tensors left unset, e.g. {missing[:5]}")


def flax_to_state_dict(variables: Mapping[str, Any],
                       model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Map flax ``variables`` onto ``model``'s state_dict keys and shapes."""
    target = model.state_dict()
    out = _convert(variables, target)
    for key, ref in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(ref, device="cpu")
    _check_complete(out, target)
    return out


def flax_params_to_torch(params: Mapping[str, Any],
                         model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Map a params-only flax tree (parameters, gradients or updated
    parameters, shaped like ``variables["params"]``) onto ``model``'s
    ``named_parameters()`` names, with the same kernel transposes."""
    target = dict(model.named_parameters())
    out = _convert({"params": params}, target)
    _check_complete(out, target)
    return out


_STAT_LEAVES = {torch_name: flax_name for flax_name, torch_name in _STAT_NAMES.items()}


def state_dict_to_flax(model: torch.nn.Module) -> dict[str, dict]:
    """The inverse of :func:`flax_to_state_dict`: ``model``'s state_dict as
    a flax ``{"params", "batch_stats"}`` tree of float32 numpy arrays, with
    the kernel transposes run backwards (a 4-D ``weight`` is a conv kernel,
    a 1-D one a BatchNorm scale). ``num_batches_tracked`` has no flax
    counterpart and is left out; a tensor of another kind raises."""
    trees: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in model.state_dict().items():
        *modules, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        value = tensor.detach().cpu().numpy()
        if name in _STAT_LEAVES:
            collection, leaf = "batch_stats", _STAT_LEAVES[name]
        elif name == "weight" and value.ndim == 4:
            collection, leaf = "params", "kernel"
            if modules and modules[-1].startswith("ConvTranspose"):
                value = value.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                value = value.transpose(2, 3, 1, 0)
        elif name == "weight" and value.ndim == 1:
            collection, leaf = "params", "scale"
        elif name == "bias":
            collection, leaf = "params", "bias"
        else:
            raise KeyError(f"no flax leaf for the torch tensor {key} {tuple(value.shape)}")
        _check_wide(key, value.dtype, tensor.dtype)
        node = trees[collection]
        for module in modules:
            node = node.setdefault(module, {})
        node[leaf] = np.ascontiguousarray(value)
    return {name: tree for name, tree in trees.items() if tree or name == "params"}


def load_flax_variables(model: torch.nn.Module,
                        variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load flax ``variables`` into ``model`` (in place) and return it."""
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return model
