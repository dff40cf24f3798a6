"""Export and load inference artifacts (port of ``xpt_mde_tpu.serving.export``).

An artifact is a directory:

- ``predict.pt2``: the ``torch.export`` program of the model's eval-mode
  forward with the weights inside (``torch.export.save``);
- ``meta.json``: the description, the device, the input spec (each
  feature's shape and dtype), ``torch.__version__`` and the compute dtype.

Shapes are static, as the JAX package's are: one artifact per serving
shape, no dynamic dimensions. The program is the computation of
``training.train_step.make_predict_step``: a uint8 ``image5d*`` input is
decoded to [-1, 1] inside it, so an artifact exported from a loader's raw
batch takes uint8 snippets. It is traced outside ``inference_mode``, with
the model in eval mode (BatchNorm on its running statistics) and no
parameter needing a gradient.

Loading needs no model code of this package: ``load_predictor`` imports
``torch`` and the kernels' module ``xpt_mde_tpu_torch.ops.kernels``, the
one deviation from the JAX package's "loads with jax alone". A flow
model's program calls the registered operator ``xpt_mde::correlation_cost``
(the hand-written K2, or K2-bf16), which that module registers and whose
library it builds at the first call on the card.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

# registers torch.ops.xpt_mde.correlation_cost, which flow programs call
import xpt_mde_tpu_torch.ops.kernels.correlation  # noqa: F401
from xpt_mde_tpu_torch.utils.precision import full_f32

_ARTIFACT = "predict.pt2"
_META = "meta.json"


class _Predict(torch.nn.Module):
    """The predict step as a module: decode, then the model's forward."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, features: dict):
        from xpt_mde_tpu_torch.training.train_step import decode_image_features
        return self.model(decode_image_features(features))


def _spec(features: Mapping[str, torch.Tensor]) -> dict:
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype).removeprefix("torch.")}
            for k, v in features.items()}


def _compute_dtype(model: torch.nn.Module) -> str:
    dtypes = {str(m.compute_dtype).removeprefix("torch.") for m in model.modules()
              if hasattr(m, "compute_dtype")}
    return "bfloat16" if "bfloat16" in dtypes else "float32"


def export_predictor(model: torch.nn.Module, example_features: Mapping[str, Any], out_dir,
                     description: str = "") -> Path:
    """Trace ``model``'s eval-mode forward at the example's shapes and
    dtypes and save it with its weights.

    :param model: a built model (``ModelFactory(...).get_model()``) with its
        weights, on the device to serve from
    :param example_features: one feature batch (tensors or numpy arrays),
        fixing the input shapes and dtypes
    :param out_dir: the artifact directory (created; overwritten)
    :return: the artifact directory
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    features = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)))
                .to(device) for k, v in example_features.items()}
    was_training = model.training
    flags = [p.requires_grad for p in model.parameters()]
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    try:
        with full_f32():
            program = torch.export.export(_Predict(model), (features,))
    finally:
        for p, flag in zip(model.parameters(), flags):
            p.requires_grad_(flag)
        model.train(was_training)
    torch.export.save(program, out_dir / _ARTIFACT)
    meta = {"description": description, "device": str(device),
            "input_spec": _spec(features), "torch_version": torch.__version__,
            "compute_dtype": _compute_dtype(model)}
    (out_dir / _META).write_text(json.dumps(meta, indent=2))
    return out_dir


class ServingPredictor:
    """A loaded artifact: ``predictor(features) -> predictions`` at the
    exported shapes and dtypes only; another shape, dtype or feature set
    raises ``ValueError``."""

    def __init__(self, module: torch.nn.Module, meta: dict):
        self._module = module
        self.meta = meta
        self.device = torch.device(meta["device"])

    def __call__(self, features: Mapping[str, Any]):
        spec = self.meta["input_spec"]
        if set(features) != set(spec):
            raise ValueError(f"features {sorted(features)} do not match the artifact's "
                             f"{sorted(spec)}")
        inputs = {}
        for key, value in features.items():
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))
            dtype = str(value.dtype).removeprefix("torch.")
            if list(value.shape) != spec[key]["shape"] or dtype != spec[key]["dtype"]:
                raise ValueError(f"{key}: {dtype}{list(value.shape)} does not match the "
                                 f"exported {spec[key]['dtype']}{spec[key]['shape']}")
            inputs[key] = value.to(self.device)
        with full_f32(), torch.no_grad():
            return self._module(inputs)


def load_predictor(artifact_dir) -> ServingPredictor:
    artifact_dir = Path(artifact_dir)
    meta = json.loads((artifact_dir / _META).read_text())
    program = torch.export.load(artifact_dir / _ARTIFACT)
    return ServingPredictor(program.module(), meta)
