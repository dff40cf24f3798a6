"""Serving: exported inference artifacts (port of ``xpt_mde_tpu.serving``).

``export_predictor`` traces a model's predict step once at fixed shapes
with ``torch.export`` and saves it with its weights; ``load_predictor``
loads it and runs it with no model code of this package, no checkpoint
plumbing and no retracing (``serving/export.py``).
"""

from xpt_mde_tpu_torch.serving.export import (ServingPredictor, export_predictor,
                                              load_predictor)

__all__ = ["ServingPredictor", "export_predictor", "load_predictor"]
