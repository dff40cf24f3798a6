"""xpt_mde_tpu_torch: the PyTorch / CUDA port of ``xpt_mde_tpu``.

The JAX package stays the reference; this package mirrors its module
paths and public names so each counterpart is easy to find, and it
imports ``torch`` only (never ``jax``, ``flax``, ``optax`` or the JAX
package). The configuration, synthetic data, shard IO and native
reader, and evaluation metrics it needs are copies (``config.py``,
``data/``, ``utils/util_class.py``, ``evaluate/``), held equal to the
reference's by the tests.

Layout conventions (the JAX ones, so the parity tests compare like with
like): snippets ``[B, S, H, W, C]``, pixel coordinates ``[B, N, 2, H*W]``,
NHWC tensors in the prediction dict. NCHW exists only inside the conv
modules.

Ported so far: the shard chain (``data/``: depth maps, the dataset
readers, ``ExampleMaker``, ``ShardMaker`` and the synthetic reader, run by
``python -m xpt_mde_tpu_torch.scripts.create_shards_main``), host numpy
that writes the JAX package's shards byte for byte; the entry point
(``training.trainer.train_by_plan``,
``evaluate.evaluate_main.predict_by_plan`` / ``evaluate_by_plan``, run by
``python -m xpt_mde_tpu_torch.scripts.train_main`` / ``evaluate_main``)
over the rigid stage's predict, eval and train steps (EfficientNet depth
net + PoseNetImproved, L1/SSIM/smoothness losses), the flow stage's
predict and train steps (PWC-Net, flowL2 + flow_reg) and the joint
stage's train step (the three nets, cmbL1/cmbSSIM, the flownet frozen).
On the card the view-synthesis and flow warps run as the hand-written
CUDA kernels K1 and K1-bwd (``ops/kernels/warp.py`` + ``csrc/warp.cu``)
and PWC-Net's cost volume as K2, with K3 and K4 for its gradient
(``ops/kernels/correlation.py`` + ``csrc/correlation.cu``). The nets
compute in ``Config.compute_dtype``: bfloat16 by default, as in the JAX
package (float32 parameters, float32 heads and geometry, bfloat16 K2, K3
and K4), or float32, the parity mode. ``parallel/`` trains over a data
mesh of one process a card (``torch.distributed``; ``train_main`` under
torchrun) with the JAX package's global-batch semantics, and ``serving/``
exports the predict step as a ``torch.export`` artifact that loads
without the model code.
"""

__version__ = "0.1.0"
