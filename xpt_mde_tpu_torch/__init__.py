"""xpt_mde_tpu_torch: the PyTorch / CUDA port of ``xpt_mde_tpu``.

The JAX package stays the reference; this package mirrors its module
paths and public names so each counterpart is easy to find, and it
imports ``torch`` only (never ``jax``, ``flax``, ``optax`` or the JAX
package). The constants and the numpy synthetic data it needs are
copies (``config.py``, ``data/``), held equal to the reference's by the
tests.

Layout conventions (the JAX ones, so the parity tests compare like with
like): snippets ``[B, S, H, W, C]``, pixel coordinates ``[B, N, 2, H*W]``,
NHWC tensors in the prediction dict. NCHW exists only inside the conv
modules.

Ported so far: the rigid stage's predict and eval steps (EfficientNet
depth net + PoseNetImproved, L1/SSIM/smoothness losses), with the view
synthesis warp running as the hand-written CUDA kernel K1
(``ops/kernels/warp.py`` + ``csrc/warp.cu``) on the card.
"""

__version__ = "0.1.0"
