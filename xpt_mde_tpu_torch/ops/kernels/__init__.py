"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Each kernel's source lives in ``xpt_mde_tpu_torch/csrc``. It is compiled
with ``nvcc`` into a shared library with a plain C interface at first
use (:mod:`.build`), never at import, and loaded with ``ctypes``.
"""
