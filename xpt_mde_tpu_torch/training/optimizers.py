"""Optimizer factory with frozen nets (port of
``xpt_mde_tpu.training.optimizers``).

``adam`` / ``adam_constant`` is ``torch.optim.Adam`` with betas (0.9,
0.999) and eps 1e-8: lr * m_hat / (sqrt(v_hat) + eps), which is
``optax.adam``'s update. ``sgd`` / ``sgd_constant`` is plain
``torch.optim.SGD``: -lr * g, as ``optax.sgd``. The JAX package freezes a
net with ``optax.set_to_zero``; here a frozen net's parameters are left
out of the optimizer, so they never move (their BatchNorm running
statistics still update in train mode, as in JAX).
"""

from __future__ import annotations

from typing import Sequence

import torch


def optimizer_factory(name: str, learning_rate: float, model: torch.nn.Module,
                      frozen_nets: Sequence[str] = ()) -> torch.optim.Optimizer:
    """:param model: the VodeModel; its top-level children are the nets
    (``depthnet``, ``posenet``, ...) that ``frozen_nets`` names."""
    frozen = set(frozen_nets)
    params = [p for net_name, net in model.named_children() if net_name not in frozen
              for p in net.parameters()]
    if name in ("adam", "adam_constant"):
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if name in ("sgd", "sgd_constant"):
        return torch.optim.SGD(params, lr=learning_rate)
    raise ValueError(f"invalid optimizer: {name}")
