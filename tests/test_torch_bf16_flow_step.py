"""One bfloat16 train step of the flow stage against the JAX bfloat16 step:
``LOSS_FLOW`` without ``flowL2_R``, PWCNet alone, regularized. The check
and its tolerances are those of test_torch_bf16_step.py, which holds the
rigid case of the same test; the stages are split over four files only
to keep each file's time on one worker near a minute and a half.
"""

import pytest

from test_torch_bf16_step import _four_threads, check_bf16_step  # noqa: F401


@pytest.mark.parametrize("stage", ["flow"])
def test_bf16_train_step_matches_jax(stage):
    check_bf16_step(stage)
