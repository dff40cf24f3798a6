"""One bfloat16 train step of the stereo stage against the JAX bfloat16
step: the published "MS" recipe on stereo snippets (EfficientNetB0 +
PoseNetImproved, the stereo pose), at CHECK_T_LR. The check and its
tolerances are those of test_torch_bf16_step.py, which holds the rigid
case of the same test; the stages are split over four files only to keep
each file's time on one worker near a minute and a half.
"""

import pytest

from test_torch_bf16_step import _four_threads, check_bf16_step  # noqa: F401


@pytest.mark.parametrize("stage", ["stereo"])
def test_bf16_train_step_matches_jax(stage):
    check_bf16_step(stage)
