"""One stereo train step of the port against the JAX package's under the
published recipes that run PWCNet: ``LOSS_RIGID_COMB`` (EfficientNetB0 +
PoseNetImproved + PWCNet, the flownet frozen) and ``LOSS_FLOW`` (PWCNet
alone, regularized). The cases, their checks and their tolerances are
those of test_torch_stereo_step.py, which holds the rigid recipes' cases
of the same test; they are split over two files only to keep each file's
time on one worker near a minute and a half.
"""

import pytest

from test_torch_stereo_step import _four_threads, check_stereo_step  # noqa: F401


@pytest.mark.parametrize("case", ["LOSS_RIGID_COMB", "LOSS_FLOW"])
def test_stereo_train_step_matches_jax(case):
    check_stereo_step(case)
