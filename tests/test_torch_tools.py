"""The port's measuring tools, as far as they run without a card."""

import pytest
import torch

from xpt_mde_tpu_torch.tools import profile_steps


def test_busy_time_is_the_union_of_intervals():
    intervals = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (6.0, 6.5), (10.0, 10.0)]
    assert profile_steps._busy_us(intervals) == 5.0
    assert profile_steps._busy_us([]) == 0.0


def test_profile_steps_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_steps.main([]) != 0
    assert capsys.readouterr().out == ""


def test_profile_steps_rejects_unknown_steps():
    with pytest.raises(SystemExit):
        profile_steps.main(["--steps", "train,flow-eval"])


def test_profile_steps_builds_the_flow_steps_on_the_batches_device():
    steps = profile_steps._build_steps(["flow-train", "flow-predict"],
                                       [{"image5d": torch.zeros(1)}])
    assert list(steps) == ["flow-train", "flow-predict"]
    assert all(label == "PWCNet" and callable(step) for label, step in steps.values())
