"""A two-batch run of the miniature plan on the CPU through
``train_by_plan`` (``tools/check_learns.py::check_plan``): the hand-off,
finite metrics, the results ledger's record and the command line's
refusal without a card. Split from test_torch_mini_plan.py, whose
fixtures it shares, only to keep each file's time on one worker short.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_mini_plan import _no_tf32  # noqa: F401
from xpt_mde_tpu_torch.tools import check_learns
from xpt_mde_tpu_torch.utils import results


def test_two_batch_mini_plan_run_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``miniature_plan(1, 1, 1)`` through ``train_by_plan`` on the CPU,
    two steps a row at batch 2: the flownet after the joint row equals the
    flow row's tensor for tensor, the depth net changed, the metrics are
    finite; the check's record carries the device and the dtype."""
    result = check_learns.check_plan(tmp_path / "plan", "float32", device="cpu",
                                     rigid_epochs=1, flow_epochs=1, joint_epochs=1, batch=2,
                                     train_batches=2, val_batches=1)
    assert result["handoff"] == {"depth_pose_untouched_by_flow_row": True,
                                 "flownet_exact": True, "depth_changed_in_joint": True}
    assert list(result["trajectory"]) == ["init", "after_rigid", "after_flow", "after_joint"]
    assert all(np.isfinite(v) for m in result["trajectory"].values() for v in m.values())
    assert [r["steps"] for r in result["rows"]] == [2, 2, 2]
    assert all(r["launches"] == {} for r in result["rows"])  # the plain versions on the CPU
    ledger = tmp_path / "results.jsonl"
    results.record("plan_learns", check_learns.result_payload(result), "float32", ledger)
    entry = json.loads(ledger.read_text())
    assert entry["check"] == "plan_learns" and entry["card"] == "no CUDA device"
    assert entry["compute_dtype"] == "float32" and entry["cuda"] == torch.version.cuda
    assert entry["handoff"]["flownet_exact"] and "after_joint_abs_rel" in entry
    with pytest.raises(TypeError, match="unknown protocol"):
        check_learns.check_plan(tmp_path, steps=3)
    # the command line refuses to run without a card, printing no result
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert check_learns.main(["--check", "plan"]) == 1
    assert capsys.readouterr().out == ""
