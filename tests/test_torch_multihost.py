"""The port's plan driver over two gloo processes (``parallel`` and
``training/trainer.py``): ``train_by_plan`` on a data mesh of two ranks,
against one process training the same plan.

Two rigid rows of one epoch each (DepthNetBasic + PoseNetBasic at 32x64,
no BatchNorm, so the comparisons are float32 summation order alone; the
default augmentation) on synthetic shards: 8 train snippets, a global
batch of 4 (2 a rank), 4 val snippets. The ranks read disjoint strided
slices of the shared shuffle order, so each global batch holds the rows
the one process reads in that step (in another order, which a step does
not see), and validation is reduced over the ranks. Only rank 0 writes the
config snapshot, the checkpoints and history.csv; a second run finds both
rows done and writes nothing.
"""

import csv
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1, Config, TrainStage
from xpt_mde_tpu_torch.tools import ddp_check
from xpt_mde_tpu_torch.training.trainer import train_by_plan

NETS = {"depth": "DepthNetBasic", "camera": "PoseNetBasic"}
RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
PLAN = [TrainStage(NETS, "synthetic", 1, 1e-4, RECIPE, SCALE_WEIGHT_T1, save_ckpt=False),
        TrainStage(NETS, "synthetic", 1, 2e-4, RECIPE, SCALE_WEIGHT_T1)]
COUNTS = {"train": 8, "val": 4}
LR_STEPS = 2 * 1e-4 + 2 * 2e-4  # Adam's first steps move a weight by at most this in all


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(root, world) -> Config:
    return Config(stereo=False, per_replica_batch=4 // world, mesh_shape={"data": world},
                  datapath=str(root), ckpt_name="mh", pretrained_weight=False,
                  training_plan=PLAN, compute_dtype="float32", loader_workers=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    roots = {}
    for world in (1, 2):
        roots[world] = tmp_path_factory.mktemp(f"world{world}")
        chip_smoke.write_synthetic_shards(roots[world] / "shards", 32, 64, COUNTS)
    train_by_plan(_cfg(roots[1], 1), device="cpu")
    writes = ddp_check.run_ranks(ddp_check.rank_plan, (_cfg(roots[2], 2), 2), 2, "cpu",
                                 workdir=tmp_path_factory.mktemp("ddp"))
    yield {world: Path(root) / "checkpts" / "mh" for world, root in roots.items()}, writes
    for root in roots.values():  # DepthNetBasic's checkpoints take ~1 GB a run
        shutil.rmtree(root)


def _history(path):
    with open(path / "history.csv") as f:
        return list(csv.DictReader(f))


def test_only_rank_zero_writes_and_a_rerun_skips_done_rows(runs):
    _, writes = runs
    first, rerun = writes[0][0], writes[0][1]
    # the snapshot once per run; "latest" per epoch (2), "ep02" at the
    # second row's end (the first saves none)
    assert first == {"snapshot_config": 1, "save": 3, "save_log": 2}, first
    assert rerun == {"snapshot_config": 1}, rerun
    assert writes[1] == [{}, {}]


def test_two_ranks_log_what_one_process_logs(runs):
    ckpts, _ = runs
    one, two = _history(ckpts[1]), _history(ckpts[2])
    assert [row["epoch"] for row in two] == ["0", "1"]
    assert list(two[0]) == list(one[0])
    for row_one, row_two in zip(one, two):
        for key, value in row_one.items():
            if key == "epoch":
                assert row_two[key] == value
            elif key.startswith(("train_loss", "val_loss")):
                # the same rows summed per rank, then over the ranks; a term
                # far below the loss (smoothness, ~1e-6) to 1e-6 of the loss
                total = float(row_one[key.split("_loss")[0] + "_loss"])
                np.testing.assert_allclose(float(row_two[key]), float(value), rtol=1e-5,
                                           atol=1e-6 * abs(total), err_msg=key)
            elif not key.endswith("sec_per_epoch") and value:
                # means of the ranks' means: test_torch_train_step.py's metric
                # tolerance
                np.testing.assert_allclose(float(row_two[key]), float(value), rtol=1e-4,
                                           atol=1e-5, err_msg=key)


def test_two_ranks_checkpoint_what_one_process_does(runs):
    ckpts, _ = runs
    names = sorted(p.name for p in ckpts[1].glob("*.pt"))
    assert names == sorted(p.name for p in ckpts[2].glob("*.pt"))
    assert {"depthnet_latest.pt", "posenet_ep02.pt", "trainstate_latest.pt"} <= set(names)
    for name in names:
        if not name.startswith(("depthnet", "posenet")):
            continue
        one = torch.load(ckpts[1] / name, map_location="cpu", weights_only=True)
        two = torch.load(ckpts[2] / name, map_location="cpu", weights_only=True)
        assert set(one) == set(two), name  # the single-process keys: no "module." prefix
        for key, value in one.items():
            diff = (two[key] - value).abs()
            # Adam moves every weight by at most lr a step, whatever a
            # noise-level gradient's sign; most weights agree to rounding
            assert float(diff.max()) <= LR_STEPS + 1e-6, (name, key)
            assert float(diff.median()) <= 1e-6, (name, key)
