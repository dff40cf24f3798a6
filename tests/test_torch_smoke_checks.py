"""The CPU side of ``chip_smoke.py``'s cross-checks: the checked steps'
float64 CPU runs go to spawned worker processes (``_CpuRuns``), which
must give what the same runs give in the calling process, from the same
seeded weights; the float32 ones run here; and the checks run through
with the CPU standing in for the card, on small nets (DepthNetBasic + PoseNetBasic at 32x64; MobileNetV2's
backbone at the zoo's check size). A worker and this process may round a
sum differently (their buffers' alignment differs), so the runs are held
to rounding: the weights' digest exactly, the losses within RTOL of the
dtype, the gradients' median relative difference within RTOL too. The
bfloat16 runs are left out: on the CPU their backward now and then gives
NaN gradients (about one step in twenty at this size), so no two of them
need agree.
"""

import pytest
import torch

import chip_smoke as cs

KEYS = ["image", "intrinsic", "depth_gt", "pose_gt"]
RTOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def pool(monkeypatch):
    """``chip_smoke._CPU_RUNS`` with one worker of this process's threads."""
    runs = cs._CpuRuns()
    runs.start(workers=1, threads=torch.get_num_threads())
    monkeypatch.setattr(cs, "_CPU_RUNS", runs)
    yield runs
    runs.stop()


def _small_check():
    from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.losses import loss_factory

    batch = next(iter(SyntheticDataset(batch_size=2, height=32, width=64, num_batches=1,
                                       seed=0)))
    return cs._Check("small rigid", {"depth": "DepthNetBasic", "camera": "PoseNetBasic"},
                     KEYS, {k: batch[k] for k in ("image5d", "intrinsic", "depth_gt", "pose_gt")},
                     loss_factory(KEYS, cs.RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=2),
                     cs._set_pose_twist)


@pytest.mark.parametrize("run", ["float32", "float64"])
def test_a_worker_gives_the_run_of_this_process(pool, run):
    check = _small_check()
    pool.submit([((check.label, run), cs._cpu_step, (check, run))])
    pooled = pool.result((check.label, run), cs._cpu_step, check, run)
    here = cs._to_torch(cs._to_numpy(cs._cpu_step(check, run)))
    assert set(pooled) == set(here) == ({"metrics", "grads", "stats", "float32_params",
                                         "digest"} | ({"preds"} if run == "float32" else set()))
    assert pooled["digest"] == here["digest"] == cs._digest(
        cs._prepared_state(check, cs.CPU_STEP_RUNS[run][0]))
    assert pooled["metrics"].keys() == here["metrics"].keys()
    for key, value in here["metrics"].items():
        torch.testing.assert_close(pooled["metrics"][key], value, rtol=RTOL[run], atol=0.0)
    assert pooled["grads"].keys() == here["grads"].keys()
    diffs = [float(torch.linalg.norm(pooled["grads"][n] - g) / torch.linalg.norm(g))
             for n, g in here["grads"].items() if float(torch.linalg.norm(g)) > 0.0]
    assert sorted(diffs)[len(diffs) // 2] <= RTOL[run]
    assert all(g.dtype == getattr(torch, run) for g in pooled["grads"].values())


def test_other_weights_are_refused():
    state = {"w": torch.zeros(3)}
    cs._check_digest("same", cs._digest(state), {"w": torch.zeros(3)})
    with pytest.raises(AssertionError, match="other weights"):
        cs._check_digest("moved", cs._digest(state), {"w": torch.tensor([0.0, 0.0, 1e-30])})


def test_step_check_runs_through_the_workers(pool, capsys):
    check = _small_check()
    cpu = torch.device("cpu")
    pool.submit([((check.label, "float64"), cs._cpu_step, (check, "float64"))])
    f32_runs = cs._train_cross_check(7, check, cpu, ("depth_ms", "pose"), cs.LOSS_TOL)
    assert set(f32_runs) == {("card", "float32"), ("cpu", "float32")}
    assert not pool.pending and not pool.done  # the worker's run was taken
    out = capsys.readouterr().out
    assert "phase 7 small rigid cross-check" in out and "median relative error" in out


def test_backbone_check_runs_through_the_workers(pool):
    check = cs._zoo_checks()["MobileNetV2"]
    pool.submit([((check.label, "backbone torch.float64"), cs._cpu_backbone,
                  (check, "float64"))])
    summary = cs._backbone_cross_check(check, torch.device("cpu"))
    assert summary.startswith("MobileNetV2 backbone alone at (2, 3, 64, 256)")
    _, _, f32_runs = cs._step_cross_check(29, check, torch.device("cpu"), ("depth_ms", "pose"),
                                          cs.LOSS_TOL, float64=False)
    assert not pool.pending and not pool.done
    assert ("cpu", "float32") in f32_runs
