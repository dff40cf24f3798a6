"""The port's GT-bearing synthetic worlds (``xpt_mde_tpu_torch.data.synthetic``)
against the JAX package's, and the port's twins of
``tests/test_synthetic_worlds.py``.

Every world knob of ``SyntheticDataset`` and ``PlanarSceneDataset`` must
give the JAX package's batches bit for bit (they are numpy copies). The
twins pin the worlds' geometry through the port's own view synthesis
(``ops/synthesize.py``, the plain warp on the CPU, in full float32) with
the JAX tests' thresholds: the moving band breaks rigid consistency and
only there, an accelerating band has no consistent depth, the combined
loss removes the moving-object trap, the planar world closes under yaw,
and ``mini_plan.band_abs_rel`` attributes a biased band to the band.
"""

import numpy as np
import pytest
import torch

from xpt_mde_tpu.data import PlanarSceneDataset as JPlanarSceneDataset
from xpt_mde_tpu.data import SyntheticDataset as JSyntheticDataset
from xpt_mde_tpu_torch.data import PlanarSceneDataset, SyntheticDataset
from xpt_mde_tpu_torch.losses.total import (CombinedLossMultiScale, PhotometricLossMultiScale,
                                            TotalLoss)
from xpt_mde_tpu_torch.ops.synthesize import synthesize_multi_scale
from xpt_mde_tpu_torch.training.mini_plan import band_abs_rel
from xpt_mde_tpu_torch.utils import se3
from xpt_mde_tpu_torch.utils.precision import full_f32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    with full_f32():
        yield


def _assert_same_batches(ours, ref):
    assert len(ours) == len(ref) and ours.config_keys() == ref.config_keys()
    for got, want in zip(ours, ref, strict=True):
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("options", [
    # the mini plan's worlds: its train split and its held-out set
    dict(varying_depth=True, vary_motion=True, batch_size=3, num_batches=2),
    dict(varying_depth=True, vary_motion=True, seed=99, height=64, width=128,
         num_batches=1),
    # the moving band, at constant velocity and accelerating (protocol v6)
    dict(moving_object=True, varying_depth=True, seed=3, num_batches=1),
    dict(moving_object=True, varying_depth=True, object_accel=0.4, seed=7, num_batches=1),
    dict(moving_object=True, object_vel_ratio=0.3, object_depth_m=4.0, depth_m=12.0,
         step_m=0.7, num_batches=1),
    # the knobs of the scene and the snippet
    dict(depth_m=6.0, step_m=0.3, snippet_len=3, seed=2, num_batches=2),
    dict(stereo=True, varying_depth=True, vary_motion=True, baseline_m=0.54, num_batches=1),
])
def test_synthetic_worlds_match_jax(options):
    ours, ref = SyntheticDataset(**options), JSyntheticDataset(**options)
    if options.get("moving_object"):
        assert ours.object_rows() == ref.object_rows()
        assert ours.object_depth_m == ref.object_depth_m
    _assert_same_batches(ours, ref)


@pytest.mark.parametrize("options", [
    dict(num_batches=2),
    dict(yaw_deg=1.5, vary_motion=True, step_m=0.4, seed=2, num_batches=1),
    dict(depth_min=2.0, depth_max=30.0, height=16, width=40, snippet_len=3, seed=5,
         num_batches=2),
])
def test_planar_world_matches_jax(options):
    _assert_same_batches(PlanarSceneDataset(**options), JPlanarSceneDataset(**options))


def test_moving_object_refuses_stereo():
    with pytest.raises(ValueError, match="monocular"):
        SyntheticDataset(moving_object=True, stereo=True)


def _gt_synth_err(feats, depth=None):
    """Per-pixel photometric error of GT-driven rigid synthesis, averaged
    over the sources and channels where the synthesis is valid: [H, W] of
    batch item 0."""
    image5d = torch.from_numpy(feats["image5d"])
    sources, target = image5d[:, :-1], image5d[:, -1]
    depth = torch.from_numpy(np.asarray(feats["depth_gt"] if depth is None else depth))
    synth = synthesize_multi_scale(sources, torch.from_numpy(feats["intrinsic"]), [depth],
                                   torch.from_numpy(feats["pose_gt"]))[0]
    valid = (synth.abs().sum(-1, keepdim=True) > 1e-6).to(synth.dtype)
    err = (synth - target[:, None]).abs() * valid
    per_pix = err.sum(dim=(1, 4)) / torch.clamp(valid.sum(dim=(1, 4)), min=1)
    return per_pix[0].numpy()


MARGIN = 8  # columns that flow out of view at the largest shift


def _band_and_rest(err, r0, r1):
    rest = np.concatenate([err[: r0 - 1, MARGIN:-MARGIN], err[r1 + 1:, MARGIN:-MARGIN]])
    return err[r0:r1, MARGIN:-MARGIN].mean(), rest.mean()


def test_moving_object_breaks_rigid_consistency_only_in_band():
    data = SyntheticDataset(batch_size=1, num_batches=1, varying_depth=True,
                            moving_object=True, seed=3)
    feats = next(iter(data))
    r0, r1 = data.object_rows()
    band, rest = _band_and_rest(_gt_synth_err(feats), r0, r1)
    assert rest < 0.02, rest  # the static rows: GT closes the warp
    assert band > 5 * rest, (band, rest)  # the moving band: it cannot
    assert np.all(feats["depth_gt"][0, r0:r1, 0, 0] == data.object_depth_m)
    # the wrong but consistent depth d_obj / (1 - r) closes the band again
    biased = np.array(feats["depth_gt"])
    biased[0, r0:r1] = data.object_depth_m / (1 - data.object_vel_ratio)
    band_biased, _ = _band_and_rest(_gt_synth_err(feats, biased), r0, r1)
    assert band_biased < 0.3 * band, (band_biased, band)


def test_accelerating_band_has_no_consistent_depth():
    data = SyntheticDataset(batch_size=1, num_batches=1, varying_depth=True,
                            moving_object=True, object_accel=0.4, seed=3)
    feats = next(iter(data))
    r0, r1 = data.object_rows()

    def band_err(scale):
        depth = np.array(feats["depth_gt"])
        depth[0, r0:r1] = data.object_depth_m * scale
        return _band_and_rest(_gt_synth_err(feats, depth), r0, r1)[0]

    gt_band = band_err(1.0)
    best = min(band_err(s) for s in [0.5, 0.8, 1.0, 1.25, 1.67, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0])
    assert best > 0.55 * gt_band, (best, gt_band)
    _, rest = _band_and_rest(_gt_synth_err(feats), r0, r1)
    assert rest < 0.02, rest


def test_cmb_objective_neutralizes_moving_object_trap():
    """The rigid photometric loss prefers the biased band depth d_obj/(1-r)
    over GT; the combined loss, given the band's true flow, masks the band
    and the preference gap collapses."""
    data = SyntheticDataset(batch_size=2, num_batches=1, varying_depth=True,
                            moving_object=True, seed=7)
    batch = next(iter(data))
    feats = {k: torch.from_numpy(v) for k, v in batch.items()}
    r0, r1 = data.object_rows()
    r = data.object_vel_ratio
    fx = float(data.intrinsic[0, 0])
    # analytic flow (sampling at grid - flow): static rows fx o_i / d(v),
    # the band (moving with the camera at ratio r) fx o_i (1 - r) / d_obj
    offsets = -batch["pose_gt"][:, :, 0, 3]
    d_rows = batch["depth_gt"][:, :, 0, 0]
    flow_u = fx * offsets[:, :, None] / d_rows[:, None, :]
    flow_u[:, :, r0:r1] *= (1.0 - r)
    flow = np.zeros((2, 4, data.height, data.width, 2), np.float32)
    flow[..., 0] = flow_u[..., None]

    def losses(depth):
        preds = {"depth_ms": [torch.from_numpy(depth)], "pose": feats["pose_gt"],
                 "flow_ms": [torch.from_numpy(flow)]}
        augm = TotalLoss({}, {}).append_data(feats, preds)
        rigid = PhotometricLossMultiScale("L1", [1.0])(feats, preds, augm)
        cmb = CombinedLossMultiScale("L1", [1.0])(feats, preds, augm)
        return float(torch.mean(rigid)), float(torch.mean(cmb))

    gt_depth = batch["depth_gt"]
    biased = gt_depth.copy()
    biased[:, r0:r1] = data.object_depth_m / (1.0 - r)
    rigid_gt, cmb_gt = losses(gt_depth)
    rigid_biased, cmb_biased = losses(biased)
    assert rigid_biased < 0.8 * rigid_gt, (rigid_biased, rigid_gt)
    assert cmb_gt <= cmb_biased * 1.05, (cmb_gt, cmb_biased)
    assert abs(cmb_gt - cmb_biased) < 0.1 * (rigid_gt - rigid_biased)


def test_band_abs_rel_attribution_is_scale_anchored():
    rng = np.random.RandomState(0)
    height, width, r0, r1 = 64, 128, 24, 40
    gt = 5.0 + 15.0 * rng.rand(2, height, width)
    for global_scale in (1.0, 3.7):  # monocular depth is scale-free
        pred = gt * global_scale
        pred[:, r0:r1] *= 2.5  # the trap's analytic band bias
        out = band_abs_rel({"depth": pred[..., None], "depth_gt": gt[..., None]}, r0, r1)
        assert abs(out["ratio"] - 2.5) < 1e-6, out
        assert out["rest"] < 1e-6, out
        assert abs(out["band"] - 1.5) < 1e-6, out
    out = band_abs_rel({"depth": (gt * 2.0)[..., None], "depth_gt": gt[..., None]}, r0, r1)
    assert abs(out["ratio"] - 1.0) < 1e-6, out
    assert out["band"] < 1e-6 and out["rest"] < 1e-6, out


def test_planar_world_depth_profile_and_pose():
    data = PlanarSceneDataset(batch_size=1, num_batches=1, depth_min=5.0, depth_max=20.0,
                              step_m=0.4, yaw_deg=1.0, seed=1)
    feats = next(iter(data))
    depth = feats["depth_gt"][0, :, :, 0]
    assert np.allclose(depth, depth[:, :1], atol=1e-4)  # row-constant
    assert np.isclose(depth[0, 0], 20.0, rtol=1e-4)
    assert np.isclose(depth[-1, 0], 5.0, rtol=1e-4)
    assert np.all(np.diff(depth[:, 0]) < 0)
    twists = se3.matrix_to_twist(torch.from_numpy(feats["pose_gt"])).numpy()[0]
    for twist, t in zip(twists, [-2, -1, 1, 2]):  # relative yaw of 1 and 2 degrees
        angle = np.rad2deg(np.linalg.norm(twist[3:]))
        assert np.isclose(angle, abs(t) * 1.0, atol=0.02), (t, angle)


def test_planar_world_gt_closes_synthesis_under_yaw():
    data = PlanarSceneDataset(batch_size=1, num_batches=1, depth_min=5.0, depth_max=20.0,
                              step_m=0.4, yaw_deg=1.5, seed=2)
    feats = next(iter(data))
    interior = _gt_synth_err(feats)[2:-2, 10:-10]
    assert interior.mean() < 0.03, interior.mean()
    wrong = np.array(feats["pose_gt"])
    wrong[:, :, 0, 3] *= 0.5  # a wrong pose does not close it
    err_wrong = _gt_synth_err(dict(feats, pose_gt=wrong))
    assert err_wrong[2:-2, 10:-10].mean() > 3 * interior.mean()


def test_planar_world_appearance_cue_tracks_depth():
    data = PlanarSceneDataset(batch_size=1, num_batches=1, depth_min=5.0, depth_max=20.0,
                              seed=4)
    feats = next(iter(data))
    row_cue = feats["image5d"][0, -1, ..., 0].mean(axis=1)
    row_inv = (1.0 / feats["depth_gt"][0, :, :, 0]).mean(axis=1)
    assert np.corrcoef(row_cue, row_inv)[0, 1] > 0.9
