"""The port's measuring tools, as far as they run without a card."""

import pytest
import torch

from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
from xpt_mde_tpu_torch.ops.kernels import correlation as kcorr
from xpt_mde_tpu_torch.tools import corr_sweep, corr_variants, profile_steps


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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


def test_profile_steps_builds_the_joint_step_with_the_flownet_frozen():
    (label, step), = profile_steps._build_steps(["joint-train"],
                                                [{"image5d": torch.zeros(1)}]).values()
    assert "flownet frozen" in label and callable(step)


def test_corr_sweep_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert corr_sweep.main([]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
def test_corr_sweep_variants_hold_each_plan(level):
    """At every PWC level the K2 and K4 variants include the kernel's own
    plan, and every variant fits 227 KB and 256 threads."""
    md, stride = level_displacement(level)
    shape = (32, ENCODER_CHANNELS[level - 1], 128 >> level, 512 >> level)
    for variants, plan, keys in (
            (list(corr_sweep.k2_variants(*shape[1:], md, stride)),
             kcorr.fwd_plan(*shape, md, stride), kcorr.FWD_LAUNCH_KEYS),
            (list(corr_sweep.k4_variants(*shape, md, stride)),
             kcorr.bwd_plan(*shape, md, stride), kcorr.BWD_LAUNCH_KEYS)):
        assert any(all(v[k] == plan[k] for k in keys) for v in variants)
        assert all(v["smem_bytes"] <= kcorr.SMEM_LIMIT for v in variants)
        assert all(v["threads"] <= kcorr.MAX_THREADS for v in variants)


@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
def test_corr_sweep_k3_bf16_variants_hold_its_plan(level):
    """At every PWC level the K3-bf16 variants include its own plan and
    every count of rows a stage, and every variant fits 227 KB and 8 warps
    and holds the layout the C entry recomputes."""
    md, stride = level_displacement(level)
    shape = (32, ENCODER_CHANNELS[level - 1], 128 >> level, 512 >> level)
    n = kcorr.num_displacements(md, stride)
    variants = list(corr_sweep.k3_bf16_variants(*shape[1:], md, stride))
    plan = kcorr.bwd_cl_plan_bf16(*shape, md, stride)
    assert any(all(v[k] == plan[k] for k in kcorr.BWD_BF16_LAUNCH_KEYS) for v in variants)
    most = min(kcorr.rows_max(n, stride, shape[2]), kcorr.BF16_ROWS_PER_STAGE)
    assert {v["rows_per_stage"] for v in variants} == set(range(1, most + 1))
    for v in variants:
        assert v["threads"] <= 32 * kcorr.BF16_MAX_WARPS
        assert v["smem_bytes"] == kcorr.bwd_cl_bf16_layout(
            stride, n, v["tile_x"], v["chan_blocks"], v["rows_per_stage"], shape[2])["total"]
        assert v["smem_bytes"] <= kcorr.SMEM_LIMIT


@pytest.mark.parametrize("name", sorted(corr_variants.VARIANTS))
def test_corr_variants_edits_apply_to_the_source(name):
    """Each variant's edits find their text exactly once in the kernels'
    source and change it (all but the source as built)."""
    text = corr_variants.variant_source(name)
    assert (text == corr_variants.SOURCE.read_text()) == (name == "as built")


def test_profile_steps_builds_the_stereo_steps(monkeypatch):
    """The stereo steps: the rigid nets under the MS recipe and the three
    nets under LOSS_RIGID_COMB, on stereo models over the kitti_raw keys
    (built here at EfficientNetB0, which the CPU builds in a few seconds)."""
    from xpt_mde_tpu_torch import config

    monkeypatch.setattr(config, "RIGID_NET", {"depth": "EfficientNetB0",
                                              "camera": "PoseNetImproved"})
    monkeypatch.setattr(config, "JOINT_NET", dict(config.RIGID_NET, flow="PWCNet"))
    steps = profile_steps._build_steps(["stereo-train", "stereo-joint-train"],
                                       [{"image5d": torch.zeros(1)}])
    assert list(steps) == ["stereo-train", "stereo-joint-train"]
    assert "MS recipe" in steps["stereo-train"][0]
    assert "flownet frozen" in steps["stereo-joint-train"][0]
    assert all(callable(step) for _, step in steps.values())
    assert set(profile_steps.STEREO_RECIPE) == {
        "L1", "SSIM", "smoothe", "L1_R", "SSIM_R", "smoothe_R", "stereoL1", "stereoSSIM",
        "stereoPose"}
    coded = profile_steps.uint8_coded({"image5d_R": torch.ones(1, 2), "intrinsic": torch.ones(1)})
    assert coded["image5d_R"].dtype == torch.uint8 and coded["intrinsic"].dtype == torch.float32


def test_profile_steps_builds_bf16_steps():
    """``--dtype bfloat16`` builds the nets in the compute dtype of
    ``Config()``'s default, with float32 parameters."""
    steps = profile_steps._build_steps(["flow-predict"], [{"image5d": torch.zeros(1)}],
                                       "bfloat16")
    model = steps["flow-predict"][1].__closure__[0].cell_contents
    convs = [m for m in model.modules() if hasattr(m, "compute_dtype")]
    assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_conv_kernel_lines_sum_the_convolutions_and_the_fft_share():
    class Event:
        def __init__(self, name, start, end):
            self.name = name
            self.time_range = type("R", (), {"start": start, "end": end})()

    steps = profile_steps.STEPS
    # per step: one FFT kernel of 1 ms, two GEMM convolutions of 3 and 1 ms
    kernels = [Event("elementwise_kernel", 0, 9000 * steps),
               Event("void cudnn::bn_fw_inf_1C11_kernel_NHWC<float>", 0, 500 * steps)]
    for _ in range(steps):
        kernels += [Event("void fft2d_r2c_32x32<float>", 0, 1000),
                    Event("sm90_xmma_fprop_implicit_gemm_bf16", 0, 3000),
                    Event("sm90_xmma_fprop_implicit_gemm_bf16", 0, 1000)]
    lines = profile_steps.conv_kernel_lines(kernels, busy_ms=10.0)
    assert lines[0].startswith("  convolution kernels 5.000 ms/step, of it FFT path "
                               "1.000 ms/step (0.100 of the device busy time)")
    assert "4.0000 ms/step       2/step  sm90_xmma" in lines[1] and "fft2d" in lines[2]
    assert len(lines) == 3
