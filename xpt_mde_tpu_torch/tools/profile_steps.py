"""Where the time of the predict, eval and train steps goes on one CUDA card.

Usage, from the repository root on a machine with a CUDA card:

    python -m xpt_mde_tpu_torch.tools.profile_steps [--steps NAMES] [--cudnn-benchmark]
                                                    [--dtype float32|bfloat16] [--out FILE]

``--steps`` is a comma-separated subset of ``predict,eval,train`` (the
rigid stage: EfficientNetB5 + PoseNetImproved with the loss of
``chip_smoke.py``; the train step with the default augmentation from a
seeded generator), ``flow-predict,flow-train`` (the flow stage: PWC-Net
alone, ``{"flowL2": 1.0, "flow_reg": 4e-7}``, ``regularize_net=
"flownet"``), ``joint-train`` (the joint stage: the three nets,
``{"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 20.0}``, the flownet frozen,
no augmentation), ``stereo-train`` (the rigid nets on stereo snippets
under the published "MS" recipe, ``STEREO_RECIPE``, with the default
augmentation) and ``stereo-joint-train`` (the three nets on stereo
snippets under ``LOSS_RIGID_COMB``, the flownet frozen, no
augmentation); all eight by default. Every step runs at batch 8,
128x512, seeded random weights, with Adam at 1e-4 and uint8-coded
batches for the train steps, in the compute dtype of ``--dtype``
(``float32``, the parity mode and the default here, or ``bfloat16``, the
default of ``Config``). For each step:

- times 5 steps on the host clock around ``torch.cuda.synchronize()``,
  without the profiler (wall ms/step);
- traces 5 more under ``torch.profiler`` and reports, per step, the
  device busy time (the union of the kernels' intervals), the number of
  kernels, the idle share ``1 - busy / wall`` against both walls, the 20
  operators and kernels by self device time, and the convolution kernels
  (cuDNN's, with its layout transforms, its FFT path's and the GEMMs) by
  device time, with the FFT path's share of the device time.

The first line of the output names the card and its power limit
(``nvidia-smi``) and whether cuDNN picks its convolution algorithms by
its heuristics (the port's default) or, with ``--cudnn-benchmark``, by
timing them at first use. ``--out`` also writes the report to a file.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time

import torch

RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
FLOW_RECIPE = {"flowL2": 1.0, "flow_reg": 4e-7}  # LOSS_FLOW without flowL2_R
JOINT_RECIPE = {"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 20.0}
# the published "MS" (mono + stereo) recipe of the JAX bench's stereo stage
STEREO_RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0,
                 "L1_R": 0.5, "SSIM_R": 0.5, "smoothe_R": 20.0,
                 "stereoL1": 0.5, "stereoSSIM": 0.5, "stereoPose": 1.0}
# the stereo snippets' keys, in the schema of the kitti_raw shards
STEREO_KEYS = ["image", "intrinsic", "depth_gt", "pose_gt", "image_R", "intrinsic_R",
               "stereo_T_LR"]
STEP_NAMES = ("predict", "eval", "train", "flow-predict", "flow-train", "joint-train",
              "stereo-train", "stereo-joint-train")
BATCH, HEIGHT, WIDTH = 8, 128, 512
STEPS = 5  # timed steps, and as many profiled
TOP = 20  # operators and kernels listed per step
TOP_CONV = 8  # convolution kernels listed per step
# kernel names of cuDNN's convolutions: its FFT path, implicit GEMMs and
# the Hopper/Ampere tensor-core kernels, and the weight/data gradients;
# cuDNN's batch-norm kernels (``bn_...``) are not convolutions
CONV_KERNEL = re.compile(r"fft|conv|cudnn|implicit|xmma|sm90_|sm80_|wgrad|dgrad|gemm",
                         re.IGNORECASE)
NOT_CONV_KERNEL = re.compile(r"\bbn_|::bn_|batch_?norm", re.IGNORECASE)
FFT_KERNEL = re.compile(r"fft", re.IGNORECASE)


def _device_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


def _wall_ms(step, batches) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        step(batches[i % len(batches)])
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / STEPS


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profile_step(label: str, step, batches) -> list[str]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for features in batches:  # warm-up: cuDNN autotuning, the kernels' build
        step(features)
    wall = _wall_ms(step, batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = _wall_ms(step, batches)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1000 / STEPS
    lines = [f"{label}: wall {wall:.3f} ms/step (no profiler), {wall_prof:.3f} ms/step "
             f"(profiled); device busy (union of kernel intervals) {busy:.3f} ms/step; "
             f"kernels/step {len(kernels) / STEPS:.0f}; idle share "
             f"{1 - busy / wall:.3f} (no profiler), {1 - busy / wall_prof:.3f} (profiled)"]
    averages = sorted(prof.key_averages(), key=lambda a: a.self_device_time_total,
                      reverse=True)
    for avg in averages[:TOP]:
        lines.append(f"  {avg.self_device_time_total / 1000 / STEPS:9.4f} ms/step "
                     f"{avg.count / STEPS:7.0f}/step  {avg.key[:110]}")
    lines += conv_kernel_lines(kernels, busy)
    return lines


def conv_kernel_lines(kernels, busy_ms: float) -> list[str]:
    """The convolution kernels by device time per step, and the FFT
    path's share of the device busy time. ``kernels``: profiler events
    with ``name`` and ``time_range`` (µs)."""
    totals: dict[str, list] = {}
    for event in kernels:
        if CONV_KERNEL.search(event.name) and not NOT_CONV_KERNEL.search(event.name):
            entry = totals.setdefault(event.name, [0.0, 0])
            entry[0] += event.time_range.end - event.time_range.start
            entry[1] += 1
    conv_ms = sum(t for t, _ in totals.values()) / 1000 / STEPS
    fft_ms = sum(t for name, (t, _) in totals.items() if FFT_KERNEL.search(name)) / 1000 / STEPS
    lines = [f"  convolution kernels {conv_ms:.3f} ms/step, of it FFT path {fft_ms:.3f} ms/step "
             f"({fft_ms / busy_ms if busy_ms else 0.0:.3f} of the device busy time); the top:"]
    for name, (total, count) in sorted(totals.items(), key=lambda kv: -kv[1][0])[:TOP_CONV]:
        lines.append(f"    {total / 1000 / STEPS:9.4f} ms/step {count / STEPS:7.0f}/step  "
                     f"{name[:110]}")
    return lines


def _build_steps(names, batches, dtype: str = "float32"):
    """{name: (label, step)} for the requested step names, the nets
    computing in ``dtype``."""
    from xpt_mde_tpu_torch.config import (AUGMENT_PROBS, FLOW_NET, JOINT_NET,
                                          LOSS_RIGID_COMB, RIGID_NET, SCALE_WEIGHT_T1)
    from xpt_mde_tpu_torch.losses import loss_factory
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.training import (augmentation_factory, make_eval_step,
                                            make_predict_step, make_train_step,
                                            optimizer_factory)

    keys = ["image", "intrinsic"]
    device = batches[0]["image5d"].device
    steps = {}
    if {"predict", "eval", "train"} & set(names):
        model = ModelFactory(keys, RIGID_NET, stereo=False, device=device, seed=0,
                             compute_dtype=dtype).get_model()
        total_loss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                  batch_size=BATCH)
        label = f"{RIGID_NET['depth']} + {RIGID_NET['camera']}"
        steps["predict"] = (label, make_predict_step(model))
        steps["eval"] = (label, make_eval_step(model, total_loss))
        train_step = make_train_step(model, total_loss,
                                     optimizer_factory("adam_constant", 1e-4, model),
                                     augmenter=augmentation_factory(AUGMENT_PROBS))
        generator = torch.Generator().manual_seed(0)
        steps["train"] = (label, lambda features: train_step(features, generator))
    if {"flow-predict", "flow-train"} & set(names):
        model = ModelFactory(keys, FLOW_NET, stereo=False, device=device, seed=0,
                             compute_dtype=dtype).get_model()
        flow_loss = loss_factory(keys, FLOW_RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                 batch_size=BATCH)
        steps["flow-predict"] = ("PWCNet", make_predict_step(model))
        steps["flow-train"] = ("PWCNet", make_train_step(
            model, flow_loss, optimizer_factory("adam_constant", 1e-4, model),
            regularize_net="flownet"))
    if "joint-train" in names:
        model = ModelFactory(keys, JOINT_NET, stereo=False, device=device, seed=0,
                             compute_dtype=dtype).get_model()
        joint_loss = loss_factory(keys, JOINT_RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                  batch_size=BATCH)
        steps["joint-train"] = ("B5 + PoseNetImproved + PWCNet, flownet frozen", make_train_step(
            model, joint_loss,
            optimizer_factory("adam_constant", 1e-4, model, frozen_nets=["flownet"]),
            frozen_nets=["flownet"]))
    if "stereo-train" in names:
        model = ModelFactory(STEREO_KEYS, RIGID_NET, device=device, seed=0,
                             compute_dtype=dtype).get_model()
        stereo_loss = loss_factory(STEREO_KEYS, STEREO_RECIPE, SCALE_WEIGHT_T1,
                                   batch_size=BATCH)
        stereo_train = make_train_step(model, stereo_loss,
                                       optimizer_factory("adam_constant", 1e-4, model),
                                       augmenter=augmentation_factory(AUGMENT_PROBS))
        stereo_generator = torch.Generator().manual_seed(0)
        steps["stereo-train"] = (f"{RIGID_NET['depth']} + {RIGID_NET['camera']}, MS recipe",
                                 lambda features: stereo_train(features, stereo_generator))
    if "stereo-joint-train" in names:
        model = ModelFactory(STEREO_KEYS, JOINT_NET, device=device, seed=0,
                             compute_dtype=dtype).get_model()
        comb_loss = loss_factory(STEREO_KEYS, LOSS_RIGID_COMB, SCALE_WEIGHT_T1,
                                 batch_size=BATCH)
        steps["stereo-joint-train"] = (
            "B5 + PoseNetImproved + PWCNet, LOSS_RIGID_COMB, flownet frozen", make_train_step(
                model, comb_loss,
                optimizer_factory("adam_constant", 1e-4, model, frozen_nets=["flownet"]),
                frozen_nets=["flownet"]))
    return {name: steps[name] for name in names}


def uint8_coded(batch: dict) -> dict:
    """The batch's snippets as the shard loaders ship them, uint8."""
    return {k: torch.round((v + 1.0) * 127.5).to(torch.uint8) if k.startswith("image5d")
            else v for k, v in batch.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", default=",".join(STEP_NAMES),
                        help=f"comma-separated subset of {','.join(STEP_NAMES)}")
    parser.add_argument("--cudnn-benchmark", action="store_true",
                        help="let cuDNN time its convolution algorithms at first use")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                        help="the nets' compute dtype (Config.compute_dtype)")
    parser.add_argument("--out", default=None, help="also write the report here")
    args = parser.parse_args(argv)
    names = [n for n in args.steps.split(",") if n]
    unknown = sorted(set(names) - set(STEP_NAMES))
    if unknown:
        parser.error(f"unknown steps {unknown}; choose from {','.join(STEP_NAMES)}")
    if not torch.cuda.is_available():
        print("profile_steps: no CUDA device", file=sys.stderr)
        return 1

    from xpt_mde_tpu_torch.data import SyntheticDataset

    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    device = torch.device("cuda", 0)
    stereo = any(name.startswith("stereo") for name in names)
    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                               num_batches=3, stereo=stereo, seed=0)
    stereo_batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                      for b in dataset]
    mono_keys = ("image5d", "intrinsic", "depth_gt", "pose_gt")
    batches = [{k: b[k] for k in mono_keys} for b in stereo_batches]
    report = [f"{_device_line()}; batch {BATCH}, {HEIGHT}x{WIDTH}, compute {args.dtype} "
              f"(TF32 off), "
              f"{STEPS} steps, cuDNN algorithms by "
              f"{'timing (benchmark)' if args.cudnn_benchmark else 'heuristics'}"]
    for name, (label, step) in _build_steps(names, batches, args.dtype).items():
        step_batches = stereo_batches if name.startswith("stereo") else batches
        if name.endswith("train"):
            step_batches = [uint8_coded(b) for b in step_batches]
        report += profile_step(f"{name} ({label})", step, step_batches)
    text = "\n".join(report)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
