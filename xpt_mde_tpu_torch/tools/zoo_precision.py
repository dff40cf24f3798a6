"""How far the model zoo's float32 gradients on one CUDA card sit from float64.

Usage, from the repository root on a machine with a CUDA card:

    python -m xpt_mde_tpu_torch.tools.zoo_precision [--backbones NAMES] [--size H W]

For each backbone of ``--backbones`` (comma-separated; by default the
seven beside EfficientNet): the depth net's backbone alone, seeded as
``ModelFactory(seed=0)`` seeds it, in train mode, on the target frames of
a seeded synthetic batch of 2 at ``--size`` (default 64x256) scaled to
[0, 255], the range the zoo's preprocessing is made for; the objective
sum_i mean(tap_i * r_i) with seeded normal r_i. Its float32 parameter
gradients (those above 1e-6 in float64) against the CPU's float64 ones:
the median and the worst relative distance, on the CPU and on the card
in four settings:

- ``card``: as the steps run (cuDNN's heuristics, TF32 off, the
  channels-last layout that the pipeline's NHWC frames give);
- ``card NCHW``: the input made contiguous, so the convolutions run NCHW;
- ``card cuDNN off``: torch's own CUDA convolutions;
- ``card TF32``: cuDNN with TF32 allowed, for scale.

One line per backbone; the first names the card and its power limit
(``nvidia-smi``). On a BatchNorm-free net (VGG16) the float32 backward
is well conditioned, so the distances are the convolutions' own.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys

import numpy as np
import torch

ZOO = ["ResNet50V2", "MobileNetV2", "VGG16", "DenseNet121", "Xception", "NASNetMobile",
       "NASNetLarge"]
KEYS = ["image", "intrinsic", "depth_gt", "pose_gt"]
GRAD_FLOOR = 1e-6
# (label, device, cuDNN enabled, TF32 allowed, contiguous input)
SETTINGS = [("cpu", "cpu", True, False, False), ("card", "cuda", True, False, False),
            ("card NCHW", "cuda", True, False, True),
            ("card cuDNN off", "cuda", False, False, False),
            ("card TF32", "cuda", True, True, False)]


def check_image(height: int, width: int) -> torch.Tensor:
    """The target frames [2, 3, H, W] of a seeded synthetic batch, in
    [0, 255], as the depth net hands them to its backbone (a permuted
    view of the NHWC frames)."""
    from xpt_mde_tpu_torch.data import SyntheticDataset

    batch = next(iter(SyntheticDataset(batch_size=2, height=height, width=width,
                                       num_batches=1, seed=30)))
    return ((torch.from_numpy(batch["image5d"]) + 1.0) * 127.5)[:, -1].permute(0, 3, 1, 2)


def seeded_backbone(name: str) -> torch.nn.Module:
    """The depth net's backbone ``name``, on the CPU, as
    ``ModelFactory(seed=0)`` seeds it beside PoseNetImproved."""
    from xpt_mde_tpu_torch.models import ModelFactory

    nets = {"depth": name, "camera": "PoseNetImproved"}
    return ModelFactory(KEYS, nets, stereo=False, device="cpu",
                        seed=0).get_model().depthnet.backbone


def backbone_run(backbone: torch.nn.Module, image: torch.Tensor, device, dtype,
                 contiguous: bool = False) -> tuple[list, dict, dict]:
    """A copy of ``backbone`` in ``dtype`` on ``device``, train mode, on
    ``image`` (made contiguous with ``contiguous``), forward and backward
    of the objective sum_i mean(tap_i * r_i) (r_i seeded normal): (the
    taps, the parameter gradients, the running statistics after the
    forward), float64 on the CPU."""
    net = copy.deepcopy(backbone).to(device, dtype).train()
    x = image.to(device, dtype)
    taps = net(x.contiguous() if contiguous else x)
    generator = torch.Generator().manual_seed(29)
    objective = sum((tap * torch.randn(tap.shape, generator=generator,
                                       dtype=torch.float64).to(device, dtype)).mean()
                    for tap in taps)
    objective.backward()
    return ([tap.detach().double().cpu() for tap in taps],
            {n: p.grad.detach().double().cpu() for n, p in net.named_parameters()},
            {k: v.detach().double().cpu() for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))})


def distances(grads: dict, ref: dict) -> tuple[float, float]:
    """(median, worst) relative distance ||g - r|| / ||r|| over the
    tensors of ``ref`` above GRAD_FLOOR."""
    errors = [float(torch.linalg.norm(grads[n] - r) / torch.linalg.norm(r))
              for n, r in ref.items() if float(torch.linalg.norm(r)) > GRAD_FLOOR]
    return float(np.median(errors)), max(errors)


def report(name: str, image: torch.Tensor, settings=SETTINGS) -> str:
    """One backbone's line: each setting's (median, worst) distance."""
    backbone = seeded_backbone(name)
    ref = backbone_run(backbone, image, "cpu", torch.float64)[1]
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.enabled, cudnn.allow_tf32, matmul.allow_tf32)
    parts = []
    try:
        for label, device, enabled, tf32, contiguous in settings:
            cudnn.enabled, cudnn.allow_tf32, matmul.allow_tf32 = enabled, tf32, tf32
            median, worst = distances(
                backbone_run(backbone, image, device, torch.float32, contiguous)[1], ref)
            parts.append(f"{label} {median:.3g} / {worst:.3g}")
    finally:
        cudnn.enabled, cudnn.allow_tf32, matmul.allow_tf32 = saved
    return f"{name}: float32 gradients from float64, median / worst: {'; '.join(parts)}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backbones", default=",".join(ZOO),
                        help="comma-separated backbone names")
    parser.add_argument("--size", type=int, nargs=2, default=(64, 256), metavar=("H", "W"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_precision: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{smi.stdout.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cuDNN {torch.backends.cudnn.version()}", flush=True)
    image = check_image(*args.size)
    for name in args.backbones.split(","):
        print(report(name, image), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
