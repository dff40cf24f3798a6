#!/usr/bin/env python3
"""Drive the PyTorch port's rigid predict + eval path once on one NVIDIA GPU.

Usage, from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds kernel K1 (``xpt_mde_tpu_torch/csrc/warp.cu``) with ``nvcc`` and
prints one line per phase:

1. the device (name, count, power limit) and K1's register/spill report;
2. K1 against its plain PyTorch version at the four headline scales
   (8 x 4 sources x {128x512, 64x256, 32x128, 16x64} x 3), on coordinates
   reprojected from synthetic depth and pose plus a band of out-of-frame
   and border-exact ones, with a depth mask;
3. predict: EfficientNetB5 + PoseNetImproved, seeded random weights,
   batch 8, 128x512, on 3 synthetic batches: shapes and finiteness;
4. eval: the same batches through the eval step (L1 + SSIM + smoothness
   at the T1 scale weights): finite losses and 4 K1 launches per step;
5. the eval step again on the CPU with the same weights on one batch: the
   GPU and CPU losses must agree within LOSS_TOL;
6. timings, each tagged with the card's name and power limit.

Then a JSON line with the kernels' launches, errors and times, the
``nvidia-smi`` name/power line, and last the result line
``{"ok": true, "device": {...}}``. It exits non-zero and prints no result
line when there is no CUDA card, when the repository's packages cannot be
imported, or when any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
import traceback

BATCH, HEIGHT, WIDTH, NUM_BATCHES = 8, 128, 512, 3
SCALES = (1, 2, 4, 8)
RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
# K1 and its plain version compute the same float32 products; they may
# differ only by FMA contraction, a few ulp of values in [-1, 1]
K1_ATOL = 1e-5
# GPU vs CPU eval losses, (rtol, atol) per term. cuDNN on the card and
# the CPU's convolutions sum in different orders through ~130 layers; the
# losses are means of millions of terms, so rtol 1e-3
LOSS_TOL = {"loss": (1e-3, 0.0), "loss/L1": (1e-3, 0.0), "loss/SSIM": (1e-3, 0.0),
            # at random init the disparity is nearly flat, so the smoothness
            # term (~5e-7) is a mean of differences of nearly equal
            # disparities: float32 rounding of the convs moves it by a few
            # tenths of a percent of itself
            "loss/smoothe": (1e-2, 1e-9)}


def _nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` as the host issues it: CUDA events around
    ``iters`` back-to-back eager calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so host issue time does not count."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, iters=5, warmup=1) / iters


def _warp_case(batch, scale, device, rng):
    """Sources, coords and mask of one headline scale: coords reprojected
    from the batch's depth and pose, with rows 0..h/8 replaced by
    out-of-frame and border-exact (u, v) values; 10% of the mask zeroed."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.ops.camera import reproject_pixel_coords, scale_intrinsics
    from xpt_mde_tpu_torch.utils.image import resize_image

    b, s = BATCH, batch["image5d"].shape[1]
    h, w = HEIGHT // scale, WIDTH // scale
    image5d = torch.from_numpy(batch["image5d"]).to(device)
    depth = resize_image(torch.from_numpy(batch["depth_gt"]).to(device), h, w, "nearest")
    intrinsic = scale_intrinsics(torch.from_numpy(batch["intrinsic"]).to(device), float(scale))
    pose = torch.from_numpy(batch["pose_gt"]).to(device)
    src = resize_image(image5d[:, :-1].reshape(b * (s - 1), HEIGHT, WIDTH, 3), h, w)
    src = src.reshape(b, s - 1, h, w, 3).contiguous()
    coords = reproject_pixel_coords(depth, pose, intrinsic).contiguous()
    rows = max(1, h // 8)
    u_vals = np.array([-3.2, -1.0, -0.5, 0.0, 0.5, w - 1.5, w - 1.0, w - 0.25, w + 2.0])
    v_vals = np.array([-2.0, -0.5, 0.0, 1.25, h - 1.5, h - 1.0, h - 0.5, h + 3.0])
    band = (b, s - 1, rows * w)
    coords[:, :, 0, :rows * w] = torch.from_numpy(
        rng.choice(u_vals, band).astype(np.float32)).to(device)
    coords[:, :, 1, :rows * w] = torch.from_numpy(
        rng.choice(v_vals, band).astype(np.float32)).to(device)
    keep = torch.from_numpy((rng.rand(b, h, w, 1) > 0.1).astype(np.float32)).to(device)
    mask = (depth * keep).contiguous()
    return src, coords, mask


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 1
    try:
        from xpt_mde_tpu_torch.config import RIGID_NET, SCALE_WEIGHT_T1
        from xpt_mde_tpu_torch.data import SyntheticDataset
        from xpt_mde_tpu_torch.losses import loss_factory
        from xpt_mde_tpu_torch.models import ModelFactory
        from xpt_mde_tpu_torch.ops.kernels import warp as k1_module
        from xpt_mde_tpu_torch.ops.warp import bilinear_sample_plain
        from xpt_mde_tpu_torch.training import make_eval_step, make_predict_step
        from xpt_mde_tpu_torch.utils.precision import full_f32
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1

    K1 = k1_module.K1
    device = torch.device("cuda", 0)
    phase = "device"
    # full float32 (TF32 off for cuBLAS and cuDNN) in every phase, so the
    # kernel check and the GPU/CPU loss comparison test float32 numerics
    try:
        with full_f32():
            # 1. device and build
            smi = _nvidia_smi_line()
            tag = f"[{smi}]"
            name = torch.cuda.get_device_name(0)
            count = torch.cuda.device_count()
            print(f"phase 1 device: {name}, count {count}, nvidia-smi name/power.limit: {smi}",
                  flush=True)
            phase = "build"
            t0 = time.perf_counter()
            K1.build()
            ptxas = [ln.strip() for ln in K1.build_log.splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"phase 1 build: K1 built in {time.perf_counter() - t0:.1f} s; "
                  f"ptxas: {' | '.join(ptxas)}", flush=True)

            keys = ["image", "intrinsic", "depth_gt", "pose_gt"]
            dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                                       num_batches=NUM_BATCHES, seed=0)
            batches = list(dataset)

            # 2. K1 against its plain version at the headline scales
            phase = "K1 vs plain"
            rng = np.random.RandomState(0)
            k1_err, k1_ms, plain_ms, per_scale = 0.0, 0.0, 0.0, []
            for scale in SCALES:
                src, coords, mask = _warp_case(batches[0], scale, device, rng)
                cases = [(mask, "mask")] + ([(None, "no mask")] if scale == 1 else [])
                for m, label in cases:
                    got = K1(src, coords, m)
                    ref = bilinear_sample_plain(src, coords, m)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    invalid = float((ref == 0).all(dim=-1).float().mean())
                    if not err <= K1_ATOL:
                        raise AssertionError(f"K1 differs from plain by {err} at 1/{scale} ({label})")
                    k1_err = max(k1_err, err)
                    per_scale.append(f"1/{scale} {label} err {err:.3g} invalid {invalid:.3f}")
                t_k = _graph_ms(lambda: K1(src, coords, mask))
                t_p = _graph_ms(lambda: bilinear_sample_plain(src, coords, mask))
                e_k = _event_ms(lambda: K1(src, coords, mask))
                e_p = _event_ms(lambda: bilinear_sample_plain(src, coords, mask))
                k1_ms += t_k
                plain_ms += t_p
                print(f"timing K1 1/{scale} {tuple(src.shape)}: device (graph replay) "
                      f"K1 {t_k:.4f} ms, plain {t_p:.4f} ms; eager per call K1 "
                      f"{e_k:.4f} ms, plain {e_p:.4f} ms {tag}", flush=True)
            print(f"phase 2 K1 vs plain: max abs err {k1_err:.3g} <= {K1_ATOL} "
                  f"({'; '.join(per_scale)})", flush=True)

            # 3. predict, 4. eval: the main path, counted from zero
            phase = "predict"
            model = ModelFactory(keys, RIGID_NET, stereo=False, device=device, seed=0).get_model()
            total_loss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                      batch_size=BATCH)
            predict_step = make_predict_step(model)
            eval_step = make_eval_step(model, total_loss)
            gpu_batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                           for b in batches]
            K1.launches = 0
            for features in gpu_batches:
                preds = predict_step(features)
                for i in range(len(SCALES)):
                    want = (BATCH, HEIGHT >> i, WIDTH >> i, 1)
                    for key in ("depth_ms", "disp_ms"):
                        got_shape = tuple(preds[key][i].shape)
                        if got_shape != want:
                            raise AssertionError(f"{key}[{i}] is {got_shape}, want {want}")
                        if not bool(torch.isfinite(preds[key][i]).all()):
                            raise AssertionError(f"{key}[{i}] is not finite")
                if tuple(preds["pose"].shape) != (BATCH, 4, 6) \
                        or not bool(torch.isfinite(preds["pose"]).all()):
                    raise AssertionError(f"pose {tuple(preds['pose'].shape)} bad or not finite")
            torch.cuda.synchronize()
            print(f"phase 3 predict: {NUM_BATCHES} batches, depth_ms[0] "
                  f"{tuple(preds['depth_ms'][0].shape)}, pose {tuple(preds['pose'].shape)}, "
                  f"all finite", flush=True)

            phase = "eval"
            gpu_metrics = []
            for features in gpu_batches:
                before = K1.launches
                metrics = eval_step(features)
                if K1.launches - before != len(SCALES):
                    raise AssertionError(f"eval step launched K1 {K1.launches - before} "
                                         f"times, want {len(SCALES)}")
                values = {k: float(v) for k, v in metrics.items()}
                if not all(np.isfinite(v) for v in values.values()):
                    raise AssertionError(f"non-finite eval metrics {values}")
                gpu_metrics.append(values)
            launches = K1.launches
            if launches != len(SCALES) * NUM_BATCHES:
                raise AssertionError(f"K1 launched {launches} times in the main path")
            losses0 = {k: v for k, v in gpu_metrics[0].items() if k.startswith("loss")}
            print(f"phase 4 eval: {NUM_BATCHES} steps, K1 launches {launches}, "
                  f"batch 0 {json.dumps(losses0)}", flush=True)

            # 5. the same eval step on the CPU: the plain warp and CPU convs
            phase = "cpu cross-check"
            cpu_model = copy.deepcopy(model).cpu()
            cpu_metrics = make_eval_step(cpu_model, total_loss)(
                {k: torch.from_numpy(v) for k, v in batches[0].items()})
            if set(losses0) != set(LOSS_TOL):
                raise AssertionError(f"eval losses {sorted(losses0)}, want {sorted(LOSS_TOL)}")
            rel = {}
            for key, value in losses0.items():
                cpu_value = float(cpu_metrics[key])
                diff = abs(value - cpu_value)
                rel[key] = diff / max(abs(cpu_value), 1e-30)
                rtol, atol = LOSS_TOL[key]
                if not diff <= rtol * abs(cpu_value) + atol:
                    raise AssertionError(f"{key}: GPU {value} vs CPU {cpu_value}")
            print(f"phase 5 cross-check: GPU vs CPU eval losses agree within "
                  f"(rtol, atol) {json.dumps(LOSS_TOL)} (rel diff "
                  f"{json.dumps({k: float(f'{r:.3g}') for k, r in rel.items()})}); CPU "
                  f"{json.dumps({k: float(cpu_metrics[k]) for k in losses0})}", flush=True)

            # 6. step timings and peak memory
            phase = "timings"
            torch.cuda.reset_peak_memory_stats(device)
            rounds, steps = 5, 10  # the steps are host-bound: report the spread
            for label, step in (("predict", predict_step), ("eval", eval_step)):
                step(gpu_batches[0])
                torch.cuda.synchronize()
                rates = []
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    for i in range(steps):
                        step(gpu_batches[i % NUM_BATCHES])
                    torch.cuda.synchronize()
                    rates.append(steps * BATCH / (time.perf_counter() - t0))
                rates.sort()
                median = rates[rounds // 2]
                print(f"timing {label} B5 batch {BATCH} {HEIGHT}x{WIDTH} f32: median "
                      f"{median:.2f} images/s ({1000 * BATCH / median:.2f} ms/step), "
                      f"min {rates[0]:.2f}, max {rates[-1]:.2f} over {rounds} rounds of "
                      f"{steps} steps {tag}", flush=True)
            peak = torch.cuda.max_memory_allocated(device)
            print(f"memory: max_memory_allocated {peak / 2**30:.3f} GiB over "
                  f"predict + eval at batch {BATCH} {tag}", flush=True)

            # ms / plain_ms: device time per eval step, summed over the four scales
            print(json.dumps({"kernels": [{
                "name": "K1 warp_const_src_fwd", "route": "cuda",
                "source": k1_module.SOURCE, "replaces": k1_module.REPLACES,
                "launches": launches, "max_abs_err": k1_err,
                "ms": k1_ms, "plain_ms": plain_ms}]}), flush=True)
            print(smi, flush=True)
    except Exception:  # the boundary: report the failed phase, print no result
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
