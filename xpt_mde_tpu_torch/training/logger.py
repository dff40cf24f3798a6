"""File-based training logs (port of ``xpt_mde_tpu.training.logger``).

``history.csv`` holds one row per epoch with ``train_*`` and ``val_*``
columns, the same columns the JAX logger writes for the same metrics;
it also drives resume (``checkpoint.read_previous_epoch``).
``mean_result.csv`` holds each column's mean over the epochs,
``history.png`` the train and val loss curves (matplotlib), ``scales.txt``
the quantiles of the predicted depth and pose each epoch, and
``reconstruction/ep{NNN}_{i}.png`` titled panels of one example batch:
target, depth, source, the view synthesized from it, and for flow and
stereo rows the flow, the flow-warped source and the view synthesized
from the right camera (``cv2``). The views are synthesized on the
predictions' device, through the warp kernel on a card. As in the JAX
logger, a failed plot or panel is printed and never stops training;
matplotlib and cv2 are imported only where they draw.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np
import torch


class TrainingLogger:
    def __init__(self, ckpt_dir, log_loss: bool = True):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.log_loss = log_loss

    def save_log(self, epoch: int, train_metrics: dict, val_metrics: dict) -> None:
        """Append one epoch row to history.csv, widening the file when an
        epoch brings new columns (a later plan row with other losses)."""
        row = {"epoch": epoch}
        row.update({f"train_{k.replace('/', '_')}": float(v)
                    for k, v in train_metrics.items()})
        row.update({f"val_{k.replace('/', '_')}": float(v)
                    for k, v in val_metrics.items()})
        hist_file = self.ckpt_dir / "history.csv"
        # a crash can leave the csv present but empty: start it afresh
        if hist_file.exists() and hist_file.read_text().strip():
            lines = hist_file.read_text().splitlines()
            header = lines[0].split(",")
            new_cols = [k for k in row if k not in header]
            if new_cols:
                header += new_cols
                pad = "," * len(new_cols)
                body = [lines[0] + "," + ",".join(new_cols)]
                body += [ln + pad for ln in lines[1:]]
                hist_file.write_text("\n".join(body) + "\n")
                self._write_column_guide(header)
            with open(hist_file, "a") as fh:
                fh.write(",".join(str(row.get(h, "")) for h in header) + "\n")
        else:
            header = list(row.keys())
            with open(hist_file, "w") as fh:
                fh.write(",".join(header) + "\n")
                fh.write(",".join(str(row[h]) for h in header) + "\n")
            self._write_column_guide(header)
        self.save_mean_result()
        self.save_history_plot()

    def _write_column_guide(self, header) -> None:
        lines = ["history.csv columns:",
                 "  train_* : training-epoch means",
                 "  val_*   : validation-epoch means",
                 "  loss_<name> : per-loss-type component (recipe weights"
                 " NOT applied)", ""]
        lines += [f"  {h}" for h in header]
        (self.ckpt_dir / "how-to-read-columns.txt").write_text("\n".join(lines) + "\n")

    def save_mean_result(self) -> None:
        """mean_result.csv: each column's mean over the epochs (empty cells
        skipped; a column with none is left empty)."""
        with open(self.ckpt_dir / "history.csv", newline="") as fh:
            rows = list(csv.DictReader(fh))
        columns = [c for c in (rows[0] if rows else {}) if c != "epoch"]
        lines = ["metric,mean"]
        for col in columns:
            values = [float(r[col]) for r in rows if r.get(col) not in ("", None)]
            mean = float(np.mean(values)) if values else math.nan
            lines.append(f"{col},{'' if math.isnan(mean) else repr(mean)}")
        (self.ckpt_dir / "mean_result.csv").write_text("\n".join(lines) + "\n")

    def save_history_plot(self) -> None:
        """history.png: the train and val loss curves over the epochs."""
        hist_file = self.ckpt_dir / "history.csv"
        if not hist_file.exists():
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            with open(hist_file, newline="") as fh:
                rows = list(csv.DictReader(fh))
            fig, ax = plt.subplots(figsize=(8, 5))
            epochs = [float(r["epoch"]) for r in rows]
            for col in ("train_loss", "val_loss"):
                if rows and col in rows[0]:
                    ax.plot(epochs, [float(r[col]) if r[col] not in ("", None) else math.nan
                                     for r in rows], label=col)
            ax.set_xlabel("epoch")
            ax.set_ylabel("loss")
            ax.legend()
            ax.grid(True, alpha=0.3)
            fig.savefig(self.ckpt_dir / "history.png", dpi=80)
            plt.close(fig)
        except Exception as e:  # plotting must never stop training
            print(f"[TrainingLogger] plot failed: {e}")

    def save_scales(self, epoch: int, preds: dict) -> None:
        """Append the 2/25/50/75/98% quantiles of the finest predicted depth
        and of the pose."""
        lines = [f"epoch {epoch}"]
        for key in ("depth_ms", "pose"):
            if key not in preds:
                continue
            val = preds[key][0] if isinstance(preds[key], list) else preds[key]
            val = np.asarray(val.detach().cpu() if hasattr(val, "detach") else val)
            qs = np.quantile(val, [0.02, 0.25, 0.5, 0.75, 0.98])
            lines.append(f"  {key}: " + " ".join(f"{q:.4f}" for q in qs))
        with open(self.ckpt_dir / "scales.txt", "a") as fh:
            fh.write("\n".join(lines) + "\n")

    def save_reconstruction_samples(self, epoch: int, features: dict, preds: dict,
                                    num: int = 4) -> None:
        """Titled panels of the first ``num`` samples, one png each:
        target / depth / source / rigid-synthesized views, plus the flow
        (:func:`flow_to_image`) and the flow-warped source for rows with a
        flownet, and the right target and the view synthesized from it for
        stereo rows. ``features`` hold decoded [-1, 1] images."""
        try:
            import cv2

            if "depth_ms" not in preds or "pose" not in preds:
                return
            out_dir = self.ckpt_dir / "reconstruction"
            out_dir.mkdir(exist_ok=True)
            views = _reconstruction_views(features, preds)
            for i in range(min(num, len(views["left_target"]))):
                panel = stack_titled_images({name: img[i] for name, img in views.items()})
                cv2.imwrite(str(out_dir / f"ep{epoch:03d}_{i}.png"), panel)
        except Exception as e:  # panels must never stop training
            print(f"[TrainingLogger] recon samples failed: {e}")


def to_numpy(value) -> np.ndarray:
    """A tensor (on any device, in any float dtype) or an array as float32 numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value, np.float32)


def _reconstruction_views(features: dict, preds: dict) -> dict:
    """Per-sample view images [B, h, w, 3] in [-1, 1], keyed by panel title.
    The synthesis runs on the device of the predicted depth (numpy inputs:
    the CPU) in full float32."""
    from xpt_mde_tpu_torch.ops.flow_warp import flow_warp_multi_scale
    from xpt_mde_tpu_torch.ops.synthesize import synthesize_multi_scale
    from xpt_mde_tpu_torch.utils import se3
    from xpt_mde_tpu_torch.utils.precision import full_f32

    depth_pred = preds["depth_ms"][0]
    device = depth_pred.device if isinstance(depth_pred, torch.Tensor) else torch.device("cpu")

    def tensor(value):
        value = value if isinstance(value, torch.Tensor) else torch.from_numpy(to_numpy(value))
        return value.to(device, torch.float32)

    image5d = to_numpy(features["image5d"])
    intrinsic = tensor(features["intrinsic"])
    source = tensor(features["image5d"])[:, :-1]
    depth0 = tensor(depth_pred)
    with full_f32(), torch.no_grad():
        views = {"left_target": image5d[:, -1]}
        depth = to_numpy(depth_pred)[:, :, :, 0]
        views["target_depth"] = _viridis((np.clip(depth / 80.0, 0, 1) * 255).astype(np.uint8))
        views["source_0"] = image5d[:, 0]
        synth = synthesize_multi_scale(source, intrinsic, [depth0], tensor(preds["pose"]))[0]
        views["synthesized_from_src0"] = to_numpy(synth[:, 0])

        if "flow_ms" in preds:
            flow0 = to_numpy(preds["flow_ms"][0])  # [B, N, h/4, w/4, 2]
            views["flow"] = np.stack([flow_to_image(flow0[b, 0])
                                      for b in range(flow0.shape[0])])
            warped = flow_warp_multi_scale(source, [tensor(flow0)])[0]
            views["synthesized_by_flow"] = to_numpy(warped[:, 0])

        if "image5d_R" in features and "stereo_T_LR" in features:
            target_r = tensor(features["image5d_R"])[:, -1]
            # the 4x4 right->left transform itself, as the stereo loss
            # synthesizes, not a twist round trip
            pose_rl = se3.invert_matrix(tensor(features["stereo_T_LR"]))[:, None]
            stereo_synth = synthesize_multi_scale(target_r[:, None], intrinsic, [depth0],
                                                  pose_rl)[0]
            views["right_source"] = to_numpy(target_r)
            views["synthesized_from_right"] = to_numpy(stereo_synth[:, 0])
    return views


def _viridis(gray8: np.ndarray) -> np.ndarray:
    import cv2

    out = np.stack([cv2.applyColorMap(g, cv2.COLORMAP_VIRIDIS) for g in gray8])
    return out.astype(np.float32) / 127.5 - 1.0  # back to [-1, 1]


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """Optical flow [h, w, 2] -> a [-1, 1] RGB image, the reference's
    encoding: R = 1 - u/10, G = 1 + u/10, B = 1 - |v|/10, with u and v
    clipped to [-10, 10]. The values land in [0, 1], the upper half of the
    display range, as the reference renders them."""
    flow = np.clip(np.asarray(flow, np.float32), -10, 10) / 10
    height, width, _ = flow.shape
    image = np.ones((height, width, 3), dtype=np.float32)
    image[:, :, 0] = 1 - flow[:, :, 0]
    image[:, :, 1] = 1 + flow[:, :, 0]
    image[:, :, 2] = 1 - np.abs(flow[:, :, 1])
    return np.clip(image, -1, 1)


def stack_titled_images(views: dict) -> np.ndarray:
    """[-1, 1] float views stacked vertically under 12-row title banners,
    as one uint8 image; views narrower than the first are scaled up to
    its width (nearest)."""
    import cv2

    base_w = views[next(iter(views))].shape[1]
    panels = []
    for name, img in views.items():
        img8 = ((np.clip(np.asarray(img), -1, 1) + 1) / 2 * 255).astype(np.uint8)
        if img8.shape[1] != base_w:
            scale = base_w / img8.shape[1]
            img8 = cv2.resize(img8, (base_w, int(img8.shape[0] * scale)),
                              interpolation=cv2.INTER_NEAREST)
        banner = np.zeros((12, base_w, 3), np.uint8)
        cv2.putText(banner, name, (2, 9), cv2.FONT_HERSHEY_PLAIN, 0.7, (255, 255, 255), 1)
        panels.extend([banner, img8])
    return np.concatenate(panels, axis=0)


def print_progress(msg: str) -> None:
    """In-place progress line."""
    print(f"\r{msg}", end="", flush=True)
