"""File-based training logs (port of part of ``xpt_mde_tpu.training.logger``).

``history.csv`` holds one row per epoch with ``train_*`` and ``val_*``
columns, the same columns the JAX logger writes for the same metrics;
it also drives resume (``checkpoint.read_previous_epoch``).
``mean_result.csv`` holds each column's mean over the epochs and
``scales.txt`` the quantiles of the predicted depth and pose each epoch.
The JAX logger's loss plot and reconstruction panels are not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np


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


def print_progress(msg: str) -> None:
    """In-place progress line."""
    print(f"\r{msg}", end="", flush=True)
