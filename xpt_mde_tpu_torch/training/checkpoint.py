"""Checkpoints: per-net weights and full-state resume (port of
``xpt_mde_tpu.training.checkpoint``).

Files, all torch state dicts written atomically (a temporary name, then
a rename, so a crash mid-save never leaves a truncated file):

- ``{net}_{suffix}.pt`` per top-level net (``depthnet``, ``posenet``,
  ``flownet``) with its BatchNorm buffers inside, so a plan row with
  another net set loads exactly the nets it shares with the row before;
- ``trainstate_{suffix}.pt``: every net, the optimizer's state, the step
  count and the plan row (stage) it belongs to, for an exact resume of
  the same row; another row starts a fresh optimizer;
- ``trainstate_midway.pt`` + ``midway.json`` every
  ``Config.ckpt_every_steps`` steps, for a mid-epoch resume; the JSON
  sidecar is written after the state, so its presence commits the pair.

"latest" is written every epoch and "ep{NN}" at a row's end; the epoch to
resume from comes from ``history.csv``. ``snapshot_config`` refuses a
resume whose fixed options drifted.
"""

from __future__ import annotations

import json
import os
import pickle
from pathlib import Path

import torch

from xpt_mde_tpu_torch.utils.util_class import WrongInputError

# what a damaged or foreign checkpoint file raises on load
_LOAD_ERRORS = (RuntimeError, ValueError, KeyError, EOFError, OSError,
                pickle.UnpicklingError)


def _save_atomic(obj, path: Path) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _nets(model: torch.nn.Module) -> dict:
    """The top-level nets of a VodeModel, by name."""
    return dict(model.named_children())


def _load(path: Path, model: torch.nn.Module):
    device = next(model.parameters()).device
    return torch.load(path, map_location=device, weights_only=True)


def _check_state(net: torch.nn.Module, state: dict, name: str) -> None:
    """Raise unless ``state`` has exactly ``net``'s keys and shapes, so a
    failed load never leaves a net half loaded."""
    own = net.state_dict()
    if set(state) != set(own):
        raise RuntimeError(f"{name}: keys differ ({len(set(state) ^ set(own))} not shared)")
    for key, value in own.items():
        if tuple(state[key].shape) != tuple(value.shape):
            raise RuntimeError(f"{name}.{key}: shape {tuple(state[key].shape)} != "
                               f"{tuple(value.shape)}")


def _full_state(model, optimizer, step: int, stage_idx: int) -> dict:
    return {"nets": {name: net.state_dict() for name, net in _nets(model).items()},
            "optimizer": optimizer.state_dict(), "step": int(step), "stage": int(stage_idx)}


class CheckpointManager:
    def __init__(self, ckpt_dir):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)

    def save(self, model, optimizer, suffix: str = "latest", stage_idx: int = -1,
             step: int = 0) -> None:
        """Per-net weights and the full train state, tagged with its plan row."""
        for name, net in _nets(model).items():
            _save_atomic(net.state_dict(), self.ckpt_dir / f"{name}_{suffix}.pt")
        _save_atomic(_full_state(model, optimizer, step, stage_idx),
                     self.ckpt_dir / f"trainstate_{suffix}.pt")

    def restore_params(self, model, suffix: str = "latest") -> bool:
        """Load the per-net weights that exist on disk and in the model;
        a net without a file, or whose file does not fit, trains from
        scratch. :return: whether any net was loaded"""
        loaded_any = False
        for name, net in _nets(model).items():
            path = self.ckpt_dir / f"{name}_{suffix}.pt"
            if not path.is_file():
                print(f"[ckpt] no weights for {name}, train from scratch")
                continue
            try:
                state = _load(path, model)
                _check_state(net, state, name)
                net.load_state_dict(state)
            except _LOAD_ERRORS as e:
                print(f"[ckpt] FAILED to load {name}: {e}")
                continue
            loaded_any = True
            print(f"[ckpt] loaded {name} from {path.name}")
        return loaded_any

    def restore_full(self, model, optimizer, suffix: str = "latest",
                     stage_idx: int = -1) -> int | None:
        """Exact resume (every net, the optimizer, the step) when the file
        belongs to the same plan row and fits the model; else None (a new
        row starts a fresh optimizer even where its nets match the last
        row's). :return: the restored step count, or None"""
        path = self.ckpt_dir / f"trainstate_{suffix}.pt"
        if not path.is_file():
            return None
        try:
            full = _load(path, model)
            nets = _nets(model)
            if full["stage"] != stage_idx:
                print("[ckpt] full state belongs to another stage; "
                      "loading per-net weights with a fresh optimizer")
                return None
            if set(full["nets"]) != set(nets):
                raise RuntimeError(f"nets {sorted(full['nets'])} != {sorted(nets)}")
            for name, net in nets.items():
                _check_state(net, full["nets"][name], name)
            optimizer.load_state_dict(full["optimizer"])
        except _LOAD_ERRORS as e:
            print(f"[ckpt] full-state restore incompatible ({e}); "
                  "falling back to per-net weights")
            return None
        for name, net in nets.items():
            net.load_state_dict(full["nets"][name])
        return int(full["step"])

    def save_midway(self, model, optimizer, stage_idx: int, epoch: int, steps_done: int,
                    metric_sums: dict, count: int, step: int) -> None:
        _save_atomic(_full_state(model, optimizer, step, stage_idx),
                     self.ckpt_dir / "trainstate_midway.pt")
        meta = {"stage": stage_idx, "epoch": epoch, "steps_done": steps_done,
                "metric_sums": {k: float(v) for k, v in metric_sums.items()},
                "count": count}
        tmp = self.ckpt_dir / "midway.json.tmp"
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, self.ckpt_dir / "midway.json")

    def restore_midway(self, model, optimizer, stage_idx: int, epoch: int):
        """(step, steps_done, metric_sums, count) where a midway checkpoint
        exists for exactly this (stage, epoch), else None."""
        meta_path = self.ckpt_dir / "midway.json"
        if not meta_path.is_file():
            return None
        try:
            meta = json.loads(meta_path.read_text())
        except ValueError:
            return None
        if meta.get("stage") != stage_idx or meta.get("epoch") != epoch:
            return None
        step = self.restore_full(model, optimizer, "midway", stage_idx)
        if step is None:
            return None
        print(f"[ckpt] mid-epoch resume: stage {stage_idx} epoch {epoch} "
              f"at step {meta['steps_done']}")
        return step, int(meta["steps_done"]), dict(meta["metric_sums"]), int(meta["count"])

    def clear_midway(self) -> None:
        """Drop the midway checkpoint once its epoch completes (the epoch's
        "latest" checkpoint and history.csv take over)."""
        for name in ("midway.json", "trainstate_midway.pt"):
            path = self.ckpt_dir / name
            if path.is_file():
                path.unlink()


def read_previous_epoch(ckpt_dir) -> int:
    """Next epoch to run, from history.csv."""
    hist = Path(ckpt_dir) / "history.csv"
    if not hist.is_file():
        return 0
    epochs = []
    for line in hist.read_text().strip().splitlines()[1:]:
        try:
            epochs.append(int(float(line.split(",")[0])))
        except (ValueError, IndexError):
            continue
    return max(epochs) + 1 if epochs else 0


def snapshot_config(ckpt_dir, config_dict: dict) -> None:
    """Save the config beside the checkpoints; on resume, refuse a change
    of the fixed options."""
    path = Path(ckpt_dir) / "config_snapshot.json"
    if path.exists():
        old = json.loads(path.read_text())
        fixed_keys = ["stereo", "high_res", "snippet_len", "min_depth",
                      "max_depth", "depth_activation"]
        for key in fixed_keys:
            if key in old and old.get(key) != config_dict.get(key):
                raise WrongInputError(f"config drift on resume: {key}: "
                                      f"{old.get(key)} != {config_dict.get(key)}")
    else:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(config_dict, indent=2, default=str))


def load_pretrained_backbone(model, pretrained_path) -> bool:
    """Graft converted backbone weights into the depth net's backbone, in
    place: ``<datapath>/pretrained/<net>.msgpack`` as either package's
    ``scripts/convert_backbone_weights.py`` writes it from keras ImageNet
    weights (a flax ``{"params", "batch_stats"}`` tree, read without flax
    by ``utils/flax_msgpack.py``), mapped by ``convert.py`` onto the
    backbone's parameters and BatchNorm buffers.

    Every key and shape is checked before anything is loaded: a file of
    another backbone or width loads nothing, as the JAX package's
    ``from_bytes`` failure does.

    :return: whether the weights were loaded (False for a missing file, a
        model without a depth-net backbone, or an incompatible file)
    """
    from xpt_mde_tpu_torch.convert import flax_to_state_dict
    from xpt_mde_tpu_torch.utils.flax_msgpack import from_bytes

    path = Path(pretrained_path)
    depthnet = getattr(model, "depthnet", None)
    backbone = getattr(depthnet, "backbone", None)
    if not path.is_file() or backbone is None:
        return False
    try:
        tree = from_bytes(path.read_bytes())
        variables = {name: tree[name] for name in ("params", "batch_stats") if name in tree}
        state = flax_to_state_dict(variables, backbone)
    except (KeyError, ValueError, TypeError) as e:
        print(f"[ckpt] pretrained backbone incompatible ({e})")
        return False
    backbone.load_state_dict(state)
    print(f"[ckpt] loaded pretrained backbone from {path}")
    return True
