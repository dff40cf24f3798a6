"""Typed configuration: constants, loss recipes, training and test plans
(port of ``xpt_mde_tpu.config``).

Copied, not imported: the port imports nothing of the JAX package.
``tests/test_torch_data.py`` and ``tests/test_torch_data_in.py`` hold
every constant, recipe, plan and ``Config`` field here equal to the
reference's, defaults included: ``Config.compute_dtype`` is
``"bfloat16"`` by default, as in the JAX package, and ``"float32"`` is
the parity mode; any other value raises. The TPU-only modes
``warp_kernel`` and ``warp_gather_dtype`` are accepted and change
nothing: K1 computes the exact float32 sample whatever they say.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# fixed data / loss constants

SNIPPET_LEN = 5
NUM_SRC = SNIPPET_LEN - 1
MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0

IMAGE_SIZES_SMALL = {
    "kitti_raw": (128, 512),
    "kitti_odom": (128, 512),
    "cityscapes": (192, 512),
    "waymo": (256, 384),
    "a2d2": (192, 384),
    "driving_stereo": (128, 512),
    "synthetic": (128, 384),
}
IMAGE_SIZES_LARGE = {
    "kitti_raw": (256, 1024),
    "kitti_odom": (256, 1024),
    "cityscapes": (384, 1024),
    "waymo": (512, 768),
    "a2d2": (384, 768),
    "driving_stereo": (256, 1024),
    "synthetic": (256, 768),
}

IMAGE_GRADIENT_FACTOR = 4.0
SMOOTHNESS_FACTOR = 20.0
SSIM_RATIO = 0.5
# per-scale loss weights, finest scale first
SCALE_WEIGHT_T1 = tuple(w * 4.0 for w in (0.25, 0.25, 0.25, 0.25))
SCALE_WEIGHT_T2 = tuple(w * 4.0 for w in (0.1, 0.2, 0.3, 0.4))

# ---------------------------------------------------------------------------
# loss recipes (name -> weight); names match the loss pool of
# ``losses/total.py``

LOSS_RIGID_T1 = {
    "L1": 1.0 - SSIM_RATIO, "L1_R": 1.0 - SSIM_RATIO,
    "SSIM": SSIM_RATIO, "SSIM_R": SSIM_RATIO,
    "smoothe": 1.0, "smoothe_R": 1.0,
    "stereoL1": 0.01, "stereoSSIM": 0.01,
    "stereoPose": 1.0,
}
LOSS_RIGID_T2 = {
    "L1": 1.0 - SSIM_RATIO, "L1_R": 1.0 - SSIM_RATIO,
    "SSIM": SSIM_RATIO, "SSIM_R": SSIM_RATIO,
    "smoothe": SMOOTHNESS_FACTOR, "smoothe_R": SMOOTHNESS_FACTOR,
    "stereoL1": 1.0 - SSIM_RATIO, "stereoSSIM": SSIM_RATIO,
    "stereoPose": 1.0,
}
LOSS_RIGID_COMB = {
    "cmbL1": (1.0 - SSIM_RATIO) * 10, "cmbL1_R": (1.0 - SSIM_RATIO) * 10,
    "cmbSSIM": SSIM_RATIO, "cmbSSIM_R": SSIM_RATIO,
    "smoothe": SMOOTHNESS_FACTOR, "smoothe_R": SMOOTHNESS_FACTOR,
    "stereoL1": 1.0 - SSIM_RATIO, "stereoSSIM": SSIM_RATIO,
    "stereoPose": 1.0,
}
LOSS_RIGID_MOA = {
    "moaL1": (1.0 - SSIM_RATIO) * 10, "moaL1_R": (1.0 - SSIM_RATIO) * 10,
    "moaSSIM": SSIM_RATIO, "moaSSIM_R": SSIM_RATIO,
    "smoothe": SMOOTHNESS_FACTOR, "smoothe_R": SMOOTHNESS_FACTOR,
    "stereoPose": 1.0,
}
LOSS_RIGID_MOA_WST = {
    **LOSS_RIGID_MOA,
    "stereoL1": 1.0 - SSIM_RATIO, "stereoSSIM": SSIM_RATIO,
}
LOSS_RIGID_MD2 = {
    "md2L1": 1.0 - SSIM_RATIO, "md2L1_R": 1.0 - SSIM_RATIO,
    "md2SSIM": SSIM_RATIO, "md2SSIM_R": SSIM_RATIO,
    "smoothe": 1.0, "smoothe_R": 1.0,
    "stereoL1": 1.0 - SSIM_RATIO, "stereoSSIM": SSIM_RATIO,
    "stereoPose": 1.0,
}
LOSS_FLOW = {"flowL2": 1.0, "flowL2_R": 1.0, "flow_reg": 4e-7}

# ---------------------------------------------------------------------------
# net-name groups

JOINT_NET = {"depth": "EfficientNetB5", "camera": "PoseNetImproved", "flow": "PWCNet"}
RIGID_NET = {"depth": JOINT_NET["depth"], "camera": JOINT_NET["camera"]}
FLOW_NET = {"flow": "PWCNet"}

# PWC-Net's largest displacement, at stride 1 (level p searches 128 / 2^p)
MAX_DISPLACEMENT = 128

# the default augmentation probabilities (``Config.augment_probs``)
AUGMENT_PROBS = {"CropAndResize": 0.2, "HorizontalFlip": 0.2, "ColorJitter": 0.2}


@dataclass(frozen=True)
class TrainStage:
    """One row of a training plan."""

    net_names: Mapping[str, str]
    dataset: str
    epochs: int
    learning_rate: float
    loss_weights: Mapping[str, float]
    scale_weights: Sequence[float]
    save_ckpt: bool = True


@dataclass(frozen=True)
class TestStage:
    """One row of a test plan."""

    net_names: Mapping[str, str]
    dataset: str
    out_keys: Sequence[str]
    ckpt_name: str
    weight_suffix: str = "latest"


def training_plan_28(loss_pretrain=LOSS_RIGID_T2, loss_finetune=LOSS_RIGID_COMB,
                     fine_tune_net=JOINT_NET) -> list[TrainStage]:
    """The headline multi-dataset pretraining plan."""
    sw = SCALE_WEIGHT_T1
    return [
        TrainStage(RIGID_NET, "kitti_raw", 5, 1e-5, LOSS_RIGID_T1, sw),
        TrainStage(RIGID_NET, "kitti_raw", 10, 1e-4, loss_pretrain, sw),
        TrainStage(RIGID_NET, "a2d2", 10, 1e-4, loss_pretrain, sw),
        TrainStage(RIGID_NET, "waymo", 10, 1e-4, LOSS_RIGID_T2, sw),
        TrainStage(RIGID_NET, "kitti_odom", 10, 1e-4, loss_pretrain, sw),
        TrainStage(RIGID_NET, "cityscapes", 10, 1e-5, loss_pretrain, sw),
        TrainStage(RIGID_NET, "kitti_raw", 5, 1e-4, loss_pretrain, sw),
        TrainStage(fine_tune_net, "kitti_raw", 10, 1e-4, loss_finetune, sw),
        TrainStage(fine_tune_net, "kitti_raw", 10, 1e-5, loss_finetune, sw),
        TrainStage(fine_tune_net, "kitti_raw", 5, 1e-6, loss_finetune, sw),
    ]


def training_plan_30() -> list[TrainStage]:
    """KITTI-only ablation plan."""
    sw = SCALE_WEIGHT_T1
    return [
        TrainStage(RIGID_NET, "kitti_raw", 5, 1e-5, LOSS_RIGID_T1, sw),
        TrainStage(RIGID_NET, "kitti_raw", 10, 1e-4, LOSS_RIGID_T2, sw),
        TrainStage(RIGID_NET, "kitti_raw", 5, 1e-4, LOSS_RIGID_T2, sw),
        TrainStage(JOINT_NET, "kitti_raw", 10, 1e-4, LOSS_RIGID_COMB, sw),
        TrainStage(JOINT_NET, "kitti_raw", 10, 1e-5, LOSS_RIGID_COMB, sw),
        TrainStage(JOINT_NET, "kitti_raw", 5, 1e-6, LOSS_RIGID_COMB, sw),
    ]


@dataclass
class Config:
    """Top-level configuration; the entry scripts take no CLI flags and
    read one of these instead. The fields are the reference's; see the
    module docstring for the one default that differs."""

    # data
    stereo: bool = True
    high_res: bool = False
    snippet_len: int = SNIPPET_LEN
    min_depth: float = MIN_DEPTH
    max_depth: float = MAX_DEPTH

    # training
    per_replica_batch: int = 8
    optimizer: str = "adam_constant"
    depth_activation: str = "InverseSigmoid"  # or "Exponential"
    pretrained_weight: bool = True
    compute_dtype: str = "bfloat16"  # "float32" for parity checks
    train_mode: str = "jit"  # "eager" | "jit" | "distributed"
    # TPU-only warp modes: accepted, ignored (K1 is exact float32)
    warp_gather_dtype: str = "float32"
    warp_kernel: str = "pallas"

    augment_probs: Mapping[str, float] = field(default_factory=lambda: dict(AUGMENT_PROBS))

    # nets
    joint_net: Mapping[str, str] = field(default_factory=lambda: dict(JOINT_NET))
    depth_upsample_interp: str = "nearest"

    # paths (set by user scripts)
    datapath: str = "/tmp/xpt_mde_tpu_data"
    ckpt_name: str = "mde01"

    # plan
    training_plan: Sequence[TrainStage] = field(default_factory=training_plan_30)
    test_plan: Sequence[TestStage] = field(default_factory=list)

    # misc
    validation_frames: int = 500
    frames_per_shard: int = 2000
    log_loss: bool = True
    # value-distribution trace 3x per epoch (one extra forward each)
    inspect_model: bool = False
    shard_build_workers: int = 0
    # input pipeline: batches assembled on N threads, order-preserving
    loader_workers: int = 1
    # predict_by_plan host-memory budget: predictions flush to part
    # files past this size
    predict_flush_mb: int = 2048
    grad_accum_steps: int = 1
    # checkpoint the full train state every N steps (0 = epoch ends only)
    ckpt_every_steps: int = 0

    mesh_shape: Mapping[str, int] = field(default_factory=lambda: {"data": 1})

    # per-dataset (H, W) overrides on top of the low/high-res tables
    image_size_overrides: Mapping[str, tuple] = field(default_factory=dict)

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.compute_dtype!r}")

    @property
    def image_sizes(self) -> Mapping[str, tuple[int, int]]:
        base = IMAGE_SIZES_LARGE if self.high_res else IMAGE_SIZES_SMALL
        if not self.image_size_overrides:
            return base
        merged = dict(base)
        merged.update({k: tuple(v) for k, v in self.image_size_overrides.items()})
        return merged

    @property
    def batch_size(self) -> int:
        ndev = 1
        for n in self.mesh_shape.values():
            ndev *= n
        return self.per_replica_batch * ndev

    def get_img_shape(self, code: str = "HW", dataset: str = "kitti_raw",
                      scale_div: int = 1):
        """Shape helper: H/W/HW/WH/HWC/SHW/SHWC/BSHWC/RSHWC."""
        h, w = self.image_sizes[dataset]
        h, w = h // scale_div, w // scale_div
        s, b, r = self.snippet_len, self.batch_size, self.per_replica_batch
        codes = {
            "H": h, "W": w, "HW": (h, w), "WH": (w, h), "HWC": (h, w, 3),
            "SHW": (s, h, w), "SHWC": (s, h, w, 3),
            "BSHWC": (b, s, h, w, 3), "RSHWC": (r, s, h, w, 3),
        }
        if code not in codes:
            raise ValueError(f"Invalid shape code: {code}")
        return codes[code]

    # sub-paths of the data directory
    @property
    def datapath_src(self): return f"{self.datapath}/srcdata"
    @property
    def datapath_shd(self): return f"{self.datapath}/shards"
    @property
    def datapath_ckp(self): return f"{self.datapath}/checkpts"
    @property
    def datapath_log(self): return f"{self.datapath}/log"
    @property
    def datapath_prd(self): return f"{self.datapath}/prediction"
    @property
    def datapath_evl(self): return f"{self.datapath}/evaluation"

    def to_json_dict(self) -> dict[str, Any]:
        """JSON-serializable snapshot, for the config-drift check on resume."""
        def convert(v):
            if isinstance(v, (list, tuple)):
                return [convert(x) for x in v]
            if dataclasses.is_dataclass(v):
                return {k: convert(getattr(v, k)) for k in
                        (f.name for f in dataclasses.fields(v))}
            if isinstance(v, Mapping):
                return {k: convert(x) for k, x in v.items()}
            if isinstance(v, np.floating):
                return float(v)
            if isinstance(v, np.integer):
                return int(v)
            return v
        return {f.name: convert(getattr(self, f.name))
                for f in dataclasses.fields(self)}
