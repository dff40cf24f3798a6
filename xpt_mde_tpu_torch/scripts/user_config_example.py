"""User configuration template: copy to ``user_config.py`` beside this
file, set the paths and pick a plan. The entry scripts take no flags.

The nets compute in ``compute_dtype``: ``"bfloat16"`` by default, as in
the JAX package, or ``"float32"`` for parity checks. The port reads shards
under ``{datapath}/shards/{dataset}_{split}``, which
``python -m xpt_mde_tpu_torch.scripts.create_shards_main`` writes from the
raw datasets of ``RAW_DATA_PATHS`` (or the JAX package's
``scripts/create_shards_main.py``: the same bytes).
Stereo datasets (``kitti_raw``, ``kitti_odom``, ``cityscapes``,
``driving_stereo``) train on their right views too, with the stereo
losses of the published recipes.
"""

from xpt_mde_tpu_torch.config import RIGID_NET, Config, TestStage, training_plan_28

# raw dataset locations on this machine; {"synthetic": None} renders
# its drives instead
RAW_DATA_PATHS = {
    "kitti_raw": "/data/kitti_raw_data",
    "kitti_odom": "/data/kitti_odometry",
    "cityscapes": "/data/raw_zips/cityscapes",
    "waymo": "/data/waymo",
    "a2d2": "/data/raw_zips/a2d2/zips",
}

cfg = Config(
    stereo=True,
    high_res=False,
    per_replica_batch=8,
    datapath="/data/xpt_mde_tpu",
    ckpt_name="mde01",
    training_plan=training_plan_28(),
    test_plan=[TestStage(RIGID_NET, "kitti_raw", ["depth"], "mde01", "latest")],
)
