"""Import a reference (keras H5) checkpoint into the port's checkpoint
layout, so a reference user's trained nets carry over without
retraining.

The reference trains into per-net H5 files
(``{depthnet,posenet,flownet}_{latest|epNN}.h5``). Point this tool at
such a directory and it writes ``{net}_{suffix}.pt`` files that
``train_main`` and ``evaluate_main`` (``predict_by_plan``) load. No
command-line flags; set in ``user_config.py`` (see ``train_main``):

    cfg.import_src = "/path/to/reference/checkpts/vode1/ckpt"
    cfg.import_dst = None            # default: <datapath>/checkpts/<ckpt_name>
    cfg.import_suffix = "latest"     # or "ep20", ...

    python -m xpt_mde_tpu_torch.scripts.import_reference_ckpt

The nets are those of the last training-plan row. Needs h5py.
"""

import sys
from pathlib import Path


def main() -> int:
    from xpt_mde_tpu_torch.scripts.train_main import load_user_config
    from xpt_mde_tpu_torch.training.import_reference import import_reference_checkpoint

    cfg = load_user_config()
    src = getattr(cfg, "import_src", None)
    if not src:
        print("set cfg.import_src to the reference ckpt dir (contains {net}_{suffix}.h5 files)")
        return 1
    dst = getattr(cfg, "import_dst", None) or Path(cfg.datapath_ckp) / cfg.ckpt_name
    suffix = getattr(cfg, "import_suffix", "latest")
    if not cfg.training_plan:
        print("empty training plan; cannot infer net_names")
        return 1
    stage = cfg.training_plan[-1]
    imported = import_reference_checkpoint(src, dst, cfg, stage.net_names, suffix=suffix)
    print(f"[import] done: {imported} -> {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
