"""Depth comparison entry point of the PyTorch port: side-by-side
colormapped disparity panels (input image | our prediction | other
methods' precomputed results) of each test-plan row's saved predictions,
under ``datapath_evl/{ckpt_name}/depth_compare_{dataset}``.

No command-line flags; the same ``user_config.py`` as ``train_main``. Set
``cfg.external_disparities = {"monodepth2": "/path/disps.npy", ...}``
(arrays, or ``.npy`` files of [N, h, w] disparities) to add columns:

    python -m xpt_mde_tpu_torch.scripts.compare_depth_main
"""

from pathlib import Path


def main() -> None:
    import numpy as np

    from xpt_mde_tpu_torch.evaluate.visualize import compare_depths
    from xpt_mde_tpu_torch.scripts.train_main import load_user_config

    cfg = load_user_config()
    external = {name: np.load(disps) if isinstance(disps, (str, Path)) else disps
                for name, disps in (getattr(cfg, "external_disparities", None) or {}).items()}
    for stage in cfg.test_plan:
        npz = Path(cfg.datapath_prd) / stage.ckpt_name / f"{stage.dataset}_{stage.weight_suffix}.npz"
        if not npz.exists():
            print(f"[compare_depth] no predictions: {npz}")
            continue
        out_dir = Path(cfg.datapath_evl) / stage.ckpt_name / f"depth_compare_{stage.dataset}"
        compare_depths(npz, out_dir, external_disparities=external)
        print(f"[compare_depth] wrote {out_dir}")


if __name__ == "__main__":
    main()
