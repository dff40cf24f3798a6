"""3D visualization entry point of the PyTorch port: an Open3D overlay of
the predicted and the GT depth point clouds of each test-plan row's
saved predictions, where open3d is installed (close the window to go on).

No command-line flags; the same ``user_config.py`` as ``train_main``:

    python -m xpt_mde_tpu_torch.scripts.visualize_main
"""

from pathlib import Path


def main() -> None:
    from xpt_mde_tpu_torch.evaluate.visualize import visualize_point_cloud
    from xpt_mde_tpu_torch.scripts.train_main import load_user_config

    cfg = load_user_config()
    for stage in cfg.test_plan:
        npz = Path(cfg.datapath_prd) / stage.ckpt_name / f"{stage.dataset}_{stage.weight_suffix}.npz"
        if not npz.exists():
            print(f"[visualize] no predictions: {npz}")
            continue
        print(f"[visualize] {npz} (close the window to advance)")
        visualize_point_cloud(npz)


if __name__ == "__main__":
    main()
