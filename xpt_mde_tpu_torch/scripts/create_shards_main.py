"""Dataset preparation entry point of the PyTorch port: convert raw
datasets into fixed-record shards and validation splits under
``{datapath}/shards``, as the JAX package's ``scripts/create_shards_main.py``
does (same shards, byte for byte).

No command-line flags: it reads ``cfg`` and ``RAW_DATA_PATHS`` from
``user_config.py`` beside this file (the example's paths where it has
none; copy ``user_config_example.py``) and runs, from the repository root,

    python -m xpt_mde_tpu_torch.scripts.create_shards_main

KITTI datasets get a train and a test split, the others a train split;
each then a validation split. It runs on the host: the synthetic dataset
(``RAW_DATA_PATHS = {"synthetic": None}``) needs numpy only, the readers
of real datasets OpenCV or PIL to decode their files
(``xpt_mde_tpu_torch/data/readers/__init__.py``). Drives build in
``cfg.shard_build_workers`` processes.
"""

from xpt_mde_tpu_torch.scripts.train_main import USER_CONFIG, load_user_config


def load_raw_data_paths() -> dict:
    """``RAW_DATA_PATHS`` of ``user_config.py``, else of the example."""
    try:
        from xpt_mde_tpu_torch.scripts.user_config import RAW_DATA_PATHS  # type: ignore
    except ImportError as exc:
        if isinstance(exc, ModuleNotFoundError) and exc.name != USER_CONFIG:
            raise
        print("[create_shards_main] no RAW_DATA_PATHS in user_config; using "
              "user_config_example's")
        from xpt_mde_tpu_torch.scripts.user_config_example import RAW_DATA_PATHS
    return RAW_DATA_PATHS


def main() -> dict:
    """Build every dataset of ``RAW_DATA_PATHS``; returns
    ``convert_to_shards``' ``{"<dataset>_<split>": build_mode}``."""
    from xpt_mde_tpu_torch.data.shard_maker import convert_to_shards

    cfg = load_user_config()
    raw_data_paths = load_raw_data_paths()
    datasets = {name: (["train", "test"] if name.startswith("kitti") else ["train"])
                for name in raw_data_paths}
    return convert_to_shards(cfg, raw_data_paths, datasets)


if __name__ == "__main__":
    main()
