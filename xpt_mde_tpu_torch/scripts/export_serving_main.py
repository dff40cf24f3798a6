"""Export a serving artifact for every row of the test plan (port of the
JAX package's ``scripts/export_serving_main.py``).

It walks ``cfg.test_plan`` as ``predict_by_plan`` does, but saves each
row's predict step (``serving.export_predictor``) instead of running it:

    python -m xpt_mde_tpu_torch.scripts.export_serving_main

Each artifact goes to ``{datapath_prd}/{ckpt_name}/serving_{dataset}_{suffix}/``
and is exported from the test loader's raw batch, so it takes uint8
snippets of ``cfg.batch_size`` and decodes them itself; it loads with
``xpt_mde_tpu_torch.serving.load_predictor``. A row whose artifact exists,
or whose checkpoint has none of its nets, is skipped. ``cfg`` comes from
``scripts/user_config.py``, as for ``train_main``; the model is built on
the card unless ``main`` is given another device.
"""

from __future__ import annotations

from pathlib import Path

import torch

from xpt_mde_tpu_torch.config import Config


def main(cfg: Config | None = None, dataset_factory=None,
         device: torch.device | str = "cuda") -> list:
    """:return: the artifact directories written"""
    from xpt_mde_tpu_torch.data import example_batch
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.scripts.train_main import load_user_config
    from xpt_mde_tpu_torch.serving import export_predictor
    from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager
    from xpt_mde_tpu_torch.training.trainer import default_dataset_factory, loader_keys

    cfg = cfg if cfg is not None else load_user_config()
    dataset_factory = dataset_factory or default_dataset_factory(cfg)
    written = []
    for stage in cfg.test_plan:
        out_dir = (Path(cfg.datapath_prd) / stage.ckpt_name
                   / f"serving_{stage.dataset}_{stage.weight_suffix}")
        if (out_dir / "predict.pt2").exists():
            print(f"[export_serving] exists, skip: {out_dir}")
            continue
        loader = dataset_factory(stage.dataset, "test", cfg.batch_size)
        model = ModelFactory(loader_keys(loader), stage.net_names, cfg.depth_activation,
                             stereo=cfg.stereo, high_res=cfg.high_res,
                             compute_dtype=cfg.compute_dtype, device=device).get_model()
        ckpt = CheckpointManager(Path(cfg.datapath_ckp) / stage.ckpt_name)
        if not ckpt.restore_params(model, stage.weight_suffix):
            print(f"[export_serving] no weights for {stage.ckpt_name}, skip")
            continue
        path = export_predictor(
            model, example_batch(loader), out_dir,
            description=f"{dict(stage.net_names)} on {stage.dataset} "
                        f"({stage.ckpt_name}/{stage.weight_suffix})")
        print(f"[export_serving] wrote {path}")
        written.append(path)
    return written


if __name__ == "__main__":
    main()
