"""Training entry point of the PyTorch port: train by plan, then predict
the test plan.

No command-line flags: copy ``user_config_example.py`` beside this file
to ``user_config.py``, edit it, and run from the repository root

    python -m xpt_mde_tpu_torch.scripts.train_main

Without ``user_config.py`` the defaults of ``Config`` are used. It runs
on one CUDA card, in one process.
"""

from xpt_mde_tpu_torch.config import Config

USER_CONFIG = "xpt_mde_tpu_torch.scripts.user_config"


def load_user_config() -> Config:
    try:
        from xpt_mde_tpu_torch.scripts.user_config import cfg  # type: ignore
    except ModuleNotFoundError as exc:
        if exc.name != USER_CONFIG:
            raise
        print(f"[train_main] no {USER_CONFIG}; using the defaults "
              "(copy xpt_mde_tpu_torch/scripts/user_config_example.py)")
        return Config()
    return cfg


def main() -> None:
    from xpt_mde_tpu_torch.evaluate.evaluate_main import predict_by_plan
    from xpt_mde_tpu_torch.training.trainer import train_by_plan

    cfg = load_user_config()
    train_by_plan(cfg)
    if cfg.test_plan:
        predict_by_plan(cfg)


if __name__ == "__main__":
    main()
