"""Evaluation entry point of the PyTorch port: depth and pose metrics of
the saved predictions, per test-plan row.

No command-line flags; the same ``user_config.py`` as ``train_main``:

    python -m xpt_mde_tpu_torch.scripts.evaluate_main
"""


def main() -> None:
    from xpt_mde_tpu_torch.evaluate.evaluate_main import evaluate_by_plan
    from xpt_mde_tpu_torch.scripts.train_main import load_user_config

    evaluate_by_plan(load_user_config())


if __name__ == "__main__":
    main()
