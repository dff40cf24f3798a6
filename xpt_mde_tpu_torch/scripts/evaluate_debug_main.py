"""Deep-inspection evaluation entry point of the PyTorch port: per-frame
metric CSVs, ``trajectory.csv`` and worst-frame inspection views for every
test-plan row with a saved checkpoint, on the card.

No command-line flags; the same ``user_config.py`` as ``train_main``:

    python -m xpt_mde_tpu_torch.scripts.evaluate_debug_main
"""


def main(device: str = "cuda") -> None:
    """Debug-evaluate ``user_config.py``'s test plan on the card
    (``device="cpu"``: on the CPU)."""
    from xpt_mde_tpu_torch.evaluate.evaluate_debug import debug_by_plan
    from xpt_mde_tpu_torch.scripts.train_main import load_user_config

    debug_by_plan(load_user_config(), device=device)


if __name__ == "__main__":
    main()
