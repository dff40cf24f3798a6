from xpt_mde_tpu_torch.data.synthetic import PlanarSceneDataset, SyntheticDataset


def example_batch(loader) -> dict:
    """One batch for shapes and logging, through the loader's side-effect
    free ``example_batch()`` where it has one (no epoch consumed, no
    prefetch thread left behind); else the first batch of an iteration."""
    if hasattr(loader, "example_batch"):
        return loader.example_batch()
    return next(iter(loader))
