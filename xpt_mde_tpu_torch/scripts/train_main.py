"""Training entry point of the PyTorch port: train by plan, then predict
the test plan.

No command-line flags: copy ``user_config_example.py`` beside this file
to ``user_config.py``, edit it, and run from the repository root

    python -m xpt_mde_tpu_torch.scripts.train_main

Without ``user_config.py`` the defaults of ``Config`` are used. Alone it
runs on one CUDA card, in one process. Under torchrun it trains data
parallel, one process per card:

    torchrun --nproc_per_node=8 -m xpt_mde_tpu_torch.scripts.train_main

each process joins the NCCL group (torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) on ``cuda:LOCAL_RANK``,
and the mesh spans every rank. ``cfg.mesh_shape`` must then be
``{"data": world size}``, so that ``cfg.batch_size`` is the global batch
(``per_replica_batch`` rows a card), or ``{"data": D, "spatial": S}`` with
D x S the world size: each sample's image rows split over S cards, the
rigid path and the flow stage (``parallel.spatial``; a joint or stereo
row raises); a shape of another size raises.
The test plan's predictions are made after training: by the main process
alone, or on a spatial mesh by every rank on its bands, the main process
writing them.
"""

import os

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


def main(cfg: Config | None = None, device_type: str = "cuda") -> None:
    """Train ``cfg`` (``user_config.py``'s by default), then predict its
    test plan, on the card (``device_type="cpu"``: on the CPU, where a
    torchrun group meets over gloo)."""
    import torch
    import torch.distributed as dist

    from xpt_mde_tpu_torch.evaluate.evaluate_main import predict_by_plan
    from xpt_mde_tpu_torch.parallel import (barrier, initialize, is_main_process,
                                            make_multihost_mesh)
    from xpt_mde_tpu_torch.parallel.multihost import local_device
    from xpt_mde_tpu_torch.training.trainer import train_by_plan

    cfg = cfg if cfg is not None else load_user_config()
    mesh = None
    if "WORLD_SIZE" in os.environ:  # started by torchrun
        device = local_device(device_type)
        initialize(device)
        mesh = make_multihost_mesh(cfg.mesh_shape, device=device)
        print(f"[train_main] rank {mesh.rank} of {mesh.world_size} on {device}, global "
              f"batch {cfg.batch_size}")
    try:
        device = mesh.device if mesh is not None else torch.device(device_type)
        train_by_plan(cfg, device=device, mesh=mesh)
        if cfg.test_plan and mesh is not None and mesh.spatial > 1:
            predict_by_plan(cfg, device=device, mesh=mesh)
        elif cfg.test_plan and is_main_process():
            predict_by_plan(cfg, device=device)
        barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
