"""The data-parallel step against the single-process step on the same
global batch.

``run_ranks`` starts W processes (``spawn``) that meet over a named backend
(gloo, or NCCL with one card per rank) through a ``file://`` rendezvous in
a work directory; each runs ``rank_steps`` or ``rank_plan`` and writes its
result there. ``single_step`` is the one-process step on the whole batch,
``compare`` the distances between them. A step case (``StepCase``) names
the nets, the loss recipe, the step's options and the global batch, and
carries the initial weights, so every rank and the single process start
from the same ones.

Both the CPU tests (``tests/test_torch_parallel.py``,
``test_torch_multihost.py``) and ``chip_smoke.py`` drive it. From the
repository root, on a machine with a card:

    python -m xpt_mde_tpu_torch.tools.ddp_check --world 2 --backend gloo
    python -m xpt_mde_tpu_torch.tools.ddp_check --world 2 --backend nccl   # 2 cards
    python -m xpt_mde_tpu_torch.tools.ddp_check --world 2 --backend gloo \
        --depth EfficientNetB5 --size 4 128 512 --spatial --float64

(EfficientNetB0 + PoseNetImproved at 64x128, batch 4, by default: the
rigid step; prints the distances and exits 1 past the stated tolerances.
``--spatial`` adds the step on the height-sharded mesh, ``--float64``
each float32 step's distance from a float64 step of the same batch on the
CPU, the exact step's stand-in.)
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch

# one data-parallel step against the single-process step, float32: the
# same sums grouped by rank (each rank's convolutions on fewer rows, which
# cuDNN may serve with other algorithms, the BatchNorm statistics combined
# from the ranks', the gradients summed over them), so two float32 results
# that each sit float32's distance from the exact step, which the
# train-mode BatchNorms' backward amplifies: at most twice that distance
# apart. On the card EfficientNetB5's float32 step sits a median 0.0136
# (worst 0.028) from a float64 step (chip_smoke.py phase 7, batch 2; on
# the CPU B0's at batch 4 ~1e-3 to 7e-3)
LOSS_RTOL = 1e-4          # the loss and each term, relative
GRAD_MEDIAN_RTOL = 0.03   # the gradient tensors' median distance, relative to norm
GRAD_MAX_RTOL = 0.1       # each gradient tensor (chip_smoke.GRAD_MAX_RTOL)
STAT_ATOL = 1e-4          # each running statistic (chip_smoke.BN_TOL's atol)
PARAM_ATOL = 2e-4         # Adam's first step moves a weight by +-lr (1e-4): a sign
# the height-sharded mesh's float32 step (two bands of every map): the
# parameters by test_torch_spatial.py's rule, the rest as above. Its
# convolutions run on half the rows, and on the card its gradients sit
# farther from the one-process step's than the data-parallel step's (B5:
# a median 0.023 against 0.007), so more noise-level gradients flip sign:
# such a weight moves by +-lr either way, 2 lr apart plus the float32
# rounding of the two moved weights; one whose gradients share a sign
# moves alike, within lr
SPATIAL_PARAM_ATOL = 2e-4 + 1e-6
SPATIAL_SAME_SIGN_ATOL = 1e-4
# the joint step's cmb and md2cmb terms keep or drop a pixel by a hard
# comparison of its static and flow errors (the mask, md2cmb's outlier
# test), so a pixel whose two errors tie within float32 rounding may fall
# on either side in the two runs and move its term by its whole share.
# tests/test_torch_joint.py finds under 1e-4 of the pixels within
# float32's gap of a tie; a term's value comes from the pixels its mask
# keeps, about half of them, so such flips move it by up to ~2e-4 of
# itself: the joint rule lets each loss term sit that much farther,
# relative, than LOSS_RTOL
TIE_RTOL = 2e-4


@dataclasses.dataclass
class StepCase:
    """One train step's inputs, the same in every process.

    :ivar batch: the global batch (numpy), uint8 or float images
    :ivar state: the initial ``state_dict`` (CPU tensors); None: the
        factory's seeded weights
    :ivar generator_seed: the step's augmentation stream (every rank seeds
        it alike); None: no augmentation
    :ivar mesh_shape: the mesh over the ranks, e.g. ``{"data": 1,
        "spatial": 2}``; None: the data mesh
    :ivar scale_weights: the loss's; None: ``SCALE_WEIGHT_T1``
    """

    nets: dict
    keys: list
    recipe: dict
    batch: dict
    stereo: bool = False
    grad_accum_steps: int = 1
    frozen_nets: tuple = ()
    regularize_net: str | None = None
    compute_dtype: str = "float32"
    lr: float = 1e-4
    state: dict | None = None
    augment_probs: dict | None = None
    generator_seed: int | None = None
    seed: int = 0
    mesh_shape: dict | None = None
    scale_weights: tuple | None = None

    @property
    def global_batch(self) -> int:
        return len(next(iter(self.batch.values())))


def _build(case: StepCase, device: torch.device, models: dict | None = None):
    """(model, loss, optimizer, augmenter) of ``case`` on ``device``. With
    ``models``, a case that carries its ``state`` takes the model an
    earlier case of the same nets and dtype built there, reloaded from
    that state and with no gradients, and leaves its own for later ones."""
    from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1
    from xpt_mde_tpu_torch.losses import loss_factory
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.training import augmentation_factory, optimizer_factory

    key = (tuple(sorted(case.nets.items())), tuple(case.keys), case.stereo,
           case.compute_dtype)
    model = None if models is None or case.state is None else models.get(key)
    if model is None:
        model = ModelFactory(case.keys, case.nets, stereo=case.stereo,
                             compute_dtype=case.compute_dtype, device=device,
                             seed=case.seed).get_model()
        if models is not None and case.state is not None:
            models[key] = model
    for p in model.parameters():
        p.grad = None
    if case.state is not None:
        model.load_state_dict(case.state)
    loss = loss_factory(case.keys, case.recipe, case.scale_weights or SCALE_WEIGHT_T1,
                        stereo=case.stereo, batch_size=case.global_batch)
    optimizer = optimizer_factory("adam_constant", case.lr, model,
                                  frozen_nets=case.frozen_nets)
    augmenter = augmentation_factory(case.augment_probs) if case.augment_probs else None
    return model, loss, optimizer, augmenter


def _generator(case: StepCase):
    if case.generator_seed is None:
        return None
    return torch.Generator().manual_seed(case.generator_seed)


def _result(model, metrics, seconds: float, **extra) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "grads": {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "seconds": seconds, **extra}


def _spy_augmenter(augmenter, draws: list):
    """Record each augmenter's drawn parameters as it draws them."""
    for aug in getattr(augmenter, "augmenters", [augmenter]):
        def draw(generator=None, _draw=aug.draw, _name=type(aug).__name__):
            value = _draw(generator)
            draws.append((_name, value))
            return value
        aug.draw = draw


def single_step(case: StepCase, device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> dict:
    """The one-process step on the whole global batch; ``dtype=
    torch.float64`` runs it in float64 (the model and the batch, its uint8
    images decoded in float64), a reference for float32's rounding."""
    from xpt_mde_tpu_torch.training import make_train_step
    from xpt_mde_tpu_torch.training.train_step import features_to_device
    from xpt_mde_tpu_torch.utils.precision import full_f32

    device = torch.device(device)
    with full_f32():
        model, loss, optimizer, augmenter = _build(case, device)
        features = features_to_device(case.batch, device)
        if dtype == torch.float64:
            model.double()
            features = {k: v.double() for k, v in features.items()}
            features.update({k: v * (2.0 / 255.0) - 1.0 for k, v in features.items()
                             if k.startswith("image5d") and case.batch[k].dtype == np.uint8})
        draws = []
        if augmenter is not None:
            _spy_augmenter(augmenter, draws)
        step = make_train_step(model, loss, optimizer, augmenter=augmenter,
                               frozen_nets=case.frozen_nets,
                               regularize_net=case.regularize_net,
                               grad_accum_steps=case.grad_accum_steps)
        t0 = time.perf_counter()
        metrics = step(features, _generator(case))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return _result(model, metrics, time.perf_counter() - t0, draws=draws)


def case_mesh(mesh, case: StepCase):
    """The mesh of ``case`` over the ranks of ``mesh``."""
    from xpt_mde_tpu_torch.parallel import make_mesh

    if case.mesh_shape is None:
        return mesh
    return make_mesh(case.mesh_shape, group=mesh.group, device=mesh.device)


def _band_stats(step) -> dict | None:
    stats = getattr(step, "band_stats", None)
    return None if stats is None else dataclasses.asdict(stats)


def rank_step(mesh, case: StepCase, steps: int = 1, models: dict | None = None) -> dict:
    """``steps`` data-parallel steps of ``case`` in this rank: the first
    one's result with its kernel launches, and with more steps the
    (seconds, gradient all-reduce ms) of each later one as ``timed``, and
    the host seconds of the whole case, the model's build included
    (``wall``). On a spatial mesh (``case.mesh_shape``) also each step's
    ``spatial.BandStats`` (``band``, ``timed_band``; the later steps time
    their collectives). ``models``: as :func:`_build` takes it."""
    from xpt_mde_tpu_torch.parallel import (local_rows, make_parallel_train_step,
                                            replicate_state, shard_batch)
    from xpt_mde_tpu_torch.tools.check_learns import kernel_launches
    from xpt_mde_tpu_torch.utils.precision import full_f32

    start = time.perf_counter()
    mesh = case_mesh(mesh, case)
    with full_f32():
        model, loss, optimizer, augmenter = _build(case, mesh.device, models)
        replicate_state(model, optimizer, mesh)
        draws = []
        if augmenter is not None:
            _spy_augmenter(augmenter, draws)
        step = make_parallel_train_step(model, loss, optimizer, mesh, augmenter=augmenter,
                                        regularize_net=case.regularize_net,
                                        frozen_nets=case.frozen_nets,
                                        grad_accum_steps=case.grad_accum_steps)
        features = shard_batch(local_rows(case.batch, mesh, case.grad_accum_steps), mesh)
        before = kernel_launches()
        t0 = time.perf_counter()
        metrics = step(features, _generator(case))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        after = kernel_launches()
        result = _result(model, metrics, time.perf_counter() - t0, draws=draws,
                         reduce_ms=step.reduce_ms(), rank=mesh.rank,
                         launches={k: after[k] - before[k] for k in after},
                         band=_band_stats(step))
        timed, timed_band = [], []
        if steps > 1 and mesh.spatial > 1:
            step = make_parallel_train_step(model, loss, optimizer, mesh, augmenter=augmenter,
                                            regularize_net=case.regularize_net,
                                            frozen_nets=case.frozen_nets,
                                            grad_accum_steps=case.grad_accum_steps,
                                            timed=True)
        for _ in range(steps - 1):
            t0 = time.perf_counter()
            step(features, _generator(case))
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            timed.append((time.perf_counter() - t0, step.reduce_ms()))
            timed_band.append(_band_stats(step))
        result["timed"] = timed
        result["timed_band"] = timed_band
        result["wall"] = time.perf_counter() - start
        return result


def rank_steps(mesh, cases: list, steps=1) -> list:
    """:func:`rank_step` of each case in turn, in one group; ``steps`` for
    every case, or a list of one count per case. A case of the nets and
    dtype of an earlier one reuses its model (:func:`_build`)."""
    counts = steps if isinstance(steps, (list, tuple)) else [steps] * len(cases)
    models = {}
    return [rank_step(mesh, case, n, models) for case, n in zip(cases, counts)]


def rank_plan(mesh, cfg, runs: int = 1) -> list:
    """``train_by_plan(cfg)`` over ``mesh``, ``runs`` times (a second run
    resumes and should find every row done). Returns, per run, how many
    times this rank wrote the config snapshot, a checkpoint or a
    history.csv row."""
    from xpt_mde_tpu_torch.training import checkpoint, logger, trainer

    counts = {}

    def spy(owner, name):
        original = getattr(owner, name)

        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return original(*args, **kwargs)
        setattr(owner, name, call)

    spy(trainer, "snapshot_config")
    for name in ("save", "save_midway"):
        spy(checkpoint.CheckpointManager, name)
    spy(logger.TrainingLogger, "save_log")
    writes = []
    for _ in range(runs):
        counts.clear()
        trainer.train_by_plan(cfg, mesh=mesh)
        writes.append(dict(counts))
    return writes


def rank_eval_predict(mesh, case: StepCase) -> dict:
    """The eval and predict steps over the mesh of ``case`` on its rows
    (and bands): the eval metrics and the predictions (whole, numpy)."""
    from xpt_mde_tpu_torch.parallel import local_rows, shard_batch
    from xpt_mde_tpu_torch.parallel.sharding import (make_parallel_eval_step,
                                                     make_parallel_predict_step)

    mesh = case_mesh(mesh, case)
    model, loss, _, _ = _build(case, mesh.device)
    features = shard_batch(local_rows(case.batch, mesh), mesh)
    metrics = make_parallel_eval_step(model, loss, mesh)(features)
    preds = make_parallel_predict_step(model, mesh)(features)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "preds": {k: [t.cpu().numpy() for t in v] if isinstance(v, list)
                      else v.cpu().numpy() for k, v in preds.items()}}


def rank_spatial_plan(mesh, cfg) -> dict:
    """``train_by_plan(cfg)`` over the mesh ``cfg.mesh_shape``, then its
    test plan's predictions on that mesh (``predict_by_plan``): this
    rank's writes, as :func:`rank_plan` counts them, and its model's
    state at the end of each row."""
    from xpt_mde_tpu_torch.evaluate.evaluate_main import predict_by_plan
    from xpt_mde_tpu_torch.parallel import make_mesh
    from xpt_mde_tpu_torch.training import trainer

    mesh = make_mesh(cfg.mesh_shape, group=mesh.group, device=mesh.device)
    runtimes = []
    init = trainer.StageRuntime.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        runtimes.append(self)
    trainer.StageRuntime.__init__ = keep
    try:
        writes = rank_plan(mesh, cfg)
    finally:
        trainer.StageRuntime.__init__ = init
    states = [{k: v.detach().cpu().clone() for k, v in rt.model.state_dict().items()}
              for rt in runtimes]
    predict_by_plan(cfg, device=mesh.device, mesh=mesh)
    return {"writes": writes, "states": states}


def rank_tasks(mesh, tasks: list) -> list:
    """Each ``(function, args)`` of ``tasks`` in turn in this rank,
    ``function(mesh, *args)``: several checks in one group."""
    return [fn(mesh, *args) for fn, args in tasks]


def _rank_main(rank: int, world: int, device_type: str, backend: str | None, workdir: str,
               fn: Callable, args: tuple, threads: int) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, save its
    result (or the traceback) as ``rank{r}.pt`` in ``workdir``."""
    torch.set_num_threads(threads)
    out = Path(workdir) / f"rank{rank}.pt"
    try:
        import torch.distributed as dist

        from xpt_mde_tpu_torch.parallel import initialize, make_mesh

        device = torch.device(device_type, 0 if backend == "gloo" else rank) \
            if device_type == "cuda" else torch.device("cpu")
        initialize(device, rank, world, init_method=f"file://{Path(workdir) / 'rendezvous'}",
                   backend=backend)
        mesh = make_mesh({"data": world}, device=device)
        result = fn(mesh, *args)
        if dist.is_initialized():  # fn may have ended the group itself
            dist.barrier()
            dist.destroy_process_group()
        torch.save({"ok": True, "result": result}, out)
    except BaseException:  # reported by run_ranks in the parent
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise


def run_ranks(fn: Callable, args: tuple, world: int, device_type: str = "cpu",
              backend: str | None = None, workdir=None, threads: int = 2,
              timeout_s: float = 600.0) -> list:
    """``fn(mesh, *args)`` in ``world`` spawned ranks over ``backend``
    (gloo on the CPU; on cards NCCL, one card per rank, or ``"gloo"``:
    every rank on card 0). ``fn`` and ``args`` must pickle. Returns the
    ranks' results in rank order; a rank that fails raises here with its
    traceback."""
    import multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, world, device_type, backend, tmp,
                                                      fn, args, threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
        results = []
        for r in range(world):
            path = Path(tmp) / f"rank{r}.pt"
            if not path.exists():
                raise RuntimeError(f"rank {r} of {world} left no result (exit code "
                                   f"{procs[r].exitcode}{', timed out' if hung else ''})")
            saved = torch.load(path, weights_only=False)
            if not saved["ok"]:
                raise RuntimeError(f"rank {r} of {world} failed:\n{saved['error']}")
            results.append(saved["result"])
        return results


def ddp_steps(cases: list, world: int, device_type: str = "cpu",
              backend: str | None = None, workdir=None, steps=1) -> list:
    """The data-parallel step of each case in ``world`` ranks (one group
    for them all): for each case, the ranks' results in rank order."""
    ranks = run_ranks(rank_steps, (cases, steps), world, device_type, backend, workdir)
    return [[results[i] for results in ranks] for i in range(len(cases))]


def _rel(a: torch.Tensor, b: torch.Tensor, floor: float = 1e-6) -> float:
    return float(torch.linalg.norm(a.double() - b.double())
                 / max(float(torch.linalg.norm(b.double())), floor))


def _same_sign(result: Mapping, single: Mapping, key: str) -> float:
    """The largest distance of parameter ``key`` where both steps' gradients
    have one sign (0 where none has)."""
    diff = (result["state"][key] - single["state"][key]).abs()
    diff = diff[torch.sign(result["grads"][key]) == torch.sign(single["grads"][key])]
    return float(diff.max()) if diff.numel() else 0.0


def compare(single: Mapping, ranks: list) -> dict:
    """The distances of the ranks' step from the single-process step:
    ``loss`` (relative, worst term of the loss family; a term below 1e-4
    of the loss relative to that), ``grad`` (worst
    relative gradient, by tensor norm), ``grad_median``, ``stat`` (worst
    running statistic, absolute), ``param`` (worst parameter, absolute),
    ``param_same_sign`` (worst parameter whose gradients share a sign),
    ``replicas`` (the largest difference between ranks' states: 0 keeps
    them in step), ``frozen`` (the largest difference of a state entry
    that has no gradient and is no running statistic: a frozen net's
    weights, the input normalization; 0 keeps them bit-equal) and
    ``draws_equal`` (every rank drew the single step's augmentation)."""
    first = ranks[0]
    losses = [k for k in single["metrics"] if k == "loss" or k.startswith("loss/")]
    # a term relative to itself, or to 1e-4 of the whole loss where it is
    # smaller (a smoothness term of ~1e-6 carries no digits beyond that)
    floor = 1e-4 * abs(single["metrics"]["loss"])
    grads = {n: _rel(first["grads"][n], g) for n, g in single["grads"].items()}
    stats = [k for k in single["state"] if k.endswith(("running_mean", "running_var"))]
    params = [k for k in single["state"] if k in single["grads"]]
    fixed = [k for k in single["state"] if k not in single["grads"] and k not in stats
             and not k.endswith("num_batches_tracked")]
    return {
        "loss": max(abs(first["metrics"][k] - single["metrics"][k])
                    / max(abs(single["metrics"][k]), floor, 1e-12) for k in losses),
        "metrics_equal_across_ranks": all(r["metrics"] == first["metrics"] for r in ranks),
        "grad": max(grads.values()) if grads else 0.0,
        "grad_median": float(np.median(list(grads.values()))) if grads else 0.0,
        "grad_keys_equal": set(first["grads"]) == set(single["grads"]),
        "stat": max((float((first["state"][k] - single["state"][k]).abs().max())
                     for k in stats), default=0.0),
        "param": max((float((first["state"][k] - single["state"][k]).abs().max())
                      for k in params), default=0.0),
        "param_same_sign": max((_same_sign(first, single, k) for k in params
                                if k in first["grads"]), default=0.0),
        "replicas": max(float((r["state"][k].double() - first["state"][k].double())
                              .abs().max()) for r in ranks[1:] for k in first["state"])
        if len(ranks) > 1 else 0.0,
        "frozen": max((float((r["state"][k].double() - single["state"][k].double())
                             .abs().max()) for r in ranks for k in fixed), default=0.0),
        "draws_equal": all(r["draws"] == single["draws"] for r in ranks)}


def within_tolerance(distances: Mapping, spatial: bool = False, joint: bool = False) -> bool:
    """The module's tolerances (LOSS_RTOL, ...) hold, the replicas are
    equal and every rank drew the single step's augmentation; with
    ``spatial`` the parameters by SPATIAL_PARAM_ATOL and
    SPATIAL_SAME_SIGN_ATOL in place of PARAM_ATOL; the entries without a
    gradient bit-equal (``frozen``); with ``joint`` (a step
    under the cmb or md2cmb terms) the loss terms within LOSS_RTOL +
    TIE_RTOL, for the mask's near-ties."""
    params = (distances["param"] <= SPATIAL_PARAM_ATOL
              and distances["param_same_sign"] <= SPATIAL_SAME_SIGN_ATOL) if spatial \
        else distances["param"] <= PARAM_ATOL
    loss_rtol = LOSS_RTOL + (TIE_RTOL if joint else 0.0)
    return (distances["loss"] <= loss_rtol and distances["grad_median"] <= GRAD_MEDIAN_RTOL
            and distances["grad"] <= GRAD_MAX_RTOL
            and distances["stat"] <= STAT_ATOL and params
            and distances["replicas"] == 0.0 and distances["frozen"] == 0.0
            and distances["grad_keys_equal"]
            and distances["metrics_equal_across_ranks"] and distances["draws_equal"])


# b0_case's pose: the seeded pose head predicts ~0, where every warped
# pixel sits on a cell border of the bilinear warp and rounding flips the
# synthesized views (chip_smoke.py's CHECK_TWIST, for the same reason)
CHECK_TWIST = [0.3, 0.05, -0.1, 0.01, 0.02, -0.015]


def b0_case(batch: int = 4, height: int = 64, width: int = 128,
            depth: str = "EfficientNetB0", **options) -> StepCase:
    """EfficientNetB0 (or the ``depth`` backbone) + PoseNetImproved, the
    rigid recipe, on a synthetic uint8 batch (seed 3), from the seeded
    weights with the pose head's bias at CHECK_TWIST."""
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.models import ModelFactory

    dataset = SyntheticDataset(batch_size=batch, height=height, width=width, num_batches=1,
                               seed=3)
    data = next(iter(dataset))
    data["image5d"] = np.round((data["image5d"] + 1.0) * 127.5).astype(np.uint8)
    nets = {"depth": depth, "camera": "PoseNetImproved"}
    model = ModelFactory(dataset.config_keys(), nets, stereo=False, device="cpu").get_model()
    with torch.no_grad():
        list(model.posenet.children())[-1].Conv_0.bias.copy_(
            torch.tensor(CHECK_TWIST * model.posenet.numsrc))
    return StepCase(nets, dataset.config_keys(), {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0},
                    data, state=model.state_dict(), **options)


# the flow stage's recipe: LOSS_FLOW without the right views' flowL2_R
FLOW_RECIPE = {"flowL2": 1.0, "flow_reg": 4e-7}


def flow_case(batch: int = 4, height: int = 64, width: int = 128, **options) -> StepCase:
    """PWC-Net alone under the flow stage's recipe, ``regularize_net=
    "flownet"``, on a synthetic uint8 batch (seed 3), from the factory's
    seeded weights."""
    from xpt_mde_tpu_torch.config import FLOW_NET
    from xpt_mde_tpu_torch.data import SyntheticDataset

    dataset = SyntheticDataset(batch_size=batch, height=height, width=width, num_batches=1,
                               seed=3)
    data = next(iter(dataset))
    data["image5d"] = np.round((data["image5d"] + 1.0) * 127.5).astype(np.uint8)
    options.setdefault("regularize_net", "flownet")
    return StepCase(dict(FLOW_NET), dataset.config_keys(), dict(FLOW_RECIPE), data, **options)


# the joint step's recipes: LOSS_RIGID_COMB without the right views'
# terms, and its md2cmb form at the same weights
JOINT_RECIPE = {"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 20.0}
MD2CMB_RECIPE = {"md2cmbL1": 5.0, "md2cmbSSIM": 0.5, "smoothe": 20.0}
# joint_case's flow: the seeded flow heads predict ~0, where every
# flow-warped pixel sits on a cell border of the bilinear warp
# (chip_smoke.py's CHECK_FLOW, for the same reason as CHECK_TWIST)
CHECK_FLOW = [0.35, -0.25]


def joint_case(batch: int = 4, height: int = 64, width: int = 128,
               depth: str = "EfficientNetB0", recipe: Mapping | None = None,
               **options) -> StepCase:
    """EfficientNetB0 (or the ``depth`` backbone) + PoseNetImproved +
    PWC-Net, the flownet frozen, under JOINT_RECIPE (or ``recipe``), on
    b0_case's batch, from the seeded weights with the pose head's bias at
    CHECK_TWIST and every flow head's at CHECK_FLOW."""
    from xpt_mde_tpu_torch.models import ModelFactory

    rigid = b0_case(batch, height, width, depth)
    nets = dict(rigid.nets, flow="PWCNet")
    model = ModelFactory(rigid.keys, nets, stereo=False, device="cpu").get_model()
    with torch.no_grad():
        list(model.posenet.children())[-1].Conv_0.bias.copy_(
            torch.tensor(CHECK_TWIST * model.posenet.numsrc))
        for name, module in model.flownet.named_children():
            if name.startswith("FlowPredictor_"):
                module.Conv_5.Conv_0.bias.copy_(torch.tensor(CHECK_FLOW))
    options.setdefault("frozen_nets", ("flownet",))
    return StepCase(nets, rigid.keys, dict(recipe or JOINT_RECIPE), rigid.batch,
                    state=model.state_dict(), **options)


def _distances(d: Mapping) -> str:
    return ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in d.items())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--depth", default="EfficientNetB0", help="the depth net's backbone")
    parser.add_argument("--size", type=int, nargs=3, default=(4, 64, 128),
                        metavar=("BATCH", "HEIGHT", "WIDTH"))
    parser.add_argument("--spatial", action="store_true",
                        help='also the step on {"data": 1, "spatial": WORLD}')
    parser.add_argument("--float64", action="store_true",
                        help="also each step's distance from a float64 one-process step "
                             "on the CPU")
    args = parser.parse_args(argv)
    case = b0_case(*args.size, depth=args.depth)
    cases = {"data": case}
    if args.spatial:
        cases["spatial"] = dataclasses.replace(case, mesh_shape={"data": 1,
                                                                 "spatial": args.world})
    single = single_step(case, args.device)
    results = dict(zip(cases, ddp_steps(list(cases.values()), args.world, args.device,
                                        args.backend)))
    ok = True
    for name, ranks in results.items():
        distances = compare(single, ranks)
        ok = ok and within_tolerance(distances, spatial=name == "spatial")
        print(f"ddp_check {name} mesh, world {args.world} {args.backend} on {args.device} "
              f"vs one process: {_distances(distances)}", flush=True)
    if args.float64:
        exact = single_step(case, "cpu", dtype=torch.float64)
        for name, result in [("one process", single)] + [
                (f"{name} mesh rank 0", ranks[0]) for name, ranks in results.items()]:
            print(f"ddp_check {name} on {args.device} vs a float64 step on the CPU: "
                  f"{_distances(compare(exact, [result]))}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
