"""The learning checks on one CUDA card (the port's counterpart of the JAX
package's ``benchmarks/check_plan_learns_tpu.py``).

``--check plan`` runs the miniature TRAINING_PLAN_28
(``training/mini_plan.py``) through ``train_by_plan``, walking the plan
prefix row by row (so each later call resumes from ``history.csv``), and
after each prefix evaluates the held-out world (seed 99):

- the untrained init, then after the rigid rows: AbsRel and the
  trajectory relative error must fall below half their init values;
- after the flow row: the depth and pose nets are untouched, and the
  flow EPE against the world's analytic flow is printed (a diagnostic);
- after the joint rows (at 64x128): AbsRel below half its init value;
  the flownet's weights equal the flow row's exactly (restored and
  frozen), and the depth net's weights changed.

The protocol is the JAX check's: ``miniature_plan(12, 3, 3)``,
``make_config(batch=8)``, ``synthetic_factory(train_batches=42,
val_batches=2)``. The result goes to ``RESULTS_torch.jsonl``
(``utils/results.py``) and the exit code is 1 where a criterion fails.
A broken hand-off or a non-finite metric raises in either dtype.

Usage, from the repository root on a machine with a CUDA card:

    python -m xpt_mde_tpu_torch.tools.check_learns --check plan --dtype float32
    python -m xpt_mde_tpu_torch.tools.check_learns --check plan --dtype bfloat16

(float32 ~1-2 min on an H100; the checkpoints go to a temporary directory
under the checkout's ``build/``, removed afterwards.)
"""

from __future__ import annotations

import argparse
import contextlib
import io
import math
import sys
import tempfile
import time
from pathlib import Path

import torch

# the JAX check's protocol
PLAN_PROTOCOL = {"rigid_epochs": 12, "flow_epochs": 3, "joint_epochs": 3, "batch": 8,
                 "train_batches": 42, "val_batches": 2}
VAL_SEED = 99
# a criterion holds where the metric falls below this share of its init value
CRITERION_SHARE = 0.5


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count so far, by name (K1, K1-bwd, K2,
    K3, K4, K2-bf16, K3-bf16, K4-bf16)."""
    from xpt_mde_tpu_torch.ops.kernels.correlation import kernels_for
    from xpt_mde_tpu_torch.ops.kernels.warp import K1, K1_BWD

    kernels = [K1, K1_BWD, *kernels_for(torch.float32), *kernels_for(torch.bfloat16)]
    return {kernel.name: kernel.launches for kernel in kernels}


def _history_rows(cfg) -> list[dict]:
    path = Path(cfg.datapath_ckp) / cfg.ckpt_name / "history.csv"
    lines = path.read_text().strip().splitlines()
    header = lines[0].split(",")
    return [dict(zip(header, line.split(","))) for line in lines[1:]]


def _finite(metrics: dict, where: str) -> None:
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite metrics {where}: {bad}")


def check_plan(workdir, compute_dtype: str = "float32", device="cuda", log=print,
               **protocol) -> dict:
    """Run the plan check in ``workdir`` (``protocol`` overrides
    PLAN_PROTOCOL's keys). Returns {"trajectory": {stage: metrics},
    "meets_criteria", "criteria": {name: (value, limit)}, "rows": [per
    row: label, steps, seconds, images_per_s, launches], "handoff",
    "seconds"}; raises where the hand-off breaks or a metric is not
    finite."""
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.training import mini_plan as mp
    from xpt_mde_tpu_torch.training.trainer import train_by_plan

    unknown = set(protocol) - set(PLAN_PROTOCOL)
    if unknown:
        raise TypeError(f"unknown protocol keys {sorted(unknown)}")
    p = dict(PLAN_PROTOCOL, **protocol)
    t_start = time.perf_counter()
    epochs = (p["rigid_epochs"], p["flow_epochs"], p["joint_epochs"])
    plan = mp.miniature_plan(*epochs)
    cfg = mp.make_config(workdir, plan, batch=p["batch"], compute_dtype=compute_dtype)
    factory = mp.synthetic_factory(train_batches=p["train_batches"],
                                   val_batches=p["val_batches"])

    def val_set(size):
        return SyntheticDataset(batch_size=p["batch"], height=size[0], width=size[1],
                                num_batches=p["val_batches"], varying_depth=True,
                                vary_motion=True, seed=VAL_SEED)

    val_rigid, val_joint = val_set(mp.RIGID_SIZE), val_set(mp.FLOW_SIZE)
    init = mp.evaluate_checkpoint(cfg, mp.RIGID_NETS, val_rigid, restore=False, device=device)
    epe_init = mp.evaluate_flow_epe(cfg, val_joint, restore=False, device=device)
    _finite(init, "at init")
    log(f"init           : {_rounded(init)}; flow EPE {epe_init:.4f} px (untrained PWC-Net)")
    trajectory = {"init": dict(init, flow_epe=epe_init)}

    rigid_end = epochs[0]
    flow_end, joint_end = rigid_end + epochs[1], rigid_end + epochs[1] + epochs[2]
    rows, handoff = [], {}
    for n_rows, name, size in ((1, "after_rigid", mp.RIGID_SIZE),
                               (2, "after_flow", mp.RIGID_SIZE),
                               (3, "after_joint", mp.FLOW_SIZE)):
        cfg.training_plan = plan[:n_rows]
        before = kernel_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the trainer's per-step lines
            train_by_plan(cfg, factory, device=device)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in kernel_launches().items() if v - before[k]}
        history = _history_rows(cfg)[sum(epochs[:n_rows - 1]):]
        train_s = sum(float(r["train_sec_per_epoch"]) for r in history)
        steps = len(history) * p["train_batches"]
        # the host's share: rendering one epoch of the row's world alone
        t0 = time.perf_counter()
        for _ in factory(plan[n_rows - 1].dataset, "train", p["batch"]):
            pass
        render_s = time.perf_counter() - t0
        rows.append({"row": name[len("after_"):], "epochs": len(history), "steps": steps,
                     "seconds": seconds, "train_seconds": train_s,
                     "images_per_s": steps * p["batch"] / train_s,
                     "render_share": render_s * len(history) / train_s,
                     "launches": launches,
                     "launches_per_step": {k: v / steps for k, v in launches.items()}})
        metrics = mp.evaluate_checkpoint(cfg, mp.RIGID_NETS,
                                         val_joint if size == mp.FLOW_SIZE else val_rigid,
                                         device=device)
        if n_rows >= 2:  # a diagnostic: photometric flow need not lower the EPE
            metrics["flow_epe"] = mp.evaluate_flow_epe(cfg, val_joint, device=device)
        _finite(metrics, name)
        trajectory[name] = metrics
        log(f"{name:15s}: {_rounded(metrics)}; row {rows[-1]['row']}: {steps} steps in "
            f"{seconds:.1f} s ({train_s:.1f} s training, {rows[-1]['images_per_s']:.1f} "
            f"images/s, {rows[-1]['render_share']:.2f} of it rendering the world on the "
            f"host), launches {launches}")
        if n_rows == 1:
            rigid = {net: mp.net_checkpoint_weights(cfg, net, f"ep{rigid_end:02d}")
                     for net in ("depthnet", "posenet")}
        if n_rows == 2:  # the flow row builds and saves the flownet alone
            handoff["depth_pose_untouched_by_flow_row"] = all(
                mp.same_weights(mp.net_checkpoint_weights(cfg, net, "latest"), weights)
                for net, weights in rigid.items())

    # the joint rows restored the flow row's flownet and kept it frozen,
    # and trained the depth net
    handoff["flownet_exact"] = mp.same_weights(
        mp.net_checkpoint_weights(cfg, "flownet", f"ep{flow_end:02d}"),
        mp.net_checkpoint_weights(cfg, "flownet", f"ep{joint_end:02d}"))
    handoff["depth_changed_in_joint"] = not mp.same_weights(
        rigid["depthnet"], mp.net_checkpoint_weights(cfg, "depthnet", f"ep{joint_end:02d}"))
    if not all(handoff.values()):
        raise AssertionError(f"the plan's hand-off broke: {handoff}")
    log("hand-off ok: the flownet after the joint rows equals the flow row's tensor for "
        "tensor, the depth net changed in the joint rows, the flow row left depth and pose "
        "as the rigid rows left them")

    after_rigid, after_joint = trajectory["after_rigid"], trajectory["after_joint"]
    criteria = {
        "after_rigid_abs_rel": (after_rigid["abs_rel"], CRITERION_SHARE * init["abs_rel"]),
        "after_rigid_trj_rel_err": (after_rigid["trj_rel_err"],
                                    CRITERION_SHARE * init["trj_rel_err"]),
        "after_joint_abs_rel": (after_joint["abs_rel"], CRITERION_SHARE * init["abs_rel"]),
    }
    return {"trajectory": trajectory, "criteria": criteria,
            "meets_criteria": all(v < limit for v, limit in criteria.values()),
            "handoff": handoff, "rows": rows, "protocol": p,
            "seconds": time.perf_counter() - t_start}


def _rounded(metrics: dict) -> dict:
    return {k: round(v, 4) for k, v in metrics.items()}


def result_payload(result: dict) -> dict:
    """The ledger fields of a :func:`check_plan` result: the trajectory of
    AbsRel, trajectory relative error and flow EPE, the criteria, the
    hand-off, each row's seconds and images/s, the protocol."""
    traj = result["trajectory"]
    return {"ok": bool(result["meets_criteria"]),
            **{f"{k}_abs_rel": round(v["abs_rel"], 4) for k, v in traj.items()},
            **{f"{k}_trj_rel": round(v["trj_rel_err"], 4) for k, v in traj.items()},
            **{f"{k}_flow_epe": round(v["flow_epe"], 4) for k, v in traj.items()
               if "flow_epe" in v},
            "criteria": {k: [round(v, 4), round(limit, 4)]
                         for k, (v, limit) in result["criteria"].items()},
            "handoff": result["handoff"],
            "rows": {r["row"]: {"steps": r["steps"], "seconds": round(r["seconds"], 1),
                                "images_per_s": round(r["images_per_s"], 1),
                                "render_share": round(r["render_share"], 3)}
                     for r in result["rows"]},
            "seconds": round(result["seconds"], 1), "protocol": result["protocol"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", choices=["plan"], default="plan")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_learns: no CUDA device; the checks run on the card", file=sys.stderr)
        return 1
    from xpt_mde_tpu_torch.utils.results import record

    build = Path(__file__).resolve().parents[2] / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        result = check_plan(workdir, args.dtype)
    record("plan_learns", result_payload(result), args.dtype)
    if not result["meets_criteria"]:
        print(f"check_learns: the criteria failed: {result['criteria']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
