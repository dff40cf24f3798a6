#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU: its rigid predict, eval
and train steps, its flow predict and train steps, its joint train step,
its entry point, the plan driver (train by plan over a rigid, a flow and a
joint row on synthetic shards, then predict and evaluate), the stereo
("MS") path: the stereo train, joint and flow steps and the plan on
stereo shards, all in float32 (the parity mode); then the bfloat16
compute mode, the default of ``Config()``: the bfloat16 correlation
kernels, the steps at full width, their cross-check against float32, and
the stereo plan at the default ``Config()``; then the learning chain: the
miniature plan in both dtypes, which must learn in float32; then the
shard chain: the port's own synthetic shards, and a bfloat16 rigid row
trained on them; then the model zoo: the other backbones, pose nets, loss
recipes, gradient accumulation and backbone remat, each in a bfloat16
train step at full width.

Usage, from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--earlier DIR]

``--earlier DIR`` names a checkout of an earlier commit (for example a
``git archive`` of it under ``build/``): its phases 2 and 8 (and 21,
where its ``_corr_phase`` takes a dtype) run first, in a subprocess on
the same card, and their per-step kernel times become ``earlier_ms`` in
the kernels line (else ``earlier_ms`` is null), their per-level times
stand beside this tree's in phase 21; the kernels whose sums this tree
did not reorder (the float32 K2, K3 and K4, and K2-bf16 and K4-bf16)
must give that checkout's bits on the same seeded inputs
(``unchanged_kernel_outputs``).

It builds kernels K1 and K1-bwd (``xpt_mde_tpu_torch/csrc/warp.cu``) and
K2, K3 and K4 in float32 and bfloat16 (``xpt_mde_tpu_torch/csrc/
correlation.cu`` and ``correlation_bf16.cu``) with ``nvcc``, one compiler
per library started together, and prints one line per phase:

1. the device (name, count, power limit), the kernels' register/spill
   report, and the SASS of the tensor-core kernels (``HMMA`` in K2-bf16,
   K3-bf16 and K4-bf16, from ``cuobjdump``; skipped, and said so, without
   it);
2. K1 and K1-bwd against their plain PyTorch versions at the four
   headline scales (8 x 4 sources x {128x512, 64x256, 32x128, 16x64} x 3),
   on coordinates reprojected from synthetic depth and pose plus a band of
   out-of-frame and border-exact ones, with a depth mask; K1-bwd also
   against the autograd of the plain sampler; then both at the stereo
   cross-synthesis shape (8 x 1 source, through inv(T_LR)) at each scale;
3. predict: EfficientNetB5 + PoseNetImproved, seeded random weights,
   batch 8, 128x512, on 3 synthetic batches: shapes and finiteness;
4. eval: the same batches through the eval step (L1 + SSIM + smoothness
   at the T1 scale weights): finite losses, 4 K1 and no K1-bwd launches
   per step;
5. the eval step again on the CPU with the same weights on one batch: the
   GPU and CPU losses must agree within LOSS_TOL;
6. train: the same model and loss with Adam at 1e-4 and the default
   augmentation from a seeded generator, TRAIN_STEPS steps over the
   uint8-coded batches: finite losses, weights and BN statistics moved,
   4 K1 and 4 K1-bwd launches per step;
7. one train step on the card, one on the CPU and one on the CPU in
   float64 (the float64 runs of phases 7, 11, 14, 17 and 29 in spawned
   workers, queued before the build and drained before phase 12: see
   CPU_WORKERS), from the same weights (the pose head's bias set to
   CHECK_TWIST) on the first 2 samples of batch 0, without augmentation:
   losses within LOSS_TOL, the loss's gradient at the same predictions
   within LOSS_GRAD_RTOL, the parameter gradients as close to float64 as
   the CPU's (GRAD_MEDIAN_RATIO, GRAD_MAX_RTOL), BN statistics within
   BN_TOL;
8. K2, K3 and K4 against their plain versions (K3 and K4 also against
   the plain cost volume's autograd) at the five PWC-Net levels of the
   flow stage (32 target/source pairs, [32, C, h, w] from a seeded
   generator), within CORR_RTOL of the largest plain value, and their
   times; then (``_band_corr_phase``) on two bands of each level's rows
   against the rows of cr a band reads with their row offset (the whole
   map at 128x512; md rows each side, the halo route, at 256x1024's level
   2), held to the plain versions with that offset by the same rule,
   each band launch timed beside the whole frame's;
9. flow predict: PWC-Net, seeded random weights, batch 8 x 4 sources,
   128x512, on the 3 batches: flow shapes, finiteness, 5 K2 launches
   per forward and no other;
10. flow train: FLOW_RECIPE with ``regularize_net="flownet"`` and Adam
    at 1e-4, FLOW_TRAIN_STEPS steps over the uint8-coded batches: finite
    losses, every weight moved, and per step 5 launches each of K2, K3
    and K4 and 4 each of K1 and K1-bwd;
11. one flow train step on the card, on the CPU and on the CPU in
    float64, from the same weights (every flow head's bias set to
    CHECK_FLOW) on the first FLOW_CHECK_BATCH samples of batch 0, at
    128x512: checked as in phase 7 (FLOW_LOSS_TOL);
12. timings, each tagged with the card's name and power limit, and the
    flow train step's device busy time, kernels per step and idle share
    (``tools/profile_steps.py``);
13. joint train: EfficientNetB5 + PoseNetImproved + PWCNet, JOINT_RECIPE
    at the T1 scale weights, Adam at 1e-4 with the flownet frozen,
    JOINT_TRAIN_STEPS steps over the uint8-coded batches: finite losses,
    per step JOINT_PER_STEP launches (K2 forward only, K1 for the 4
    synthesis and the 4 flow warps, K1-bwd for the synthesis warps, no K3
    or K4), the flownet's parameters bit-unchanged; images/s and peak
    memory;
14. one joint train step on the card, on the CPU and on the CPU in
    float64 (the pose head at CHECK_TWIST, the flow heads at CHECK_FLOW),
    checked as in phase 7 (JOINT_LOSS_TOL);
15. the plan: synthetic shards at 128x512 (PLAN_SNIPPETS per split,
    written by the port's ``ShardWriter`` in the schema of the port's
    ``ShardMaker("synthetic")``) in a temporary directory under
    ``build/``; ``train_by_plan`` through the native shard loader over a
    rigid, a flow and a joint row of one epoch of 2 steps at batch 8
    (first the two pretraining rows, then the whole plan): history.csv's
    3 rows, every row's "latest" and "ep{NN}" files, the joint row
    starting from the rigid row's depth and pose weights, its flownet
    bit-equal to the flow row's before and after it, and a third call
    that skips every row and launches nothing; then ``predict_by_plan``
    and ``evaluate_by_plan`` over the test split with the joint nets:
    finite Eigen depth metrics and pose errors. Every kernel must launch
    in this run; images/s per row; the logger's reconstruction panels:
    4 views (PANEL_VIEWS) in the rigid row's, none in the flow row's,
    and 6 in the joint row's (the flow and the flow-warped source too);
16. stereo train: EfficientNetB5 + PoseNetImproved on stereo snippets
    (the keys of the kitti_raw shards), STEREO_RECIPE (the published MS
    recipe) at the T1 scale weights, the default augmentation,
    STEREO_TRAIN_STEPS uint8-coded steps of STEREO_PER_STEP launches
    each (K1 and K1-bwd for the left and right temporal synthesis and
    both cross-syntheses); images/s and peak memory;
17. one stereo train step on the card, on the CPU and on the CPU in
    float64 (the pose head at CHECK_TWIST, the extrinsic at CHECK_T_LR),
    checked as in phase 7 (STEREO_LOSS_TOL);
18. stereo joint train: the three nets under LOSS_RIGID_COMB, the flownet
    frozen, STEREO_JOINT_PER_STEP launches a step, the flownet
    bit-unchanged; images/s and peak memory;
19. the stereo flow row's step: PWC-Net under LOSS_FLOW in full,
    STEREO_FLOW_PER_STEP launches a step;
20. the stereo plan: stereo shards at 128x512 in
    the kitti_raw schema (``write_stereo_shards``; STEREO_PLAN_SNIPPETS),
    ``train_by_plan`` over a flow row (LOSS_FLOW), a rigid row
    (LOSS_RIGID_T2) and a joint row (LOSS_RIGID_COMB), one epoch each,
    the joint row starting from the rows before and keeping the flownet;
    then ``predict_by_plan`` and ``evaluate_by_plan`` with the joint nets:
    finite metrics. Every float32 kernel must launch in this run; images/s
    per row and the phase's seconds;
21. the bfloat16 K2, K3 and K4 against their plain versions on the same
    bfloat16 inputs at the five PWC levels (and K3, K4 against the plain
    autograd), within one bfloat16 ulp plus BF16_CORR_ATOL of the largest
    value, and at the card tests' edge shapes (CORR_EDGE_SHAPES) on
    aligned (TMA-staged where W % 8 == 0) and offset inputs (staged by
    the kernels' threads), bit-equal; their times per level beside the
    float32 kernel's of phase 8, the earlier checkout's (``--earlier``)
    and the bfloat16 bound, and per flow step; then phase 8's band
    shapes in bfloat16, by the bfloat16 rule;
22. the bfloat16 steps at full width: rigid predict, rigid train, flow
    train, joint train and stereo train (MS), each with its launches per
    step checked (the bfloat16 correlation kernels, never the float32
    ones) and float32 outputs; images/s and peak memory beside the
    float32 steps' of phases 12, 13 and 16;
23. one bfloat16 step of the rigid, flow, joint and stereo stages on the
    card against the float32 step of this call from the same weights and
    batch (phases 7, 11, 14 and 17's, card and CPU), held to the CPU's bfloat16-vs-float32 distance at the same size
    (BF16_MEDIAN_RATIO, BF16_MAX_RATIO): loss terms, parameter gradients,
    BN statistics;
24. the stereo plan of phase 20 at the default ``Config()``, bfloat16: K1,
    K1-bwd and the bfloat16 K2, K3 and K4 must launch in its run, the
    float32 K2, K3 and K4 never; float32 npz predictions and finite
    metrics;
25. the kernels against their plain versions at the miniature plan's
    shapes (``training/mini_plan.py``): K1 and K1-bwd at 32x64, 16x32,
    8x16 and 4x8 (batch 8 x 4 sources, the plan's world), K2, K3 and K4
    in float32 and bfloat16 at the five PWC levels of 64x128 (16x32 down
    to 1x2), as in phases 2, 8 and 21;
26. the miniature plan in float32, this slice's main path
    (``tools/check_learns.py::check_plan``, the JAX check's protocol:
    12 rigid epochs of 42 steps at 32x64 with DepthNetBasic +
    PoseNetBasic, 3 flow epochs and 3 joint epochs at 64x128, batch 8):
    after the rigid rows AbsRel and the trajectory relative error below
    half their init values, after the joint rows AbsRel too, the flownet
    after the joint rows equal to the flow row's tensor for tensor, the
    depth net changed; every float32 kernel launches, no bfloat16 one;
    each row's seconds, images/s and launches per step;
27. the same plan in bfloat16 at MINI_PLAN_DEPTH's epochs (1 rigid, 1
    flow, 1 joint): the hand-off exact and the metrics finite;
    whether it meets the criteria is reported (``bf16_meets_criteria``)
    and fails nothing; K1, K1-bwd and the bfloat16 K2-K4 launch, the
    float32 K2-K4 never. Both results go to ``RESULTS_torch.jsonl``;
28. the shard chain (``data/shard_maker.py``): ``convert_to_shards`` at
    ``Config()``'s defaults (synthetic at 128x384, SHARD_DRIVES drives) builds
    ``synthetic_train``, ``synthetic_test`` and ``synthetic_val`` serially
    and then with ``shard_build_workers=2`` through the spawn pool: the
    trees byte-identical, the pool run (no serial fallback), OpenCV and
    PIL unimportable while they build (the logger's panels of the phases
    before have loaded OpenCV, and an import of either fails the build);
    each build's host seconds and examples/s; then
    ``train_by_plan`` over one rigid row (RIGID_NET, batch 8, bfloat16)
    on those shards through the native loader, ``predict_by_plan`` and
    ``evaluate_by_plan`` on ``synthetic_test``: finite metrics, K1 and
    K1-bwd launched; the row's images/s;
29. the model zoo (``_zoo_phase``): each backbone of ZOO_BACKBONES
    (ResNet50V2, MobileNetV2, VGG16, DenseNet121, Xception, NASNetMobile,
    NASNetLarge) as the depth net with PoseNetImproved in the bfloat16
    rigid train step (batch 8, 128x512, default augmentation, RECIPE):
    build and warm-up seconds, the ms a step between CUDA events around
    it, images/s, peak memory, 4 K1 and 4 K1-bwd launches a step, K1's ms
    over the step's, a finite loss; at ZOO_CHECK_SIZE on images scaled to
    [0, 255], the backbone alone in float64 and float32 on the card
    against the CPU (BACKBONE_F64_RTOL; TAP_RTOL, GRAD_MAX_RTOL for every
    gradient, BN_TOL), a float32 step's losses, loss gradient and BN
    statistics by phase 7's rules (without its float64 step) and the
    bfloat16 step by phase 23's; before them NASNet's count-excluding pool
    on a channels-last tensor against the CPU (POOL_RTOL); then one
    bfloat16 step each of PoseNetDeep, PoseNetPreTrained(MobileNetV2), the
    stereo step under LOSS_RIGID_MD2 and LOSS_RIGID_MOA_WST (16 K1, 16
    K1-bwd), the joint step under MD2CMB_RECIPE (5 K2-bf16),
    ``grad_accum_steps=2`` (8 K1, 8 K1-bwd) and NASNetLarge with
    ``remat_backbone``, whose peak memory must be below the backbone
    loop's NASNetLarge step's;
30. data parallel (``_ddp_phase``): ``tools/ddp_check.py``'s step of
    RIGID_NET (RECIPE) and of PWC-Net (FLOW_RECIPE, the flownet
    regularized) at batch 8 global, 128x512, in float32 against the
    one-process step on the card from the same weights (CHECK_TWIST,
    CHECK_FLOW), by ddp_check's tolerances, and DDP_TIMED_STEPS bfloat16
    steps of each: the ms a step beside the one-process step's and the
    gradient all-reduce's share of it, each rank's launches a step. (a)
    Under ``torchrun --standalone --nproc_per_node=<cards>`` over NCCL, one
    rank a card, those steps and then ``scripts/train_main.py`` on one
    rigid row (RIGID_NET, ``Config()``'s bfloat16) of synthetic shards and
    its predictions on rank 0: history.csv and the checkpoints written
    once, K1 and K1-bwd launched; (b) the steps over gloo with two ranks
    on card 0 (NCCL refuses two ranks on one device), and there the
    rigid, flow and joint (JOINT_NET, JOINT_RECIPE, the flownet frozen;
    held to its one-process steps only) steps in float32 and bfloat16 on
    SPATIAL_MESH (two bands of each sample's rows; ``_spatial_note``:
    float32 by ``ddp_check.within_tolerance(spatial=True)``, the joint
    step's with its near-tie allowance, bfloat16 by SPATIAL_BF16_RATIO,
    K1 and K1-bwd launched on each rank, a flow step's K2, K3 and K4 or
    their bf16 forms SPATIAL_FLOW_LAUNCHES times, a joint step's kernels
    as SPATIAL_JOINT_LAUNCHES says with its flownet bit-unchanged, the
    halo and gather bytes and the collectives' share of the timed bf16
    steps) and the band modules of ``tools/spatial_check.py`` in bfloat16
    (``_band_modules_note``, within its BF16_RTOL);
31. serving (``_serving_phase``): ``serving.export_predictor`` of
    RIGID_NET in bfloat16 on a uint8 batch of 8 at 128x512 and of PWC-Net
    in bfloat16 and float32; each artifact loaded in a fresh interpreter
    with JAX and the port's model and training code unimportable, held to
    the live ``make_predict_step`` (SERVE_RTOL), the flow artifacts'
    K2-bf16 / K2 launches counted there (5 a call), a wrong shape raising
    ValueError; the export seconds, the artifact bytes, and the
    artifact's images/s beside the live predict step's;
32. weights in, diagnostics out (``_pretrained_phase``): a pretrained
    backbone file written from a seeded EfficientNetB5 backbone
    (``convert.state_dict_to_flax``, ``utils/flax_msgpack.py``) under a
    temporary datapath, loaded into a fresh bfloat16 RIGID_NET on the
    card by ``load_pretrained_backbone`` bit for bit, an EfficientNetB0
    file refused with every weight unchanged; ``train_by_plan`` of one
    rigid row at ``Config()``'s defaults (bfloat16, pretrained_weight)
    on PRETRAINED_SNIPPETS of synthetic shards, starting from the file:
    K1 and K1-bwd launched, history.csv, the reconstruction panels and,
    where matplotlib is installed, history.png written; ``debug_by_plan``
    over the row's checkpoint: the three CSVs and the worst frames'
    views written, K1 launched; which of h5py, matplotlib and cv2 the
    machine has.

Then the script's seconds, a JSON line with each kernel's launches on its
main path's run (the float32 kernels': the float32 mini plan; the
bfloat16 ones': the bfloat16 mini plan) and on every path (the shard
chain's rigid row and the model zoo's steps among them), error (over
the headline shapes and the mini plan's), device time (K1 and
K1-bwd also at N = 1), bound, the plain version's, the nearest library
call's and the earlier checkout's times (``redesigned_in`` names the pull
request that redesigned a kernel), the ``nvidia-smi`` name/power line, and
last the result line
``{"ok": true, "device": {...}}``. It exits non-zero and prints no result
line when there is no CUDA card, when the repository's packages cannot be
imported, or when any phase fails. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BATCH, HEIGHT, WIDTH, NUM_BATCHES = 8, 128, 512, 3
SCALES = (1, 2, 4, 8)
RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
TRAIN_STEPS, LR, CHECK_BATCH = 6, 1e-4, 2
# the cross-checks' float64 references on the CPU (the float64 steps of
# phases 7, 11, 14 and 17, the zoo's backbones alone in float64 in phase
# 29) run in CPU_WORKERS spawned processes of CPU_WORKER_THREADS torch
# threads each at the lowest priority (``_CpuRuns``), queued before the
# build: they are done beside phases 1-11 and drained before phase 12's
# timings. A float64 sum's grouping moves it by ~1e-16, far below what
# the rules read from it. The float32 and bfloat16 CPU runs stay in this
# process, on its threads: their grouping moves them as far as the rules
# look (on the H100's host, with 2 threads instead of 8 the CPU's float32
# steps sat up to 1.9x further from float64, and MobileNetV2's bfloat16
# losses 0.32x as far from float32)
CPU_WORKERS, CPU_WORKER_THREADS, CPU_WORKER_NICE = 3, 2, 19
# the GPU/CPU train cross-check sets the pose head's bias to this twist
# (per source: tx, ty, tz in m, rotation in rad). At the seeded init the
# predicted pose is ~0, so the reprojected coordinates lie within float
# rounding of integer pixels, where the bilinear warp has a kink: each
# device takes another one-sided derivative, and the pose gradient sums
# that over every pixel. Away from identity the coordinates are generic.
CHECK_TWIST = [0.3, 0.05, -0.1, 0.01, 0.02, -0.015]
# each kernel and its plain version compute the same float32 products;
# they may differ only by FMA contraction: a few ulp of values in [-1, 1]
# (K1) or of |du|, |dv| <= 6 (K1-bwd: 3 channels, |g| <= 1, |D| <= 2)
K1_ATOL = 1e-5
K1_BWD_ATOL = 1e-5
# GPU vs CPU losses, (rtol, atol) per term. cuDNN on the card and the
# CPU's convolutions sum in different orders through ~130 layers; the
# losses are means of millions of terms, so rtol 1e-3
LOSS_TOL = {"loss": (1e-3, 0.0), "loss/L1": (1e-3, 0.0), "loss/SSIM": (1e-3, 0.0),
            # at random init the disparity is nearly flat, so the smoothness
            # term (~5e-7) is a mean of differences of nearly equal
            # disparities: float32 rounding of the convs moves it by a few
            # tenths of a percent of itself
            "loss/smoothe": (1e-2, 1e-9)}
# The train step's gradients. (1) The loss's gradient with respect to the
# same predictions on the card and on the CPU: float32 sums of the same
# products in other orders, so LOSS_GRAD_RTOL. (2) The networks'
# parameter gradients, against one float64 step on the CPU: float32 is
# itself ill-conditioned here (train-mode BatchNorm on 2 samples, ~40
# blocks), so the card must be as close to float64 as the CPU's float32
# step (median relative error at most GRAD_MEDIAN_RATIO times the CPU's)
# and no tensor further than GRAD_MAX_RTOL. GRAD_FLOOR: gradients with a
# smaller norm are 0 but for float noise (the projection BNs' biases,
# whose shift the next train-mode BN removes)
LOSS_GRAD_RTOL = 1e-4
GRAD_MEDIAN_RATIO = 1.5
GRAD_MAX_RTOL = 0.1
GRAD_FLOOR = 1e-6
# GPU vs CPU running statistics after one step, (rtol, atol) on the batch
# statistic that the step folds in with weight 0.01: a mean or variance of
# activations that differ like the losses (rtol 1e-3); atol 1e-4 covers
# means near 0 and the float32 rounding of 0.99 * the initial value
BN_TOL = (1e-3, 1e-4)
# the flow stage: LOSS_FLOW without the right views' flowL2_R
FLOW_RECIPE = {"flowL2": 1.0, "flow_reg": 4e-7}
FLOW_TRAIN_STEPS, FLOW_CHECK_BATCH = 6, 2
# the flow cross-check sets the bias of every flow head (each
# FlowPredictor's last conv) to this (u, v) flow in pixels. At the seeded
# init the flows are ~0, so the warps' coordinates grid - flow lie within
# rounding of integer pixels, where the bilinear warp has a kink (as for
# CHECK_TWIST above); a sub-pixel flow moves them off the integers.
CHECK_FLOW = [0.35, -0.25]
# K2, K3 and K4 against their plain versions: the same float32 products
# summed in another order over up to 196 channels (K2) or 81
# displacements (K3, K4), so within this share of the largest plain value
CORR_RTOL = 1e-5
# GPU vs CPU flow losses, (rtol, atol) per term: flowL2 is a mean of
# millions of squared errors after the float32 net (as LOSS_TOL); flow_reg
# sums the squares of the same weights in another order
FLOW_LOSS_TOL = {"loss": (1e-3, 0.0), "loss/flowL2": (1e-3, 0.0),
                 "loss/flow_reg": (1e-5, 0.0)}
# the joint stage (the bench's build_stage("joint")): the combined loss,
# the flownet frozen; per step K2 runs forward only, K1 for the 4
# synthesis and the 4 flow warps, K1-bwd for the synthesis warps alone
# (the flow warps' coordinates need no gradient), K3 and K4 never
JOINT_RECIPE = {"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 20.0}
JOINT_TRAIN_STEPS = 6
JOINT_PER_STEP = {"K1": 8, "K1-bwd": 4, "K2": 5, "K3": 0, "K4": 0}
# GPU vs CPU joint losses, as LOSS_TOL: the combined losses are means of
# millions of terms like L1 and SSIM (a pixel whose static and flow errors
# tie within the devices' rounding may count on one and not the other, a
# few parts per million of the terms)
JOINT_LOSS_TOL = {"loss": (1e-3, 0.0), "loss/cmbL1": (1e-3, 0.0),
                  "loss/cmbSSIM": (1e-3, 0.0), "loss/smoothe": (1e-2, 1e-9)}
# the joint loss's gradient at the same predictions, GPU vs CPU: a pixel
# whose static and flow errors tie within the warps' rounding (~1e-7) may
# count on one device and not the other, and its gradient then differs by
# its whole value; a few such pixels in millions move the gradient's norm
# by ~sqrt(their share), so (relative error, share of elements off by
# more than 1e-3 of the largest)
JOINT_LOSS_GRAD_RULE = (1e-2, 1e-4)
# the plan's synthetic shards (snippets per split) and its rows' epochs;
# at batch 8 each row trains 2 steps and validates 1
PLAN_SNIPPETS = {"train": 16, "val": 8, "test": 16}
# the stereo ("MS") path runs on snippets of STEREO_KEYS (the keys of the
# JAX package's kitti_raw shards) under STEREO_RECIPE, both from
# tools/profile_steps.py
STEREO_TRAIN_STEPS = 4
# launches per step. Rigid: K1 and K1-bwd for the left and the right
# temporal synthesis and the two cross-syntheses, at 4 scales each. Joint:
# those 16, and K1 for the 4 flow warps of each side; K2 for the flownet's
# 5 levels on each side, no K3 or K4 (the flownet is frozen). Flow row:
# flowL2 and flowL2_R, each 4 warps forward and back and 5 levels of K2,
# K3 and K4
STEREO_PER_STEP = {"K1": 16, "K1-bwd": 16, "K2": 0, "K3": 0, "K4": 0}
STEREO_JOINT_PER_STEP = {"K1": 24, "K1-bwd": 16, "K2": 10, "K3": 0, "K4": 0}
STEREO_FLOW_PER_STEP = {"K1": 8, "K1-bwd": 8, "K2": 10, "K3": 10, "K4": 10}
# GPU vs CPU stereo losses, (rtol, atol) per term, as LOSS_TOL: the _R
# terms and the cross-synthesis terms are means of millions of photometric
# errors like L1 and SSIM; smoothe_R is as near-flat as smoothe; stereoPose
# is the mean squared difference of the predicted stereo twists (~0.1, from
# the posenet) from T_LR's, a float32 chain as short as the pose's, rtol
# 1e-3 as the losses that follow the same ~130 layers
STEREO_LOSS_TOL = dict(LOSS_TOL, **{"loss/L1_R": (1e-3, 0.0), "loss/SSIM_R": (1e-3, 0.0),
                                    "loss/smoothe_R": (1e-2, 1e-9),
                                    "loss/stereoL1": (1e-3, 0.0),
                                    "loss/stereoSSIM": (1e-3, 0.0),
                                    "loss/stereoPose": (1e-3, 0.0)})
# the stereo cross-check's extrinsic (right -> left). The synthetic rig is
# a pure x translation, so the cross-synthesis maps each row onto itself:
# the reprojected v is an integer or a rounding away from one, and the
# warp takes a pixel whose floor and ceil coincide as invalid; which pixels
# do depends on each device's rounding. A 13 mm vertical offset, as real
# calibrations have, moves v off the integers (as CHECK_TWIST does for the
# temporal warps)
CHECK_T_LR = [[1.0, 0.0, 0.0, 0.3], [0.0, 1.0, 0.0, 0.013], [0.0, 0.0, 1.0, 0.0],
              [0.0, 0.0, 0.0, 1.0]]
# the stereo plan's shards, as PLAN_SNIPPETS
STEREO_PLAN_SNIPPETS = {"train": 16, "val": 8, "test": 16}
# phase 28: the synthetic reader's drives (8 snippets each) per split, so
# that the pool's two workers build two drives each
SHARD_DRIVES = 4
# phase 29, the model zoo: the seven backbones JAX has beside EfficientNet,
# each as the depth net with PoseNetImproved in the bfloat16 rigid step
ZOO_BACKBONES = ["ResNet50V2", "MobileNetV2", "VGG16", "DenseNet121", "Xception",
                 "NASNetMobile", "NASNetLarge"]
ZOO_TIMED_STEPS = 4
# the zoo's cross-checks run at ZOO_CHECK_SIZE (a 64x256 synthetic batch
# of CHECK_BATCH: a CPU float64 step of VGG16 or NASNetLarge at 128x512
# takes tens of seconds), on images scaled to [0, 255]: the range the
# zoo's preprocessing is made for. The pipeline's [-1, 1] images reach a
# "tf"-mode stem as -1 +- 0.008, where a float32 step's backbone
# gradients sit 5-40% from float64 on the CPU too (ROADMAP queue 3). The
# zoo's float32 steps' gradients are not held to the CPU's distance from
# float64, as phase 7 holds B5's: on the card cuDNN's float32 algorithms
# set that distance (DenseNet121's, Xception's and VGG16's medians land at
# ~3x the CPU's; tools/zoo_precision.py shows the backbones with cuDNN
# off), and NASNetLarge's deepest cells sit near GRAD_MAX_RTOL on the CPU
# too. So each backbone's
# gradients are held alone (``_backbone_cross_check``, every tensor), and
# the step by its losses, loss gradient and BN statistics
ZOO_CHECK_SIZE = (64, 256)
# the backbone alone in float64, card vs CPU: the same sums in other
# orders, float64's rounding amplified by the train-mode BatchNorms'
# cancellation as float32's is (float32's ~6e-8 becomes up to ~0.2 on
# the CPU, an amplification below 1e7; float64's 1.1e-16 then stays
# below ~1e-9), so every tensor within BACKBONE_F64_RTOL, still five
# orders below what a wrong forward or backward op gives
BACKBONE_F64_RTOL = 1e-7
# the count-excluding pool on a channels-last tensor against the CPU's,
# forward and backward: float32 sums of 4 to 9 values in another order
POOL_RTOL = 1e-5
# the backbone's float32 taps against float64, each within this share of
# its largest value: the forward alone, up to ~100 layers of float32 sums
# and train-mode BatchNorms (the CPU's own at ZOO_CHECK_SIZE: up to 6.5e-4,
# NASNetLarge)
TAP_RTOL = 1e-3
# phases 26-27: the mini plan's epochs (rigid, flow, joint) per dtype. The
# float32 run keeps the JAX check's 12, 3, 3 and gates its criteria (at 8,
# 2, 2 it ends, on the CPU, at AbsRel 0.125 after the joint rows against a
# limit of 0.2667: too little room to cut). The bfloat16 run is cut so
# that the script fits phases 30-32 in its 1200 s on a slow host: it gates
# only the hand-off and finite metrics, and reports the criteria;
# `tools/check_learns.py --check plan --dtype bfloat16` runs the protocol
MINI_PLAN_DEPTH = {"float32": {},
                   "bfloat16": {"rigid_epochs": 1, "flow_epochs": 1, "joint_epochs": 1}}
# phase 32: the rigid row trained from a pretrained file (2 steps) and
# the test split of its debug evaluation (1 batch)
PRETRAINED_SNIPPETS = {"train": 16, "test": 8}
# phases 15 and 32: the views stacked in one reconstruction panel per row
PANEL_VIEWS = {"rigid": 4, "flow": 0, "joint": 6}
# phase 30: timed bfloat16 data-parallel steps per world and backend (one:
# a second one's time went to the spatial mesh's steps)
DDP_TIMED_STEPS = 1
# phase 30: the height-sharded mesh of the gloo ranks, its timed bf16 steps
# (after a warm-up one), and its bf16 rule: the two-band bf16 step's loss
# within this many times the one-process bf16 step's own distance from
# float32 (the bands round their sums at other points, by bf16's own ulp),
# and the bf16 backward held module by module (tools/spatial_check.py's
# map modules in bf16, bands against the whole map, within its BF16_RTOL):
# the whole bf16 step's gradients sit as far from the one-process bf16
# step's (a gradients' median of ~1.4) as a zero gradient would, so no
# limit on them could fail
SPATIAL_MESH = {"data": 1, "spatial": 2}
SPATIAL_TIMED_STEPS = 1
SPATIAL_BF16_RATIO = 2.0
# phase 30: the flow steps (PWC-Net, FLOW_RECIPE) on SPATIAL_MESH launch
# the cost volume's kernels (K2, K3, K4, or their bf16 forms) this many
# times a step on each rank, as one process does: once a PWC level, level
# 6 computed whole by each rank, levels 5-2 on its band
SPATIAL_FLOW_LAUNCHES = 5
# phase 30: the joint step (JOINT_NET, JOINT_RECIPE, the flownet frozen) on
# SPATIAL_MESH launches these a step on each rank (in bf16 the cost
# volume's bf16 forms), as one process does (JOINT_PER_STEP): K1 at the
# four scales of the synthesis and of the flow warps, K1-bwd in the
# synthesis's backward, K2 once a PWC level; the frozen flownet's backward
# never runs
SPATIAL_JOINT_LAUNCHES = {"K1": 8, "K1-bwd": 4, "K2": 5, "K3": 0, "K4": 0}
# phase 31: an artifact against the live predict step, both on the card,
# each output's largest difference over its largest value: the same
# operations in float32 (1e-5); in bfloat16 a few ulps (2^-8 each) where
# the exported graph's ops are fused or ordered otherwise
SERVE_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVE_TIMED_CALLS = 5
# phase 29's joint step: the md2cmb terms at LOSS_RIGID_COMB's weights (as JOINT_RECIPE)
MD2CMB_RECIPE = {"md2cmbL1": 5.0, "md2cmbSSIM": 0.5, "smoothe": 20.0}
# the bfloat16 K2, K3 and K4 and their plain versions each read the
# operands as float32, sum in float32 and round once: within one bfloat16
# ulp of the plain value, plus this share of the largest value for a sum
# that cancels (a float32 order difference then exceeds the ulp of a
# result near 0)
BF16_CORR_ATOL = 1e-6
# the card tests' edge shapes (tests/test_torch_kernels.py): a stride that
# does not divide md, md 0, frames below 2 md + 1, C not a multiple of 8,
# n = 17, W % 4 != 0 at stride 4, several channel chunks, narrow K2 tiles,
# the vector paths
CORR_EDGE_SHAPES = [((1, 5, 5, 7), 4, 3), ((2, 8, 3, 130), 0, 1), ((1, 13, 3, 4), 4, 1),
                    ((2, 20, 6, 24), 6, 2), ((1, 12, 6, 20), 8, 1), ((2, 16, 5, 34), 8, 4),
                    ((2, 300, 4, 40), 4, 1), ((1, 300, 4, 128), 4, 1), ((2, 24, 6, 40), 8, 4),
                    # the tensor-core tiles' edges: n = 5 with TMA, n = 17 with
                    # TMA and W below one 16-pixel class tile, 4 classes of 24
                    # pixels at n = 7 (C % 16 != 0 in each), and offsets -4, -1,
                    # 2 over 2 rows: image row 0 has no in-frame displacement row
                    ((2, 20, 4, 40), 2, 1), ((1, 24, 5, 8), 8, 1), ((2, 36, 6, 96), 12, 4),
                    ((2, 20, 2, 24), 4, 3)]
# the least time one H100 SXM could take: NVIDIA's data sheet rates for
# device memory, for float32 outside the tensor cores, and for bfloat16
# operands on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# the kernels redesigned after their first port, and in which pull request
REDESIGNED = {"K1": "PR 4", "K3": "PR 4", "K2": "PR 5", "K4": "PR 5"}
# the bfloat16 kernels redesigned for the tensor cores (their CUDA kernels'
# names, for the SASS check), and their design
TENSOR_CORE_KERNELS = {"K2-bf16": "corr_fwd_bf16_kernel", "K3-bf16": "corr_bwd_cl_bf16_kernel",
                       "K4-bf16": "corr_bwd_cr_bf16_kernel"}
TENSOR_CORE_DESIGN = "mma.sync band products on bfloat16 shared memory, TMA staging"
# run in an earlier checkout: its phases 2 and 8
# (and 21 where its _corr_phase takes a dtype), then each kernel's device
# ms per train step and per level (where it has levels) as one JSON line;
# argv: the tag, this file, and where to save unchanged_kernel_outputs of
# the checkout's kernels
EARLIER_PHASES = """
import importlib.util, inspect, json, sys
import numpy as np, torch
import chip_smoke as cs
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.utils.precision import full_f32
with full_f32():
    batches = list(SyntheticDataset(batch_size=cs.BATCH, height=cs.HEIGHT, width=cs.WIDTH,
                                    num_batches=1, seed=0))
    device = torch.device("cuda", 0)
    stats = cs._warp_phase(batches, device, np.random.RandomState(0), sys.argv[1])
    stats.update(cs._corr_phase(device, sys.argv[1]))
    if "dtype" in inspect.signature(cs._corr_phase).parameters:
        bf16 = cs._corr_phase(device, sys.argv[1], torch.bfloat16)
        stats.update({name + "-bf16": s for name, s in bf16.items()})
    spec = importlib.util.spec_from_file_location("chip_smoke_now", sys.argv[2])
    now = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(now)
    torch.save(now.unchanged_kernel_outputs(device), sys.argv[3])
print("EARLIER " + json.dumps({name: {"ms": s["ms"], "levels": s.get("levels", {})}
                              for name, s in stats.items()}), flush=True)
"""


def _nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` as the host issues it: CUDA events around
    ``iters`` back-to-back eager calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so host issue time does not count."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, iters=5, warmup=1) / iters


def _bound(nbytes: float, flops: float, bf16: bool = False) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for moving ``nbytes``
    once and doing ``flops`` operations on one H100: float32 operations at
    the float32 rate, or (``bf16``) products of bfloat16 operands at the
    bfloat16 tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
    return 1000 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def unchanged_kernel_outputs(device) -> dict:
    """The outputs of the float32 K2, K3 and K4 (the correlation kernels
    whose code the tensor-core redesigns left as it was), and of K2-bf16
    and K4-bf16 (whose sums' order their tensor-core redesign set and
    later code keeps), at the five PWC levels on seeded inputs (8 pairs),
    on the CPU.
    Imports the package at call time, so an earlier checkout's kernels
    answer when its package is the one on the path."""
    import torch

    from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
    from xpt_mde_tpu_torch.ops.kernels import correlation as kc

    outputs = {}
    for level in (6, 5, 4, 3, 2):
        md, stride = level_displacement(level)
        shape = (8, ENCODER_CHANNELS[level - 1], HEIGHT >> level, WIDTH >> level)
        n2 = (2 * md // stride + 1) ** 2
        generator = torch.Generator().manual_seed(100 + level)
        cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1) for _ in range(2))
        g = torch.rand((shape[0], n2) + shape[2:], generator=generator) * 2 - 1
        cl, cr, g = (t.to(device) for t in (cl, cr, g))
        outputs[f"K2 L{level}"] = kc.K2(cl, cr, md, stride)
        outputs[f"K3 L{level}"] = kc.K3(g, cr, md, stride)
        outputs[f"K4 L{level}"] = kc.K4(g, cl, md, stride)
        cl16, cr16, g16 = (t.to(torch.bfloat16) for t in (cl, cr, g))
        outputs[f"K2-bf16 L{level}"] = kc.K2_BF16(cl16, cr16, md, stride)
        outputs[f"K4-bf16 L{level}"] = kc.K4_BF16(g16, cl16, md, stride)
    torch.cuda.synchronize()
    return {name: out.cpu() for name, out in outputs.items()}


def _earlier_kernels(checkout: str, tag: str, device) -> tuple[dict, dict]:
    """Phases 2, 8 and 21 of the checkout ``checkout`` on this card, in a
    subprocess (its package has this one's name): each kernel's device ms
    per train step, and per PWC level (keys "6" .. "2") where it has
    levels. Its timing lines are echoed with the prefix ``earlier``.
    Raises unless the unchanged kernels give its bits."""
    import torch

    env = dict(os.environ, PYTHONPATH=os.path.abspath(checkout))
    with tempfile.TemporaryDirectory(dir=_build_dir()) as tmp:
        saved = os.path.join(tmp, "unchanged.pt")
        proc = subprocess.run([sys.executable, "-c", EARLIER_PHASES, tag,
                               os.path.abspath(__file__), saved], cwd=checkout, env=env,
                              capture_output=True, text=True, timeout=900)
        result = None
        for line in proc.stdout.splitlines():
            if line.startswith("EARLIER "):
                result = json.loads(line[len("EARLIER "):])
            else:
                print(f"earlier {line}", flush=True)
        if proc.returncode != 0 or result is None:
            raise RuntimeError(f"the earlier checkout's phases failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        theirs = torch.load(saved)
    ours = unchanged_kernel_outputs(device)
    differ = [name for name in ours if not torch.equal(ours[name], theirs[name])]
    if differ or set(ours) != set(theirs):
        raise AssertionError(f"unchanged kernels differ from the earlier checkout's: {differ}")
    print(f"phase 1 unchanged kernels: the float32 K2, K3 and K4 and K2-bf16 and K4-bf16 at "
          f"the 5 levels "
          f"({len(ours)} outputs) bit-equal to the earlier checkout's", flush=True)
    return ({name: r["ms"] for name, r in result.items()},
            {name: r["levels"] for name, r in result.items() if r["levels"]})


def _sass_check(library: str) -> str:
    """``HMMA`` (tensor-core) instructions in the SASS of each kernel of
    TENSOR_CORE_KERNELS in ``library``, from ``cuobjdump --dump-sass``;
    raises where one has none. Returns a summary, or says that the check was
    skipped where the toolkit has no ``cuobjdump``."""
    import shutil
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return "skipped: no cuobjdump in the toolkit"
    proc = subprocess.run([tool, "--dump-sass", library], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {proc.stderr[-2000:]}")
    counts, current = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            current = next((k for k in TENSOR_CORE_KERNELS.values() if k in line), None)
            if current:
                counts.setdefault(current, 0)
        elif current and "HMMA" in line:
            counts[current] += 1
    missing = [k for k in TENSOR_CORE_KERNELS.values() if not counts.get(k)]
    if missing:
        raise AssertionError(f"no HMMA in the SASS of {missing}: {counts}")
    return ", ".join(f"{k} {v} HMMA" for k, v in counts.items())


def _warp_case(batch, scale, device, rng, cross=False):
    """Sources, coords and mask of one headline scale: coords reprojected
    from the batch's depth and pose, with rows 0..h/8 replaced by
    out-of-frame and border-exact (u, v) values; 10% of the mask zeroed.
    ``cross``: the stereo cross-synthesis instead, one source (the right
    target) through inv(CHECK_T_LR), N = 1: the batch's pure-x extrinsic
    would put v on the integers, where the warp zeroes the pixel."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.ops.camera import reproject_pixel_coords, scale_intrinsics
    from xpt_mde_tpu_torch.utils import se3
    from xpt_mde_tpu_torch.utils.image import resize_image

    b, _, height, width = batch["image5d"].shape[:4]
    h, w = height // scale, width // scale
    depth = resize_image(torch.from_numpy(batch["depth_gt"]).to(device), h, w, "nearest")
    intrinsic = scale_intrinsics(torch.from_numpy(batch["intrinsic"]).to(device), float(scale))
    if cross:
        sources = torch.from_numpy(batch["image5d_R"][:, -1:]).to(device)
        t_lr = torch.tensor([CHECK_T_LR] * b, dtype=torch.float32, device=device)
        pose = se3.invert_matrix(t_lr)[:, None]
    else:
        sources = torch.from_numpy(batch["image5d"][:, :-1]).to(device)
        pose = torch.from_numpy(batch["pose_gt"]).to(device)
    n = sources.shape[1]
    src = resize_image(sources.reshape(b * n, height, width, 3), h, w)
    src = src.reshape(b, n, h, w, 3).contiguous()
    coords = reproject_pixel_coords(depth, pose, intrinsic).contiguous()
    rows = max(1, h // 8)
    u_vals = np.array([-3.2, -1.0, -0.5, 0.0, 0.5, w - 1.5, w - 1.0, w - 0.25, w + 2.0])
    v_vals = np.array([-2.0, -0.5, 0.0, 1.25, h - 1.5, h - 1.0, h - 0.5, h + 3.0])
    band = (b, n, rows * w)
    coords[:, :, 0, :rows * w] = torch.from_numpy(
        rng.choice(u_vals, band).astype(np.float32)).to(device)
    coords[:, :, 1, :rows * w] = torch.from_numpy(
        rng.choice(v_vals, band).astype(np.float32)).to(device)
    keep = torch.from_numpy((rng.rand(b, h, w, 1) > 0.1).astype(np.float32)).to(device)
    mask = (depth * keep).contiguous()
    return src, coords, mask


def _nchw_grid(src, coords):
    """K1's inputs in ``F.grid_sample``'s layout: the image [B*N, C, H, W]
    and the grid [B*N, H, W, 2] normalized for align_corners=True."""
    import torch
    b, n, h, w, c = src.shape
    image = src.reshape(b * n, h, w, c).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([coords[:, :, 0] / (w - 1) * 2 - 1,
                        coords[:, :, 1] / (h - 1) * 2 - 1], dim=-1)
    return image, grid.reshape(b * n, h, w, 2).contiguous()


def _warp_work(src, coords, mask, g):
    """{kernel: (bytes, flops)} of one K1 and one K1-bwd launch. Bytes:
    each input read once, each output written once (the output and g have
    the target's pixels: a band's rows on a spatial mesh); flops per target
    pixel and channel: K1 4 products + 3 sums after 4 weight products per
    pixel, K1-bwd 2 lerps, 2 differences and 2 multiply-adds per channel."""
    n_pix, chans = coords.shape[0] * coords.shape[1] * coords.shape[3], src.shape[-1]
    io = src.numel() + coords.numel() + mask.numel()
    return {"K1": ((io + n_pix * chans) * 4, n_pix * (4 + 7 * chans)),
            "K1-bwd": ((io + g.numel() + coords.numel()) * 4, n_pix * (2 + 16 * chans))}


def _cross_warp_check(stereo_batch, device, rng, tag):
    """Phase 2, the stereo cross-synthesis shape (one source, B*1 = 8
    planes a scale): K1 and K1-bwd against their plain versions at each
    scale, and their device times. Returns (max errors, the times summed
    over the four scales: one direction of one cross-synthesis)."""
    import torch

    from xpt_mde_tpu_torch.ops.kernels.warp import K1, K1_BWD
    from xpt_mde_tpu_torch.ops.warp import bilinear_sample_plain, warp_coord_grad_plain

    errs = {"K1": 0.0, "K1-bwd": 0.0}
    times = dict.fromkeys(("K1", "K1-bwd", "K1 plain", "K1-bwd plain", "K1 bound",
                           "K1-bwd bound"), 0.0)
    generator = torch.Generator().manual_seed(3)
    lines = []
    for scale in SCALES:
        src, coords, mask = _warp_case(stereo_batch, scale, device, rng, cross=True)
        g = (torch.rand(src.shape, generator=generator) * 2 - 1).to(device)
        got, ref = K1(src, coords, mask), bilinear_sample_plain(src, coords, mask)
        d_got, d_ref = K1_BWD(src, coords, mask, g), warp_coord_grad_plain(src, coords, mask, g)
        torch.cuda.synchronize()
        err, err_bwd = float((got - ref).abs().max()), float((d_got - d_ref).abs().max())
        invalid = float((ref == 0).all(dim=-1).float().mean())
        if not (err <= K1_ATOL and err_bwd <= K1_BWD_ATOL):
            raise AssertionError(f"K1 / K1-bwd at N = 1 differ from plain by {err} / {err_bwd} "
                                 f"at 1/{scale}")
        errs["K1"], errs["K1-bwd"] = max(errs["K1"], err), max(errs["K1-bwd"], err_bwd)
        run = {"K1": lambda: K1(src, coords, mask),
               "K1 plain": lambda: bilinear_sample_plain(src, coords, mask),
               "K1-bwd": lambda: K1_BWD(src, coords, mask, g),
               "K1-bwd plain": lambda: warp_coord_grad_plain(src, coords, mask, g)}
        now = {name: _graph_ms(fn) for name, fn in run.items()}
        now.update({f"{name} bound": _bound(*work)[0]
                    for name, work in _warp_work(src, coords, mask, g).items()})
        for name, value in now.items():
            times[name] += value
        lines.append(f"1/{scale} {tuple(src.shape)} K1 {now['K1']:.4f} ms (plain "
                     f"{now['K1 plain']:.4f}, bound {now['K1 bound']:.4f}), K1-bwd "
                     f"{now['K1-bwd']:.4f} ms (plain {now['K1-bwd plain']:.4f}, bound "
                     f"{now['K1-bwd bound']:.4f}), err {err:.3g} / {err_bwd:.3g}, invalid "
                     f"{invalid:.3f}")
    print(f"phase 2 cross-synthesis (N = 1) kernels vs plain, device (graph replay): "
          f"{'; '.join(lines)} {tag}", flush=True)
    return errs, times


def _warp_phase(batches, device, rng, tag, phase_no=2):
    """Phase 2 (or ``phase_no``): K1 and K1-bwd against their plain
    versions at each scale of the batches' frames (the headline 128x512
    in phase 2), and their times beside the plain versions', the nearest
    library calls' and the bounds. Returns per-kernel sums over the four
    scales (one train step's warps)."""
    import torch
    import torch.nn.functional as F

    from xpt_mde_tpu_torch.ops.kernels.warp import K1, K1_BWD
    from xpt_mde_tpu_torch.ops.warp import bilinear_sample_plain, warp_coord_grad_plain

    keys = ("err", "ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops")
    stats = {"K1": dict.fromkeys(keys, 0.0), "K1-bwd": dict.fromkeys(keys, 0.0)}
    notes = []
    generator = torch.Generator().manual_seed(1)
    for scale in SCALES:
        src, coords, mask = _warp_case(batches[0], scale, device, rng)
        g = (torch.rand(src.shape, generator=generator) * 2 - 1).to(device)
        cases = [(mask, "mask")] + ([(None, "no mask")] if scale == 1 else [])
        for m, label in cases:
            got = K1(src, coords, m)
            ref = bilinear_sample_plain(src, coords, m)
            d_got = K1_BWD(src, coords, m, g)
            d_ref = warp_coord_grad_plain(src, coords, m, g)
            leaf = coords.clone().requires_grad_(True)
            bilinear_sample_plain(src, leaf, m).backward(g)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            err_bwd = max(float((d_got - d_ref).abs().max()),
                          float((d_got - leaf.grad).abs().max()))
            invalid = float((ref == 0).all(dim=-1).float().mean())
            if not err <= K1_ATOL:
                raise AssertionError(f"K1 differs from plain by {err} at 1/{scale} ({label})")
            if not err_bwd <= K1_BWD_ATOL:
                raise AssertionError(f"K1-bwd differs from plain by {err_bwd} at "
                                     f"1/{scale} ({label})")
            stats["K1"]["err"] = max(stats["K1"]["err"], err)
            stats["K1-bwd"]["err"] = max(stats["K1-bwd"]["err"], err_bwd)
            notes.append(f"1/{scale} {label} err {err:.3g} / {err_bwd:.3g} "
                         f"invalid {invalid:.3f}")

        work = _warp_work(src, coords, mask, g)
        image_nchw, grid = _nchw_grid(src, coords)
        g_nchw = g.reshape(image_nchw.shape[0], *g.shape[2:]).permute(0, 3, 1, 2).contiguous()
        runs = {"K1": (lambda: K1(src, coords, mask),
                       lambda: bilinear_sample_plain(src, coords, mask),
                       lambda: F.grid_sample(image_nchw, grid, mode="bilinear",
                                             padding_mode="zeros", align_corners=True)),
                "K1-bwd": (lambda: K1_BWD(src, coords, mask, g),
                           lambda: warp_coord_grad_plain(src, coords, mask, g),
                           # grid_sample's backward, the grid's gradient only
                           lambda: torch.ops.aten.grid_sampler_2d_backward(
                               g_nchw, image_nchw, grid, 0, 0, True, [False, True]))}
        library_names = {"K1": "grid_sample", "K1-bwd": "grid_sampler_2d_backward"}
        for name, (kernel, plain, library) in runs.items():
            t_k, t_p, t_l = _graph_ms(kernel), _graph_ms(plain), _graph_ms(library)
            e_k, e_p = _event_ms(kernel), _event_ms(plain)
            bound_ms, _ = _bound(*work[name])
            for key, value in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                               ("bound_ms", bound_ms), ("bytes", work[name][0]),
                               ("flops", work[name][1])):
                stats[name][key] += value
            print(f"timing {name} 1/{scale} {tuple(src.shape)}: device (graph replay) "
                  f"{name} {t_k:.4f} ms, plain {t_p:.4f} ms, {library_names[name]} "
                  f"{t_l:.4f} ms, bound {bound_ms:.4f} ms ({work[name][0] / 1e6:.1f} MB); "
                  f"eager per call "
                  f"{name} {e_k:.4f} ms, plain {e_p:.4f} ms {tag}", flush=True)
    print(f"phase {phase_no} kernels vs plain: K1 max abs err {stats['K1']['err']:.3g} <= "
          f"{K1_ATOL}, "
          f"K1-bwd {stats['K1-bwd']['err']:.3g} <= {K1_BWD_ATOL} (vs the plain backward and "
          f"the plain sampler's autograd; {'; '.join(notes)})", flush=True)
    return stats


def _band_work(src, coords, mask, g):
    """``_warp_work`` of a band launch, the source counted by the rows its
    valid pixels' neighbours span (a band of the targets reads a band of
    the source)."""
    import torch

    work = _warp_work(src, coords, mask, g)
    height = src.shape[2]
    v = coords[:, :, 1]
    valid = (v >= 0) & (v <= height - 1) & (mask.reshape(mask.shape[0], 1, -1) != 0)
    if not bool(valid.any()):
        return work
    lo, hi = int(torch.floor(v[valid].min())), min(int(torch.floor(v[valid].max())) + 1,
                                                    height - 1)
    unread = src.numel() * (1 - (hi - lo + 1) / height) * 4
    return {name: (nbytes - unread, flops) for name, (nbytes, flops) in work.items()}


def _band_warp_phase(batches, device, rng, tag) -> str:
    """Phase 2, the spatial mesh's shapes: K1 and K1-bwd on a band of half
    the target rows (offsets 0 and h/2) of the whole source, at the four
    rigid scales of the headline 128x512 frame and of a 256x1024 (high_res)
    one, against their plain versions (K1_ATOL, K1_BWD_ATOL), each band
    launch timed by graph replay beside its bound. Returns a summary."""
    import torch

    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.ops.kernels.warp import K1, K1_BWD
    from xpt_mde_tpu_torch.ops.warp import bilinear_sample_plain, warp_coord_grad_plain

    high = next(iter(SyntheticDataset(batch_size=BATCH, height=2 * HEIGHT, width=2 * WIDTH,
                                      num_batches=1, seed=2)))
    worst = {"K1": 0.0, "K1-bwd": 0.0}
    generator = torch.Generator().manual_seed(2)
    for frame, batch in (("128x512", batches[0]), ("256x1024", high)):
        for scale in SCALES:
            src, coords, mask = _warp_case(batch, scale, device, rng)
            b, n, h, w, c = src.shape
            for first in (0, h // 2):
                rows = h // 2
                band_coords = coords.reshape(b, n, 2, h, w)[:, :, :, first: first + rows]
                band_coords = band_coords.reshape(b, n, 2, rows * w).contiguous()
                band_mask = mask[:, first: first + rows].contiguous()
                g = (torch.rand((b, n, rows, w, c), generator=generator) * 2 - 1).to(device)
                got, ref = K1(src, band_coords, band_mask), \
                    bilinear_sample_plain(src, band_coords, band_mask)
                d_got = K1_BWD(src, band_coords, band_mask, g)
                d_ref = warp_coord_grad_plain(src, band_coords, band_mask, g)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                err_bwd = float((d_got - d_ref).abs().max())
                if tuple(got.shape) != (b, n, rows, w, c) or not (err <= K1_ATOL
                                                                  and err_bwd <= K1_BWD_ATOL):
                    raise AssertionError(f"band K1 / K1-bwd differ from plain by {err} / "
                                         f"{err_bwd} at {frame} 1/{scale} rows {first}+{rows}")
                worst["K1"], worst["K1-bwd"] = max(worst["K1"], err), \
                    max(worst["K1-bwd"], err_bwd)
                work = _band_work(src, band_coords, band_mask, g)
                for name, fn in (("K1", lambda: K1(src, band_coords, band_mask)),
                                 ("K1-bwd", lambda: K1_BWD(src, band_coords, band_mask, g))):
                    bound_ms, _ = _bound(*work[name])
                    print(f"timing band {name} {frame} 1/{scale} source {tuple(src.shape)} "
                          f"target rows {first}..{first + rows - 1}: device (graph replay) "
                          f"{_graph_ms(fn):.4f} ms, bound {bound_ms:.4f} ms "
                          f"({work[name][0] / 1e6:.1f} MB) {tag}", flush=True)
    return (f"phase 2 band kernels vs plain (half the target rows at offsets 0 and h/2, "
            f"the rigid scales of 128x512 and 256x1024): K1 max abs err {worst['K1']:.3g} <= "
            f"{K1_ATOL}, K1-bwd {worst['K1-bwd']:.3g} <= {K1_BWD_ATOL}")


def _check_losses(gpu, cpu, label, tol=LOSS_TOL):
    """GPU vs CPU losses within ``tol``; returns the relative differences."""
    losses = {k: float(v) for k, v in gpu.items() if k.startswith("loss")}
    if set(losses) != set(tol):
        raise AssertionError(f"{label} losses {sorted(losses)}, want {sorted(tol)}")
    rel = {}
    for key, value in losses.items():
        cpu_value = float(cpu[key])
        diff = abs(value - cpu_value)
        rel[key] = float(f"{diff / max(abs(cpu_value), 1e-30):.3g}")
        rtol, atol = tol[key]
        if not diff <= rtol * abs(cpu_value) + atol:
            raise AssertionError(f"{label} {key}: GPU {value} vs CPU {cpu_value}")
    return losses, rel


def _loss_grad_diff(loss, preds, feats, device, pred_keys, fixed_keys=()):
    """GPU vs CPU gradient of the loss with respect to the same predictions
    (``pred_keys``: the depths and twists, or the flows; ``fixed_keys``:
    predictions the loss reads but does not differentiate, the frozen
    flownet's flows): (relative error of the whole gradient, number of
    elements, number off by more than 1e-3 of the largest |gradient|). It
    separates the loss and warp from the networks' backward."""
    import torch

    from xpt_mde_tpu_torch.utils.image import safe_reciprocal_ms

    grads = []
    for dev in (device, torch.device("cpu")):
        leaves = []
        inputs = {key: [t.detach().to(dev) for t in preds[key]] for key in fixed_keys}
        for key in pred_keys:
            tensors = preds[key] if isinstance(preds[key], list) else [preds[key]]
            tensors = [t.detach().to(dev).requires_grad_(True) for t in tensors]
            leaves += tensors
            inputs[key] = tensors if isinstance(preds[key], list) else tensors[0]
        for sfx in ("", "_R"):
            if "depth_ms" + sfx in inputs:
                inputs["disp_ms" + sfx] = safe_reciprocal_ms(inputs["depth_ms" + sfx])
        total, _ = loss(inputs, {k: v.to(dev) for k, v in feats.items()})
        grads.append(torch.cat([g.reshape(-1).double().cpu()
                                for g in torch.autograd.grad(total, leaves)]))
    diff = torch.abs(grads[0] - grads[1])
    off = int((diff > 1e-3 * float(grads[1].abs().max())).sum())
    return float(torch.linalg.norm(diff) / torch.linalg.norm(grads[1])), diff.numel(), off


def _rel_errors(grads, ref):
    """Per-tensor relative error ||g - ref|| / ||ref|| over the tensors
    whose reference gradient exceeds the noise floor GRAD_FLOOR."""
    import torch
    return {n: float(torch.linalg.norm(grads[n] - r) / torch.linalg.norm(r))
            for n, r in ref.items() if float(torch.linalg.norm(r)) > GRAD_FLOOR}


def _set_pose_twist(model, device):
    """The pose head (the posenet's last conv) predicts CHECK_TWIST."""
    import torch
    with torch.no_grad():
        list(model.posenet.children())[-1].Conv_0.bias.copy_(
            torch.tensor(CHECK_TWIST * model.posenet.numsrc, device=device))


def _set_flow_heads(model, device):
    """Every flow head (each FlowPredictor's last conv) predicts CHECK_FLOW."""
    import torch
    with torch.no_grad():
        for name, module in model.flownet.named_children():
            if name.startswith("FlowPredictor_"):
                module.Conv_5.Conv_0.bias.copy_(torch.tensor(CHECK_FLOW, device=device))


def _set_pose_and_flow_heads(model, device):
    """The joint nets: the pose head at CHECK_TWIST, the flow heads at CHECK_FLOW."""
    _set_pose_twist(model, device)
    _set_flow_heads(model, device)


@dataclasses.dataclass
class _Check:
    """One cross-checked train step: its nets and keys, its batch (numpy,
    so that it pickles by value into the CPU workers), its loss, the
    function that sets the heads' biases (``_set_pose_twist``, ...) and
    the step's options. ``label`` names its CPU runs in ``_CPU_RUNS``."""

    label: str
    nets: dict
    keys: list
    feats: dict
    loss: object
    prepare: object
    step_kwargs: dict = dataclasses.field(default_factory=dict)

    def tensors(self) -> dict:
        import torch
        return {k: torch.from_numpy(v) for k, v in self.feats.items()}


def _to_numpy(value):
    """``value`` with every tensor a numpy array, so that it pickles by
    value and not through shared memory."""
    import torch
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_numpy(v) for v in value)
    return value


def _to_torch(value):
    """The inverse of ``_to_numpy``."""
    import numpy as np
    import torch
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value)
    if isinstance(value, dict):
        return {k: _to_torch(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_torch(v) for v in value)
    return value


def _digest(state: dict) -> str:
    """The digest of a state dict's keys and bits: two processes that
    seeded the same weights give the same one."""
    import torch
    digest = hashlib.sha256()
    for key, value in state.items():
        digest.update(key.encode())
        digest.update(value.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                      .numpy().tobytes())
    return digest.hexdigest()


def _cpu_worker_init(threads: int) -> None:
    os.nice(CPU_WORKER_NICE)
    import torch
    torch.set_num_threads(threads)


def _cpu_job(tasks: list) -> dict:
    """Run in a CPU worker: {key: fn(*args)} over ``tasks`` [(key, fn,
    args)], in order and in full float32, the tensors as numpy arrays."""
    from xpt_mde_tpu_torch.utils.precision import full_f32

    with full_f32():
        return {key: _to_numpy(fn(*args)) for key, fn, args in tasks}


class _CpuRuns:
    """The cross-checks' float64 CPU runs (``_cpu_step``, ``_cpu_backbone``)
    in spawned worker processes: ``submit`` queues a job of one or more
    runs, each under its key; ``result`` returns a run's result, waiting
    for it, or runs it here where it was not queued (the float32 and
    bfloat16 runs, and a probe that calls one phase without the workers);
    ``drain`` waits for every queued job, ``stop`` ends the workers."""

    def __init__(self):
        self.pool, self.pending, self.done = None, {}, {}

    def start(self, workers: int = CPU_WORKERS, threads: int = CPU_WORKER_THREADS) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.pool = ctx.Pool(workers, initializer=_cpu_worker_init, initargs=(threads,))

    def submit(self, tasks: list) -> None:
        """Queue ``tasks`` [(key, fn, args)] as one job (one worker, in
        order: runs of one model share its seeded init there)."""
        job = self.pool.apply_async(_cpu_job, (tasks,))
        for key, _, _ in tasks:
            self.pending[key] = job

    def result(self, key, fn, *args):
        if key not in self.pending:
            return fn(*args)
        job = self.pending.pop(key)
        if job not in self.done:
            self.done[job] = job.get()
        results = self.done[job]
        value = _to_torch(results.pop(key))
        if not results:
            del self.done[job]
        return value

    def drain(self) -> float:
        """Wait for every queued job; returns the seconds waited."""
        t0 = time.perf_counter()
        for job in set(self.pending.values()):
            job.wait()
        return time.perf_counter() - t0

    def stop(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


_CPU_RUNS = _CpuRuns()


# a CPU step of a cross-check: (compute dtype, model and batch dtype,
# with the initial weights' predictions)
CPU_STEP_RUNS = {"float32": ("float32", "float32", True),
                 "float64": ("float32", "float64", False),
                 "bfloat16": ("bfloat16", "float32", False)}


def _cpu_step(check: _Check, run: str) -> dict:
    """One train step of ``check`` on the CPU from the seeded weights (the
    heads set by ``check.prepare``), without augmentation, as
    CPU_STEP_RUNS[run] says: {"metrics", "grads", "stats" (the running
    statistics after it), "float32_params", "digest" (of the initial
    weights), "preds" (the initial weights' train-mode predictions, for the
    float32 run)}."""
    import torch

    from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory

    compute_dtype, dtype, with_preds = CPU_STEP_RUNS[run]
    dtype = getattr(torch, dtype)
    cpu = torch.device("cpu")
    model = _seeded_model(check.keys, check.nets, cpu, compute_dtype)
    check.prepare(model, cpu)
    digest = _digest(model.state_dict())
    model.to(dtype)
    initial = copy.deepcopy(model.state_dict())
    step = make_train_step(model, check.loss, optimizer_factory("adam_constant", LR, model),
                           **check.step_kwargs)
    metrics = step({k: v.to(dtype) for k, v in check.tensors().items()})
    out = {"metrics": dict(metrics),
           "grads": {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
           "stats": {k: v for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))},
           "float32_params": all(p.dtype == torch.float32 for p in model.parameters()),
           "digest": digest}
    if with_preds:
        model.load_state_dict(initial)
        with torch.no_grad():
            out["preds"] = model.train()(check.tensors())
    return out


def _cpu_run(check: _Check, run: str) -> dict:
    """``check``'s CPU step ``run`` (``_cpu_step``): a worker's where it
    was queued (``_CPU_RUNS``), else run here."""
    return _CPU_RUNS.result((check.label, run), _cpu_step, check, run)


def _zoo_image(check: _Check):
    """The target frames of ``check``'s batch as the depth net hands them
    to its backbone: [B, 3, H, W], a permuted view of the NHWC frames."""
    return check.tensors()["image5d"][:, -1].permute(0, 3, 1, 2)


def _cpu_backbone(check: _Check, dtype: str) -> dict:
    """``tools/zoo_precision.backbone_run`` of ``check``'s depth backbone
    on the CPU in ``dtype`` (its tensors kept in that dtype, which holds
    them exactly) and the digest of its weights."""
    import torch

    from xpt_mde_tpu_torch.tools.zoo_precision import backbone_run

    dtype = getattr(torch, dtype)
    backbone = _seeded_model(check.keys, check.nets, torch.device("cpu")).depthnet.backbone
    return {"run": _cast(backbone_run(backbone, _zoo_image(check), torch.device("cpu"), dtype),
                         dtype),
            "digest": _digest(backbone.state_dict())}


def _cast(run, dtype):
    """``run``'s tensors (in dicts, lists and tuples) in ``dtype``."""
    if isinstance(run, dict):
        return {k: _cast(v, dtype) for k, v in run.items()}
    if isinstance(run, (list, tuple)):
        return type(run)(_cast(v, dtype) for v in run)
    return run.to(dtype)


def _check_digest(label, cpu_digest, state):
    if cpu_digest != _digest(state):
        raise AssertionError(f"{label}: the CPU worker seeded other weights than this process")


def _prepared_state(check, compute_dtype: str) -> dict:
    """The state dict of ``check``'s seeded model with its heads set."""
    import torch
    model = _seeded_model(check.keys, check.nets, torch.device("cpu"), compute_dtype)
    check.prepare(model, torch.device("cpu"))
    return model.state_dict()


def _train_cross_check(phase_no, check, device, pred_keys, loss_tol, fixed_keys=(),
                       loss_grad_rule=(LOSS_GRAD_RTOL, 1.0)):
    """Phases 7, 11, 14 and 17: ``_step_cross_check``, and the parameter
    gradients as close to float64 as the CPU's (median relative error at
    most GRAD_MEDIAN_RATIO times the CPU's), none further than
    GRAD_MAX_RTOL. Returns the float32 runs (``_bf16_cross_check``'s
    ``f32_runs``)."""
    median, worst, f32_runs = _step_cross_check(phase_no, check, device, pred_keys, loss_tol,
                                                fixed_keys, loss_grad_rule)
    if not median["gpu"] <= GRAD_MEDIAN_RATIO * median["cpu"]:
        raise AssertionError(f"GPU gradients further from float64 than the CPU's: "
                             f"{median['gpu']:.3g} vs {median['cpu']:.3g}")
    if not worst[0][1] <= GRAD_MAX_RTOL:
        raise AssertionError(f"gradient of {worst[0][0]}: relative error {worst[0][1]:.3g} "
                             f"> {GRAD_MAX_RTOL}")
    return f32_runs


@functools.lru_cache(maxsize=2)
def _seeded_cpu_model(keys: tuple, nets: tuple, compute_dtype: str):
    from xpt_mde_tpu_torch.models import ModelFactory
    return ModelFactory(list(keys), dict(nets), stereo=False, compute_dtype=compute_dtype,
                        device="cpu", seed=0).get_model()


def _seeded_model(keys, nets, device, compute_dtype: str = "float32"):
    """``ModelFactory(keys, nets, stereo=False, compute_dtype=compute_dtype,
    device=device, seed=0).get_model()``, the same weights: the seeded
    init is made once on the CPU and copied, since the cross-checks build
    each model several times and a zoo backbone's init takes seconds
    (NASNetLarge's ~7 s)."""
    return copy.deepcopy(_seeded_cpu_model(tuple(keys), tuple(sorted(nets.items())),
                                           compute_dtype)).to(device)


def _step_cross_check(phase_no, check, device, pred_keys, loss_tol, fixed_keys=(),
                      loss_grad_rule=(LOSS_GRAD_RTOL, 1.0), float64=True):
    """Phases 7, 11, 14, 17 and 29: one train step of ``check`` from the
    same seeded weights (``check.prepare`` sets the heads' biases), no
    augmentation, on the card, on the CPU, and (``float64``) on the CPU in
    float64 as the reference, the CPU steps from ``_CPU_RUNS``: the losses
    within ``loss_tol``, the loss's gradient at the same predictions within
    ``loss_grad_rule`` (relative error, share of elements off by more than
    1e-3 of the largest), the BatchNorm statistics within BN_TOL. Prints
    the parameter gradients' distances from float64 (frozen nets' None not
    compared) and returns ({device: median relative error}, the card's
    three worst (tensor, error); both None without ``float64``; the
    float32 runs as ``_bf16_cross_check`` takes them)."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory

    model = _seeded_model(check.keys, check.nets, device)
    check.prepare(model, device)
    initial = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, check.loss, optimizer_factory("adam_constant", LR, model),
                           **check.step_kwargs)
    metrics = step({k: v.to(device) for k, v in check.tensors().items()})
    results = {"gpu": (metrics,
                       {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()
                        if p.grad is not None},
                       {k: v.detach().cpu().double() for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))})}
    cpu_runs = {"cpu": _cpu_run(check, "float32")}
    if float64:
        cpu_runs["cpu f64"] = _cpu_run(check, "float64")
    for dev_label, run in cpu_runs.items():
        _check_digest(f"{check.label} {dev_label}", run["digest"], initial)
        results[dev_label] = (run["metrics"], _cast(run["grads"], torch.float64),
                               _cast(run["stats"], torch.float64))
    losses, rel = _check_losses(results["gpu"][0], results["cpu"][0], check.label, loss_tol)

    # the gradient of the loss alone, at the CPU model's train-mode predictions
    loss_rel, n_elems, n_off = _loss_grad_diff(check.loss, cpu_runs["cpu"]["preds"],
                                               check.tensors(), device, pred_keys, fixed_keys)

    median = worst = None
    if float64:
        ref = results["cpu f64"][1]
        errors = {dev_label: _rel_errors(results[dev_label][1], ref)
                  for dev_label in ("gpu", "cpu")}
        median = {dev_label: float(np.median(list(e.values())))
                  for dev_label, e in errors.items()}
        worst = sorted(errors["gpu"].items(), key=lambda item: item[1], reverse=True)[:3]
        grad_note = (f"parameter gradients against the CPU's float64 step "
                     f"({len(errors['gpu'])} tensors above {GRAD_FLOOR}): median relative "
                     f"error GPU f32 {median['gpu']:.3g}, CPU f32 {median['cpu']:.3g}, GPU "
                     f"worst {', '.join(f'{n} {e:.3g}' for n, e in worst)}, CPU worst "
                     f"{max(errors['cpu'].values()):.3g}")
    else:
        grad_note = "no float64 step (the backbone alone holds the gradients in float64)"
    worst_stat = 0.0
    for key, value in results["cpu"][2].items():
        # the batch statistic folded in: (new - (1 - m) * initial) / m
        momentum = model.get_submodule(key.rsplit(".", 1)[0]).momentum
        folded = [(results[dev_label][2][key] - (1.0 - momentum) * initial[key].double())
                  / momentum for dev_label in ("gpu", "cpu")]
        excess = torch.abs(folded[0] - folded[1]) - BN_TOL[0] * torch.abs(folded[1])
        worst_stat = max(worst_stat, float(excess.max()))
    bn_note = (f"BN batch statistics GPU vs CPU: worst excess over rtol {BN_TOL[0]} "
               f"{worst_stat:.3g}" if results["cpu"][2] else "no BatchNorm")
    batch = check.feats["image5d"].shape[0]
    print(f"phase {phase_no} {check.label} cross-check: one step at batch {batch}, GPU vs CPU "
          f"losses rel diff {json.dumps(rel)} (GPU {json.dumps(losses)}); loss gradient at "
          f"the same predictions: rel error {loss_rel:.3g} <= {loss_grad_rule[0]} ({n_off} of "
          f"{n_elems} elements off by > 1e-3 of the largest); {grad_note}; {bn_note}",
          flush=True)
    if not (loss_rel <= loss_grad_rule[0] and n_off <= loss_grad_rule[1] * n_elems):
        raise AssertionError(f"loss gradient GPU vs CPU: relative error {loss_rel:.3g}, "
                             f"{n_off} of {n_elems} elements off")
    if not worst_stat <= BN_TOL[1]:
        raise AssertionError(f"BN batch statistics differ by {worst_stat:.3g} beyond rtol")
    f32_runs = {(where, "float32"): ({k: float(v) for k, v in results[dev_label][0].items()
                                      if k.startswith("loss")}, results[dev_label][1],
                                     results[dev_label][2])
                for where, dev_label in (("card", "gpu"), ("cpu", "cpu"))}
    return median, worst, f32_runs


def _backbone_cross_check(check, device):
    """Phase 29 for one backbone: the depth net's backbone of ``check``
    alone, seeded as the step's (``tools/zoo_precision.py``), train mode,
    on its target frames as the depth net hands them over ([B, 3, H, W]
    in [0, 255]), the objective sum_i mean(tap_i * r_i) with seeded normal
    r_i, forward and backward on the card and on the CPU in float64 and in
    float32 (the CPU's from ``_CPU_RUNS``). Float64: every tap, parameter
    gradient and running statistic on the card within BACKBONE_F64_RTOL
    (of its norm) of the CPU's: each operation's semantics on the card
    (cuDNN keeps double convolutions NCHW, so not the channels-last
    layouts of the other dtypes). Float32, on the layouts the steps run:
    each tap within TAP_RTOL of its largest value from the CPU's float64
    tap, every parameter gradient within GRAD_MAX_RTOL of float64 and
    every running statistic within BN_TOL of the CPU's. The gradients'
    median is printed beside the CPU's but not held to it: cuDNN's float32
    algorithms set it (VGG16, which has no BatchNorm to lose digits in,
    sits ~1000x the CPU's distance from float64 on the card; phase 29's
    line). Returns a summary."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.tools.zoo_precision import backbone_run

    name = check.nets["depth"]
    # zoo_precision.seeded_backbone's, from the model the step checks build
    backbone = _seeded_model(check.keys, check.nets, torch.device("cpu")).depthnet.backbone
    initial = {k: v.double() for k, v in backbone.state_dict().items()}
    image = _zoo_image(check)
    runs = {}
    for dtype in (torch.float64, torch.float32):
        runs["card", dtype] = backbone_run(backbone, image, device, dtype)
        cpu = _CPU_RUNS.result((check.label, f"backbone {dtype}"), _cpu_backbone, check,
                               str(dtype).split(".")[1])
        _check_digest(f"{name} backbone", cpu["digest"], backbone.state_dict())
        runs["cpu", dtype] = _cast(cpu["run"], torch.float64)

    def rel(a, b):
        # a norm below GRAD_FLOOR is 0 but for rounding (a bias whose shift
        # the next train-mode BatchNorm removes, the batch mean of a 1x1
        # conv of zero-mean channels): compare it at that scale
        return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), GRAD_FLOOR))

    card64, cpu64 = runs["card", torch.float64], runs["cpu", torch.float64]
    f64 = {f"tap {i}": rel(a, b) for i, (a, b) in enumerate(zip(card64[0], cpu64[0]))}
    f64.update({n: rel(g, cpu64[1][n]) for n, g in card64[1].items()})
    f64.update({k: rel(v, cpu64[2][k]) for k, v in card64[2].items()})
    worst64 = max(f64, key=f64.get)

    card32, cpu32 = runs["card", torch.float32], runs["cpu", torch.float32]
    taps32 = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(card32[0], cpu64[0]))
    ref = {n: g for n, g in cpu64[1].items() if float(torch.linalg.norm(g)) > GRAD_FLOOR}
    errors = {where: _rel_errors(run[1], ref) for where, run in (("card", card32),
                                                                 ("cpu", cpu32))}
    median = {where: float(np.median(list(e.values()))) for where, e in errors.items()}
    worst_stat = 0.0
    for key in cpu32[2]:
        momentum = backbone.get_submodule(key.rsplit(".", 1)[0]).momentum
        folded = [(run[2][key] - (1.0 - momentum) * initial[key]) / momentum
                  for run in (card32, cpu32)]
        excess = torch.abs(folded[0] - folded[1]) - BN_TOL[0] * torch.abs(folded[1])
        worst_stat = max(worst_stat, float(excess.max()))
    summary = (f"{name} backbone alone at {tuple(image.shape)}: float64 card vs CPU worst "
               f"{worst64} {f64[worst64]:.3g} over {len(f64)} taps, gradients and statistics; "
               f"float32 taps off float64 at most {taps32:.3g} of the largest, gradients' "
               f"median relative error card {median['card']:.3g}, CPU {median['cpu']:.3g} "
               f"({len(ref)} tensors), worst card {max(errors['card'].values()):.3g}, CPU "
               f"{max(errors['cpu'].values()):.3g}; BN statistics worst excess over rtol "
               f"{BN_TOL[0]} {worst_stat:.3g}")
    if not (f64[worst64] <= BACKBONE_F64_RTOL and taps32 <= TAP_RTOL
            and max(errors["card"].values()) <= GRAD_MAX_RTOL and worst_stat <= BN_TOL[1]):
        raise AssertionError(f"outside BACKBONE_F64_RTOL, TAP_RTOL, GRAD_MAX_RTOL or BN_TOL: "
                             f"{summary}")
    return summary


def _pool_layout_check(device):
    """NASNet's count-excluding SAME pool (``avg_pool_same_excluding_pad``)
    on a channels-last card tensor, as cuDNN's convolutions hand it on,
    against the CPU: torch's own avg_pool2d with that padding and
    ``divisor_override`` (whose backward is wrong there) and the port's
    pool (a contiguous copy), forward and backward; the port's within
    POOL_RTOL of the largest value. Returns a summary."""
    import torch
    import torch.nn.functional as F

    from xpt_mde_tpu_torch.models.layers import avg_pool_same_excluding_pad

    generator = torch.Generator().manual_seed(29)
    x = torch.randn((CHECK_BATCH, 44, 16, 64), generator=generator)
    cot = torch.randn(x.shape, generator=generator)
    pools = {"torch's avg_pool2d": lambda t: F.avg_pool2d(t, 3, 1, 1, divisor_override=1),
             "the port's pool": lambda t: avg_pool_same_excluding_pad(t, 3)}
    errors = {}
    for label, pool in pools.items():
        results = []
        for dev in (device, torch.device("cpu")):
            leaf = x.to(dev).to(memory_format=torch.channels_last).requires_grad_(True)
            out = pool(leaf)
            out.backward(cot.to(dev))
            results.append((out.detach().cpu(), leaf.grad.cpu()))
        errors[label] = [float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(*results)]
    if not max(errors["the port's pool"]) <= POOL_RTOL:
        raise AssertionError(f"the count-excluding pool on a channels-last tensor: {errors}")
    return "; ".join(f"{label} forward {e[0]:.3g}, backward {e[1]:.3g}"
                     for label, e in errors.items())


def _write_shards(shard_root, dataset, height, width, counts, keys, **options):
    """Under ``shard_root``, one ``{dataset}_{split}`` directory of ``n``
    examples per ``{split: n}`` of ``counts``: the port's synthetic
    snippets (``SyntheticDataset(**options)``; split i from seed i), each
    example holding ``keys`` of a loader's features, the images as
    ``[5H, W, 3]`` uint8 (the frames stacked vertically, target last)."""
    import numpy as np

    from xpt_mde_tpu_torch.config import SNIPPET_LEN
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.data.shard_io import ShardWriter

    for seed, (split, n) in enumerate(counts.items()):
        with ShardWriter(Path(shard_root) / f"{dataset}_{split}") as writer:
            for batch in SyntheticDataset(batch_size=n, height=height, width=width,
                                          num_batches=1, seed=seed, **options):
                for key in ("image5d", "image5d_R"):
                    if key in batch:
                        batch[key] = ((np.clip(batch[key], -1, 1) + 1) / 2 * 255).astype(
                            np.uint8).reshape(n, SNIPPET_LEN * height, width, 3)
                for i in range(n):
                    writer.write({key: batch[key.replace("image", "image5d")][i]
                                  for key in keys})
            writer.write_config({"dataset": dataset, "split": split,
                                 "imshape": [SNIPPET_LEN, height, width, 3]})


def write_synthetic_shards(shard_root, height, width, counts):
    """Shards of the port's synthetic snippets in the schema of the port's
    ``ShardMaker("synthetic")`` (``data/shard_maker.py``), written from
    ``SyntheticDataset`` batches at any size: under ``shard_root``, one
    ``synthetic_{split}`` directory of ``n`` examples per ``{split: n}`` of
    ``counts``, each example {depth_gt [H, W, 1] float32, image [5H, W, 3]
    uint8 (the frames stacked vertically, target last), intrinsic [3, 3]
    float32, pose_gt [4, 4, 4] float32}. Split i draws its snippets from
    seed i."""
    _write_shards(shard_root, "synthetic", height, width, counts,
                  ("image", "intrinsic", "depth_gt", "pose_gt"))


def write_stereo_shards(shard_root, height, width, counts):
    """Shards of the port's synthetic STEREO snippets (a textured plane seen
    by a stereo rig stepping in x; the data are synthetic, not KITTI) in
    the schema of the port's ``ShardMaker`` for ``kitti_raw``
    (``data/shard_maker.py::DEFAULT_DATA_KEYS``), under the dataset name
    ``kitti_raw``, so that the published plans'
    rows read them unchanged: one ``kitti_raw_{split}`` directory of ``n``
    examples per ``{split: n}`` of ``counts``, each example {image,
    image_R [5H, W, 3] uint8 (the frames stacked vertically, target
    last), intrinsic, intrinsic_R [3, 3], depth_gt [H, W, 1], pose_gt [4,
    4, 4], stereo_T_LR [4, 4], float32}. Split i draws its snippets from
    seed i."""
    from xpt_mde_tpu_torch.tools.profile_steps import STEREO_KEYS

    _write_shards(shard_root, "kitti_raw", height, width, counts, STEREO_KEYS, stereo=True)


def _build_dir() -> Path:
    """The checkout's ``build/`` (listed in ``.gitignore``)."""
    path = Path(__file__).resolve().parent / "build"
    path.mkdir(exist_ok=True)
    return path


class _Tee(io.StringIO):
    """Keeps what is printed and prints it too."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)

    def flush(self):
        self.out.flush()


def _plan_phase(workdir, device, counts, zero_counts, tag):
    """Phase 15 in ``workdir``: returns (kernel launches of the plan run,
    a summary line)."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.config import (FLOW_NET, JOINT_NET, RIGID_NET, SCALE_WEIGHT_T1,
                                          Config, TestStage, TrainStage)
    from xpt_mde_tpu_torch.evaluate.evaluate_main import evaluate_by_plan, predict_by_plan
    from xpt_mde_tpu_torch.training.trainer import default_dataset_factory, train_by_plan

    t0 = time.perf_counter()
    write_synthetic_shards(Path(workdir) / "shards", HEIGHT, WIDTH, PLAN_SNIPPETS)
    shard_s = time.perf_counter() - t0
    plan = [TrainStage(RIGID_NET, "synthetic", 1, LR, RECIPE, SCALE_WEIGHT_T1),
            TrainStage(FLOW_NET, "synthetic", 1, LR, FLOW_RECIPE, SCALE_WEIGHT_T1),
            TrainStage(JOINT_NET, "synthetic", 1, LR, JOINT_RECIPE, SCALE_WEIGHT_T1)]
    cfg = Config(stereo=False, per_replica_batch=BATCH, datapath=str(workdir),
                 ckpt_name="smoke", pretrained_weight=False, training_plan=plan,
                 compute_dtype="float32",
                 test_plan=[TestStage(JOINT_NET, "synthetic", ["depth", "pose"], "smoke")])
    loader_kind = default_dataset_factory(cfg)("synthetic", "train", BATCH).kind
    if loader_kind != "native":
        raise AssertionError(f"make_loader gave the {loader_kind} loader, not the native one")
    ckpt = Path(cfg.datapath_ckp) / cfg.ckpt_name

    def load(name):
        return torch.load(ckpt / name, map_location="cpu", weights_only=True)

    def same(a, b):
        return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)

    def run(plan_rows):
        run_cfg = copy.copy(cfg)
        run_cfg.training_plan = plan_rows
        t_start = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout)) as log:
            train_by_plan(run_cfg, device=device)
        return log.getvalue(), time.perf_counter() - t_start

    zero_counts()
    # the two pretraining rows, then the whole plan, so the joint row runs
    # alone in the second call and its start can be checked
    _, pre_s = run(plan[:2])
    for net in ("depthnet", "posenet"):
        if not same(load(f"{net}_latest.pt"), load(f"{net}_ep01.pt")):
            raise AssertionError(f"the flow row changed {net}_latest.pt")
    flow_row = load("flownet_ep02.pt")
    if not same(load("flownet_latest.pt"), flow_row):
        raise AssertionError("flownet_latest.pt is not the flow row's flownet")
    rigid_row = {net: load(f"{net}_ep01.pt") for net in ("depthnet", "posenet")}
    log, joint_s = run(plan)
    joint_log = log[log.index("[train_stage] stage 2"):]
    for net in ("depthnet", "posenet", "flownet"):
        if f"[ckpt] loaded {net} from {net}_latest.pt" not in joint_log:
            raise AssertionError(f"the joint row did not start from {net}_latest.pt")
    for name in ("flownet_latest.pt", "flownet_ep03.pt"):
        if not same(load(name), flow_row):
            raise AssertionError(f"{name} differs from the flow row's flownet")
    if any(same(load(f"{net}_ep03.pt"), rigid_row[net]) for net in rigid_row):
        raise AssertionError("the joint row did not train the depth and pose nets")
    files = {"ep01": ("depthnet", "posenet"), "ep02": ("flownet",),
             "ep03": ("depthnet", "posenet", "flownet"),
             "latest": ("depthnet", "posenet", "flownet")}
    missing = [f"{net}_{sfx}.pt" for sfx, nets in files.items() for net in nets + ("trainstate",)
               if not (ckpt / f"{net}_{sfx}.pt").is_file()]
    if missing:
        raise AssertionError(f"missing checkpoints {missing}")
    history = (ckpt / "history.csv").read_text().strip().splitlines()
    header = history[0].split(",")
    rows = [dict(zip(header, line.split(","))) for line in history[1:]]
    if [r["epoch"] for r in rows] != ["0", "1", "2"]:
        raise AssertionError(f"history.csv has epochs {[r['epoch'] for r in rows]}")
    panels = _check_panels(ckpt, ["rigid", "flow", "joint"], HEIGHT)
    before = counts()
    log, skip_s = run(plan)
    if counts() != before or log.count("already done") != len(plan):
        raise AssertionError(f"a finished plan ran again: {counts()} vs {before}")

    t0 = time.perf_counter()
    predict_by_plan(cfg, device=device)
    evaluate_by_plan(cfg)
    eval_s = time.perf_counter() - t0
    npz = np.load(Path(cfg.datapath_prd) / "smoke" / "synthetic_latest.npz")
    n_test = PLAN_SNIPPETS["test"]
    if npz["depth"].shape != (n_test, HEIGHT, WIDTH, 1) or npz["pose"].shape != (n_test, 4, 6):
        raise AssertionError(f"predictions {npz['depth'].shape}, {npz['pose'].shape}")
    summary_file = Path(cfg.datapath_evl) / "smoke" / "summary_synthetic_latest.csv"
    summary = {k: float(v) for k, v in (line.split(",") for line in
                                        summary_file.read_text().strip().splitlines()[1:])}
    want = {"abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3", "trj_abs_err",
            "trj_rel_err", "rot_err"}
    if set(summary) != want or not all(np.isfinite(v) for v in summary.values()):
        raise AssertionError(f"evaluation summary {summary}")
    rates = {r["epoch"]: PLAN_SNIPPETS["train"] / float(r["train_sec_per_epoch"]) for r in rows}
    print(f"timing plan rows (train epoch of {PLAN_SNIPPETS['train']} snippets at batch "
          f"{BATCH}, {HEIGHT}x{WIDTH}): rigid {rates['0']:.2f}, flow {rates['1']:.2f}, joint "
          f"{rates['2']:.2f} images/s; calls: shards {shard_s:.1f} s, pretraining rows "
          f"{pre_s:.1f} s, joint row {joint_s:.1f} s, finished plan {skip_s:.2f} s, predict + "
          f"evaluate {eval_s:.1f} s {tag}", flush=True)
    note = (f"{loader_kind} loader; history.csv epochs 0-2 with train_loss "
            f"{[round(float(r['train_loss']), 6) for r in rows]}; the joint row started from "
            f"the rigid row's depthnet/posenet and the flow row's flownet, which stayed "
            f"bit-equal to flownet_ep02.pt; reconstruction panels of {panels} views; a third "
            f"call skipped all {len(plan)} rows with no launch; evaluate_by_plan on {n_test} "
            f"test snippets: "
            f"{json.dumps({k: round(v, 6) for k, v in summary.items()})}")
    return counts(), note


def _panel_views(ckpt_dir, epoch: int, height: int) -> list:
    """The number of views in each reconstruction panel the logger wrote
    for ``epoch`` (a panel stacks 12-row title banners and views of
    ``height`` rows)."""
    import cv2

    counts = []
    for png in sorted((Path(ckpt_dir) / "reconstruction").glob(f"ep{epoch:03d}_*.png")):
        rows = cv2.imread(str(png)).shape[0]
        if rows % (12 + height):
            raise AssertionError(f"{png.name}: {rows} rows are no stack of {height}-row views")
        counts.append(rows // (12 + height))
    return counts


def _check_panels(ckpt_dir, rows: list, height: int) -> str:
    """Every epoch of ``rows`` (the plan's row kinds in order, one epoch
    each) has min(4, BATCH) panels of PANEL_VIEWS[kind] views; a flow row
    none."""
    for epoch, kind in enumerate(rows):
        views = _panel_views(ckpt_dir, epoch, height)
        want = [PANEL_VIEWS[kind]] * min(4, BATCH) if PANEL_VIEWS[kind] else []
        if views != want:
            raise AssertionError(f"epoch {epoch} ({kind} row): panels of {views} views, "
                                 f"want {want}")
    return ", ".join(f"{kind} {PANEL_VIEWS[kind]}" for kind in rows)


def _pretrained_phase(device, counts, zero_counts, tag):
    """Phase 32: returns ({path: kernel launches}, a summary line)."""
    import importlib.util

    import torch

    from xpt_mde_tpu_torch.config import (NUM_SRC, RIGID_NET, SCALE_WEIGHT_T1, Config,
                                          TestStage, TrainStage)
    from xpt_mde_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
    from xpt_mde_tpu_torch.evaluate.evaluate_debug import debug_by_plan
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.scripts.convert_backbone_weights import write_pretrained
    from xpt_mde_tpu_torch.training.checkpoint import load_pretrained_backbone
    from xpt_mde_tpu_torch.training.trainer import train_by_plan
    from xpt_mde_tpu_torch.utils.flax_msgpack import from_bytes

    libraries = {name: importlib.util.find_spec(name) is not None
                 for name in ("h5py", "matplotlib", "cv2")}
    print(f"phase 32 libraries on this machine: {json.dumps(libraries)}", flush=True)
    keys = ["image", "intrinsic", "depth_gt", "pose_gt"]

    def seeded_file(net, seed, datapath):
        """A pretrained file of ``net``'s backbone, every weight and
        statistic drawn from ``seed``."""
        backbone = ModelFactory(keys, {"depth": net}, stereo=False, device="cpu",
                                seed=seed).get_model().depthnet.backbone
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, buf in backbone.named_buffers():
                if buf.is_floating_point():
                    buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
        tree = state_dict_to_flax(backbone)
        return write_pretrained(tree["params"], tree["batch_stats"], datapath, net)

    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        root = Path(workdir)
        # 1. the file, loaded on the card bit for bit; another width refused
        path = seeded_file(RIGID_NET["depth"], 1, root)
        other = seeded_file("EfficientNetB0", 2, root / "other")
        model = ModelFactory(keys, RIGID_NET, stereo=False, compute_dtype="bfloat16",
                             device=device).get_model()
        if not load_pretrained_backbone(model, path):
            raise AssertionError(f"load_pretrained_backbone refused {path}")
        want = flax_to_state_dict(from_bytes(path.read_bytes()), model.depthnet.backbone)
        got = model.depthnet.backbone.state_dict()
        off = [k for k in want if not k.endswith("num_batches_tracked")
               and not (got[k].device == device and torch.equal(got[k].cpu(), want[k]))]
        if set(got) != set(want) or off:
            raise AssertionError(f"backbone tensors not the file's bits on the card: {off[:5]}")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        if load_pretrained_backbone(model, other):
            raise AssertionError("an EfficientNetB0 file loaded into EfficientNetB5")
        if any(not torch.equal(v, before[k]) for k, v in model.state_dict().items()):
            raise AssertionError("the refused file changed a weight")
        n_tensors = len(want)
        del model, before, got, want
        gc.collect()
        torch.cuda.empty_cache()

        # 2. one rigid row at Config()'s defaults, from the file
        write_synthetic_shards(root / "shards", HEIGHT, WIDTH, PRETRAINED_SNIPPETS)
        cfg = Config(stereo=False, per_replica_batch=BATCH, datapath=workdir,
                     ckpt_name="pretrained",
                     training_plan=[TrainStage(RIGID_NET, "synthetic", 1, LR, RECIPE,
                                               SCALE_WEIGHT_T1)],
                     test_plan=[TestStage(RIGID_NET, "synthetic", ["depth", "pose"],
                                          "pretrained")])
        if not (cfg.pretrained_weight and cfg.compute_dtype == "bfloat16"):
            raise AssertionError("Config() no longer defaults to bfloat16 from pretrained weights")
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout)) as log:
            train_by_plan(cfg, device=device)
        row_s = time.perf_counter() - t0
        row_counts = counts()
        if f"[ckpt] loaded pretrained backbone from {path}" not in log.getvalue():
            raise AssertionError("the row did not start from the pretrained file")
        missing = [k for k in ("K1", "K1-bwd") if row_counts[k] == 0]
        if missing:
            raise AssertionError(f"the pretrained row never launched {missing}: {row_counts}")
        ckpt = Path(cfg.datapath_ckp) / cfg.ckpt_name
        written = ["history.csv"] + (["history.png"] if libraries["matplotlib"] else [])
        absent = [name for name in written if not (ckpt / name).is_file()]
        if absent:
            raise AssertionError(f"the logger did not write {absent}")
        panels = _check_panels(ckpt, ["rigid"], HEIGHT)

        # 3. the debug evaluator over the row's checkpoint
        zero_counts()
        t0 = time.perf_counter()
        debug_by_plan(cfg, device=device)
        debug_s = time.perf_counter() - t0
        debug_counts = counts()
        if debug_counts["K1"] == 0:
            raise AssertionError(f"debug_by_plan never launched K1: {debug_counts}")
        debug = Path(cfg.datapath_evl) / "pretrained" / "debug_synthetic_latest"
        csvs = {name: len((debug / name).read_text().strip().splitlines()) - 1
                for name in ("debug_depth.csv", "debug_pose.csv", "trajectory.csv")}
        n_test = PRETRAINED_SNIPPETS["test"]
        if csvs != {"debug_depth.csv": n_test, "debug_pose.csv": n_test * NUM_SRC,
                    "trajectory.csv": n_test * NUM_SRC}:
            raise AssertionError(f"debug CSV rows {csvs}")
        views = sorted(debug.glob("worst_*/frame_*.png"))
        if not views:
            raise AssertionError("debug_by_plan wrote no worst-frame views")
    note = (f"{n_tensors} backbone tensors of a seeded EfficientNetB5 file on the card bit for "
            f"bit, an EfficientNetB0 file refused with every weight unchanged; a bf16 rigid row "
            f"from the file ({row_s:.1f} s, panels of {panels} views); debug_by_plan "
            f"({debug_s:.1f} s): rows {json.dumps(csvs)}, {len(views)} worst-frame views {tag}")
    return {"pretrained row": row_counts, "debug_by_plan": debug_counts}, note


def _stereo_plan_phase(workdir, device, counts, zero_counts, tag, compute_dtype="float32"):
    """Phase 20 (``compute_dtype`` float32) or 24 (None: the default
    ``Config()``, bfloat16) in ``workdir``: the stereo plan. Returns (kernel
    launches of its run, a summary line)."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.config import (FLOW_NET, JOINT_NET, LOSS_FLOW, LOSS_RIGID_COMB,
                                          LOSS_RIGID_T2, RIGID_NET, SCALE_WEIGHT_T1, Config,
                                          TestStage, TrainStage)
    from xpt_mde_tpu_torch.evaluate.evaluate_main import evaluate_by_plan, predict_by_plan
    from xpt_mde_tpu_torch.training.trainer import train_by_plan

    t0 = time.perf_counter()
    write_stereo_shards(Path(workdir) / "shards", HEIGHT, WIDTH, STEREO_PLAN_SNIPPETS)
    shard_s = time.perf_counter() - t0
    # a flow row (LOSS_FLOW in full), row 2 of training_plan_30 and its row 4
    plan = [TrainStage(FLOW_NET, "kitti_raw", 1, LR, LOSS_FLOW, SCALE_WEIGHT_T1),
            TrainStage(RIGID_NET, "kitti_raw", 1, LR, LOSS_RIGID_T2, SCALE_WEIGHT_T1),
            TrainStage(JOINT_NET, "kitti_raw", 1, LR, LOSS_RIGID_COMB, SCALE_WEIGHT_T1)]
    dtype_kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    cfg = Config(per_replica_batch=BATCH, datapath=str(workdir), ckpt_name="stereo",
                 pretrained_weight=False, training_plan=plan,
                 test_plan=[TestStage(JOINT_NET, "kitti_raw", ["depth", "pose"], "stereo")],
                 **dtype_kw)
    if not cfg.stereo:
        raise AssertionError("Config.stereo is off by default")
    if compute_dtype is None and cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"Config() computes in {cfg.compute_dtype}, not bfloat16")
    ckpt = Path(cfg.datapath_ckp) / cfg.ckpt_name
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout)) as log:
        train_by_plan(cfg, device=device)
    train_s = time.perf_counter() - t0
    joint_log = log.getvalue()[log.getvalue().index("[train_stage] stage 2"):]
    for net in ("depthnet", "posenet", "flownet"):
        if f"[ckpt] loaded {net} from {net}_latest.pt" not in joint_log:
            raise AssertionError(f"the stereo joint row did not start from {net}_latest.pt")
    flow_row = torch.load(ckpt / "flownet_ep01.pt", map_location="cpu", weights_only=True)
    joint_flow = torch.load(ckpt / "flownet_ep03.pt", map_location="cpu", weights_only=True)
    if not all(torch.equal(flow_row[k], joint_flow[k]) for k in flow_row):
        raise AssertionError("the stereo joint row changed the frozen flownet")
    history = (ckpt / "history.csv").read_text().strip().splitlines()
    header = history[0].split(",")
    rows = [dict(zip(header, line.split(","))) for line in history[1:]]
    if [r["epoch"] for r in rows] != ["0", "1", "2"]:
        raise AssertionError(f"history.csv has epochs {[r['epoch'] for r in rows]}")
    terms = {f"train_loss_{k}" for recipe in (LOSS_FLOW, LOSS_RIGID_T2, LOSS_RIGID_COMB)
             for k in recipe}
    if not terms <= set(header):
        raise AssertionError(f"history.csv lacks {sorted(terms - set(header))}")
    t0 = time.perf_counter()
    predict_by_plan(cfg, device=device)
    evaluate_by_plan(cfg)
    eval_s = time.perf_counter() - t0
    npz = np.load(Path(cfg.datapath_prd) / "stereo" / "kitti_raw_latest.npz")
    n_test = STEREO_PLAN_SNIPPETS["test"]
    if npz["depth"].shape != (n_test, HEIGHT, WIDTH, 1) or npz["pose"].shape != (n_test, 4, 6):
        raise AssertionError(f"predictions {npz['depth'].shape}, {npz['pose'].shape}")
    if npz["depth"].dtype != np.float32 or npz["pose"].dtype != np.float32:
        raise AssertionError(f"predictions in {npz['depth'].dtype}, {npz['pose'].dtype}")
    summary_file = Path(cfg.datapath_evl) / "stereo" / "summary_kitti_raw_latest.csv"
    summary = {k: float(v) for k, v in (line.split(",") for line in
                                        summary_file.read_text().strip().splitlines()[1:])}
    want = {"abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3", "trj_abs_err",
            "trj_rel_err", "rot_err"}
    if set(summary) != want or not all(np.isfinite(v) for v in summary.values()):
        raise AssertionError(f"stereo evaluation summary {summary}")
    rates = {r["epoch"]: STEREO_PLAN_SNIPPETS["train"] / float(r["train_sec_per_epoch"])
             for r in rows}
    print(f"timing stereo plan rows ({cfg.compute_dtype}; train epoch of "
          f"{STEREO_PLAN_SNIPPETS['train']} stereo "
          f"snippets at batch {BATCH}, {HEIGHT}x{WIDTH}): flow {rates['0']:.2f}, rigid "
          f"{rates['1']:.2f}, joint {rates['2']:.2f} images/s; calls: shards {shard_s:.1f} s, "
          f"three rows {train_s:.1f} s, predict + evaluate {eval_s:.1f} s {tag}", flush=True)
    note = (f"history.csv epochs 0-2 with train_loss "
            f"{[round(float(r['train_loss']), 6) for r in rows]}, every stereo term logged; "
            f"the joint row started from the flow row's flownet and kept it bit-equal; "
            f"evaluate_by_plan on {n_test} stereo test snippets: "
            f"{json.dumps({k: round(v, 6) for k, v in summary.items()})}")
    return counts(), note


def _mini_plan_kernels(device, tag):
    """Phase 25: the kernels against their plain versions at the shapes of
    the miniature plan (``training/mini_plan.py``): K1 and K1-bwd at the
    rigid rows' four scales of 32x64 (batch 8 x 4 sources, the plan's
    world), and K2, K3 and K4 in float32 and bfloat16 at the five PWC
    levels of 64x128 (16x32 down to 1x2, smaller than the 9x9 window, with
    W % 8 != 0 at levels 5 and 6). Returns {kernel: max abs err}."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.training import mini_plan as mp

    height, width = mp.RIGID_SIZE
    world = SyntheticDataset(batch_size=BATCH, height=height, width=width, num_batches=1,
                             varying_depth=True, vary_motion=True, seed=0)
    errs = {name: s["err"] for name, s in _warp_phase(
        list(world), device, np.random.RandomState(5), tag, phase_no=25).items()}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "-bf16")):
        stats = _corr_phase(device, tag, dtype, size=mp.FLOW_SIZE, phase_no=25)
        errs.update({name + suffix: s["err"] for name, s in stats.items()})
    return errs


def _learning_phase(device, counts, zero_counts, tag):
    """Phases 26 and 27: the miniature plan's learning check
    (``tools/check_learns.py::check_plan``, the JAX check's protocol) in
    float32, then in bfloat16 at MINI_PLAN_DEPTH's epochs, each in a temporary
    directory under ``build/`` with its counts read from zero. float32
    must meet the JAX check's criteria; bfloat16 must keep the hand-off
    exact and its metrics finite (``check_plan`` raises otherwise) and
    reports whether it meets them. Each result goes to RESULTS_torch.jsonl. Returns
    {dtype: (launches of the run, result)}."""
    from xpt_mde_tpu_torch.tools.check_learns import check_plan, result_payload
    from xpt_mde_tpu_torch.utils.results import record

    runs = {}
    for phase_no, dtype in ((26, "float32"), (27, "bfloat16")):
        zero_counts()
        with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
            result = check_plan(workdir, dtype, device=device,
                                log=lambda line, d=dtype: print(f"mini plan {d} {line}",
                                                                flush=True),
                                **MINI_PLAN_DEPTH[dtype])
        runs[dtype] = (counts(), result)
        for row in result["rows"]:
            per_step = {k: round(v, 3) for k, v in row["launches_per_step"].items()}
            print(f"timing mini plan {dtype} {row['row']} row: {row['steps']} steps at batch "
                  f"{result['protocol']['batch']}, {row['seconds']:.1f} s in train_by_plan "
                  f"({row['train_seconds']:.1f} s in its train epochs, "
                  f"{row['images_per_s']:.1f} images/s; rendering the world on the host "
                  f"{row['render_share']:.3f} of the train seconds), launches per train step "
                  f"{json.dumps(per_step)} (validation and the scale log included) {tag}",
                  flush=True)
        payload = result_payload(result)
        record("plan_learns", dict(payload, source="chip_smoke.py"), dtype)
        print(f"phase {phase_no} mini plan {dtype}: criteria (value, limit) "
              f"{json.dumps(payload['criteria'])}, meets them: {result['meets_criteria']}; "
              f"hand-off {json.dumps(result['handoff'])}; the phase took "
              f"{result['seconds']:.1f} s {tag}", flush=True)
    f32, bf16 = runs["float32"][1], runs["bfloat16"][1]
    if not f32["meets_criteria"]:
        raise AssertionError(f"the float32 miniature plan missed the JAX check's criteria: "
                             f"{f32['criteria']}")
    for stage in f32["trajectory"]:
        a, b = f32["trajectory"][stage], bf16["trajectory"][stage]
        print(f"mini plan trajectory {stage}: AbsRel float32 {a['abs_rel']:.4f} / bfloat16 "
              f"{b['abs_rel']:.4f}, trajectory rel err {a['trj_rel_err']:.4f} / "
              f"{b['trj_rel_err']:.4f}"
              + (f", flow EPE {a['flow_epe']:.4f} / {b['flow_epe']:.4f} px"
                 if "flow_epe" in a else ""), flush=True)
    print(json.dumps({"mini_plan": {"bf16_meets_criteria": bool(bf16["meets_criteria"]),
                                    "float32_meets_criteria": True,
                                    "seconds": {d: round(r[1]["seconds"], 1)
                                                for d, r in runs.items()}}}), flush=True)
    return runs


@contextlib.contextmanager
def _unimportable(names):
    """Make the modules ``names`` unimportable in this process for the
    block (an import of them raises ImportError); those already loaded
    come back after it."""
    saved = {name: sys.modules.get(name) for name in names}
    sys.modules.update(dict.fromkeys(names))
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                del sys.modules[name]
            else:
                sys.modules[name] = module


def _shard_phase(device, counts, zero_counts, tag):
    """Phase 28, the shard chain, in a temporary directory under
    ``build/``: the port's ``convert_to_shards`` builds ``synthetic_train``,
    ``synthetic_test`` and ``synthetic_val`` (SHARD_DRIVES drives of the
    synthetic reader) at ``Config()``'s defaults (synthetic at 128x384),
    serially and then with
    ``shard_build_workers=2`` through the spawn pool; the two trees must
    be byte-identical, the pool must really have run (no serial
    fallback), and neither may import OpenCV or PIL (both are made
    unimportable in this process while they run: the logger's panels of
    the phases before have loaded OpenCV). Then one rigid
    row (RIGID_NET, batch 8, bfloat16: ``Config()``'s dtype) trains on
    those shards through ``train_by_plan`` and the native loader, and
    ``predict_by_plan`` + ``evaluate_by_plan`` run on ``synthetic_test``:
    finite metrics, K1 and K1-bwd launched. Returns (the row's launches,
    a summary line)."""
    import numpy as np

    from xpt_mde_tpu_torch.config import (RIGID_NET, SCALE_WEIGHT_T1, Config, TestStage,
                                          TrainStage)
    from xpt_mde_tpu_torch.data.shard_io import ShardDataset
    from xpt_mde_tpu_torch.data.shard_maker import convert_to_shards
    from xpt_mde_tpu_torch.evaluate.evaluate_main import evaluate_by_plan, predict_by_plan
    from xpt_mde_tpu_torch.training.trainer import default_dataset_factory, train_by_plan

    splits = ("train", "test", "val")
    with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
        builds = {}
        for mode, workers in (("serial", 0), ("pool", 2)):
            cfg = Config(datapath=str(Path(workdir) / mode), shard_build_workers=workers)
            t0 = time.perf_counter()
            with _unimportable(("cv2", "PIL")):
                modes = convert_to_shards(cfg, {"synthetic": {"drives": SHARD_DRIVES}},
                                          {"synthetic": ["train", "test"]})
            seconds = time.perf_counter() - t0
            if modes != {"synthetic_train": mode, "synthetic_test": mode}:
                raise AssertionError(f"the {mode} build ran as {modes}")
            shards = Path(cfg.datapath_shd)
            sizes = {s: len(ShardDataset(shards / f"synthetic_{s}")) for s in splits}
            builds[mode] = (shards, seconds, sizes)
        files = {mode: sorted(p.relative_to(b[0]) for p in b[0].rglob("*") if p.is_file())
                 for mode, b in builds.items()}
        if files["serial"] != files["pool"] or not files["serial"]:
            raise AssertionError(f"the builds wrote other files: {files}")
        differ = [str(f) for f in files["serial"]
                  if (builds["serial"][0] / f).read_bytes() != (builds["pool"][0] / f).read_bytes()]
        if differ:
            raise AssertionError(f"the pool build differs from the serial one in {differ}")
        example = ShardDataset(builds["serial"][0] / "synthetic_train").read_example(0)
        height, width = Config().image_sizes["synthetic"]
        if example["image"].shape != (5 * height, width, 3):
            raise AssertionError(f"shard image {example['image'].shape}")
        for mode, (_, seconds, sizes) in builds.items():
            built = sizes["train"] + sizes["test"]
            print(f"timing shard build {mode}: synthetic_train {sizes['train']}, synthetic_test "
                  f"{sizes['test']} and synthetic_val {sizes['val']} examples at "
                  f"{height}x{width} in {seconds:.2f} s of host time, {built / seconds:.1f} "
                  f"examples/s (train and test) {tag}", flush=True)

        cfg = Config(stereo=False, per_replica_batch=BATCH,
                     datapath=str(builds["serial"][0].parent), ckpt_name="shards",
                     pretrained_weight=False,
                     training_plan=[TrainStage(RIGID_NET, "synthetic", 1, LR, RECIPE,
                                               SCALE_WEIGHT_T1)],
                     test_plan=[TestStage(RIGID_NET, "synthetic", ["depth", "pose"], "shards")])
        loader_kind = default_dataset_factory(cfg)("synthetic", "train", BATCH).kind
        if loader_kind != "native":
            raise AssertionError(f"make_loader gave the {loader_kind} loader, not the native one")
        zero_counts()
        train_by_plan(cfg, device=device)
        predict_by_plan(cfg, device=device)
        launches = counts()
        evaluate_by_plan(cfg)
        if not (launches["K1"] and launches["K1-bwd"]):
            raise AssertionError(f"the rigid row launched {launches}")
        history = (Path(cfg.datapath_ckp) / "shards" / "history.csv").read_text().splitlines()
        row = dict(zip(history[0].split(","), history[1].split(",")))
        rate = builds["serial"][2]["train"] // BATCH * BATCH / float(row["train_sec_per_epoch"])
        summary_file = Path(cfg.datapath_evl) / "shards" / "summary_synthetic_latest.csv"
        summary = {k: float(v) for k, v in (line.split(",") for line in
                                            summary_file.read_text().strip().splitlines()[1:])}
        if not summary or not all(np.isfinite(v) for v in summary.values()):
            raise AssertionError(f"evaluation summary {summary}")
        print(f"timing shard chain rigid row (RIGID_NET, batch {BATCH}, bfloat16, "
              f"{height}x{width}, the native loader): {rate:.2f} images/s over the train epoch "
              f"{tag}", flush=True)
    note = (f"serial and pool builds byte-identical ({len(files['serial'])} files), the pool "
            f"ran, cv2 and PIL unimportable; rigid row train_loss {float(row['train_loss']):.6f}; "
            f"evaluate_by_plan on {builds['serial'][2]['test']} test snippets: "
            f"{json.dumps({k: round(v, 6) for k, v in summary.items()})}")
    return launches, note


def _zoo_checks() -> dict:
    """Phase 29's cross-checked steps, one a backbone of ZOO_BACKBONES as
    the depth net with PoseNetImproved: a synthetic batch of CHECK_BATCH
    at ZOO_CHECK_SIZE, its images scaled to [0, 255], RECIPE, the pose
    head at CHECK_TWIST."""
    import torch

    from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.losses import loss_factory

    keys = ["image", "intrinsic", "depth_gt", "pose_gt"]
    dataset = SyntheticDataset(batch_size=CHECK_BATCH, height=ZOO_CHECK_SIZE[0],
                               width=ZOO_CHECK_SIZE[1], num_batches=1, seed=30)
    feats = {k: torch.from_numpy(v) for k, v in next(iter(dataset)).items()}
    feats["image5d"] = (feats["image5d"] + 1.0) * 127.5
    loss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=CHECK_BATCH)
    return {name: _Check(f"zoo {name}", {"depth": name, "camera": "PoseNetImproved"}, keys,
                         {k: v.numpy() for k, v in feats.items()}, loss, _set_pose_twist)
            for name in ZOO_BACKBONES}


def _zoo_step(nets, keys, recipe, stereo, batches, counts, zero_counts, device, steps,
              **kwargs):
    """One bfloat16 train step's build and measure (phase 29): the model
    (``ModelFactory`` on the card, ``remat_backbone`` among ``kwargs``), 2
    warm-up steps, then ``steps`` steps each timed by CUDA events, with
    the launches counted from zero over all of them. Returns
    {seconds to build and warm up, ms per step between the events (median),
    images/s,
    peak bytes, the launches, the launches per step, the last loss}."""
    import torch

    from xpt_mde_tpu_torch.config import AUGMENT_PROBS, SCALE_WEIGHT_T1
    from xpt_mde_tpu_torch.losses import loss_factory
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.training import (augmentation_factory, make_train_step,
                                            optimizer_factory)

    remat = kwargs.pop("remat_backbone", False)
    frozen = kwargs.get("frozen_nets", [])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ModelFactory(keys, nets, stereo=stereo, compute_dtype="bfloat16", device=device,
                         seed=0, remat_backbone=remat).get_model()
    loss = loss_factory(keys, recipe, SCALE_WEIGHT_T1, stereo=stereo, batch_size=BATCH)
    train = make_train_step(model, loss, optimizer_factory("adam_constant", LR, model,
                                                           frozen_nets=frozen),
                            augmenter=augmentation_factory(AUGMENT_PROBS), **kwargs)
    generator = torch.Generator().manual_seed(0)
    zero_counts()
    for i in range(2):
        train(batches[i % len(batches)], generator)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    t0 = time.perf_counter()
    for i, (start, end) in enumerate(events):
        start.record()
        metrics = train(batches[i % len(batches)], generator)
        end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    loss_value = float(metrics["loss"])
    if not all(bool(torch.isfinite(v).all()) for v in metrics.values()):
        raise AssertionError(f"{nets} {recipe}: non-finite metrics")
    elapsed_ms = sorted(start.elapsed_time(end) for start, end in events)[steps // 2]
    out = {"build_s": build_s, "elapsed_ms": elapsed_ms, "images_s": steps * BATCH / wall,
           "peak": torch.cuda.max_memory_allocated(), "launches": launches,
           "per_step": {k: v / (steps + 2) for k, v in launches.items() if v},
           "loss": loss_value}
    del model, train, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _zoo_phase(device, counts, zero_counts, kstats, tag):
    """Phase 29, the model zoo at full width (batch 8, 128x512, bfloat16,
    default augmentation, SCALE_WEIGHT_T1, Adam 1e-4): each backbone of
    ZOO_BACKBONES as the depth net with PoseNetImproved in the rigid step
    (RECIPE): build and warm-up seconds, the ms a step between CUDA events
    around it, images/s, peak memory, K1 and K1-bwd launches a step (4
    and 4), phase 2's K1 and K1-bwd ms a step over the step's elapsed ms
    (at most their share of the device's busy time), a finite loss; then,
    at ZOO_CHECK_SIZE on images in [0, 255], the backbone alone on the
    card against the CPU and float64 (``_backbone_cross_check``), one
    float32 step's losses, loss gradient and BN statistics against the
    CPU's (``_step_cross_check``) and the bfloat16 step against float32 on
    both (``_bf16_cross_check``); before them, NASNet's pool on a
    channels-last tensor (``_pool_layout_check``). Then
    one bfloat16 step each: PoseNetDeep, PoseNetPreTrained (MobileNetV2),
    the stereo step under LOSS_RIGID_MD2 and under
    LOSS_RIGID_MOA_WST, the joint step under MD2CMB_RECIPE (K2-bf16 5 a
    step), ``grad_accum_steps=2`` (twice the K1 launches of one batch),
    and NASNetLarge with ``remat_backbone`` (the peak memory below the
    backbone loop's NASNetLarge step's). The cross-checks' CPU runs come
    from ``_CPU_RUNS``; the float32 step is held without a float64 one
    (the backbone alone holds the gradients in float64). Returns (every
    launch of the phase, a summary)."""
    import torch

    from xpt_mde_tpu_torch.config import (JOINT_NET, LOSS_RIGID_MD2, LOSS_RIGID_MOA_WST,
                                          RIGID_NET)
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.tools.profile_steps import STEREO_KEYS, uint8_coded

    keys = ["image", "intrinsic", "depth_gt", "pose_gt"]
    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                               num_batches=2, stereo=True, seed=29)
    stereo_batches = [uint8_coded({k: torch.from_numpy(v).to(device) for k, v in b.items()})
                      for b in dataset]
    mono_batches = [{k: v for k, v in b.items() if not k.endswith("_R") and k != "stereo_T_LR"}
                    for b in stereo_batches]
    checks = _zoo_checks()
    k1_ms = kstats["K1"]["ms"] + kstats["K1-bwd"]["ms"]
    total = dict.fromkeys(counts(), 0)

    def add(result):
        for k, v in result["launches"].items():
            total[k] += v

    print(f"phase 29 zoo: NASNet's count-excluding pool on a channels-last tensor, card vs "
          f"CPU, relative to the largest value: {_pool_layout_check(device)}", flush=True)
    rows = []
    for name in ZOO_BACKBONES:
        nets = {"depth": name, "camera": "PoseNetImproved"}
        r = _zoo_step(nets, keys, RECIPE, False, mono_batches, counts, zero_counts, device,
                      ZOO_TIMED_STEPS)
        add(r)
        if r["per_step"] != {"K1": 4, "K1-bwd": 4}:
            raise AssertionError(f"{name}: launches per step {r['per_step']}")
        print(f"timing zoo bf16 rigid train {name}+PoseNetImproved batch {BATCH} "
              f"{HEIGHT}x{WIDTH}: build and 2 warm-up steps {r['build_s']:.1f} s, elapsed "
              f"{r['elapsed_ms']:.2f} ms/step (CUDA events around each step, median of "
              f"{ZOO_TIMED_STEPS}), {r['images_s']:.2f} images/s, max_memory_allocated "
              f"{r['peak'] / 2**30:.3f} GiB, launches per step {json.dumps(r['per_step'])}, "
              f"K1+K1-bwd {100 * k1_ms / r['elapsed_ms']:.2f}% of the elapsed time (at most "
              f"their share of the device's busy time), loss {r['loss']:.6f} {tag}", flush=True)
        rows.append((name, r))
        t0 = time.perf_counter()
        print(f"phase 29 zoo {_backbone_cross_check(checks[name], device)}", flush=True)
        _, _, f32_runs = _step_cross_check(29, checks[name], device, ("depth_ms", "pose"),
                                           LOSS_TOL, float64=False)
        bf16 = _bf16_cross_check(checks[name], device, f32_runs=f32_runs)
        print(f"phase 29 zoo bf16 cross-check (card bf16 vs card float32 held to CPU bf16 vs "
              f"CPU float32, ratios {BF16_MEDIAN_RATIO}/{BF16_MAX_RATIO}): {bf16}", flush=True)
        print(f"phase 29 zoo {name} cross-checks took {time.perf_counter() - t0:.1f} s",
              flush=True)

    stereo_keys = STEREO_KEYS
    cases = [  # (label, nets, keys, stereo, recipe, batches, step kwargs, launches per step)
        ("PoseNetDeep", dict(RIGID_NET, camera="PoseNetDeep"), keys, False, RECIPE,
         mono_batches, {}, {"K1": 4, "K1-bwd": 4}),
        ("PoseNetPreTrained(MobileNetV2)", dict(RIGID_NET, camera="MobileNetV2"), keys, False,
         RECIPE, mono_batches, {}, {"K1": 4, "K1-bwd": 4}),
        ("stereo LOSS_RIGID_MD2", RIGID_NET, stereo_keys, True, LOSS_RIGID_MD2,
         stereo_batches, {}, {"K1": 16, "K1-bwd": 16}),
        ("stereo LOSS_RIGID_MOA_WST", RIGID_NET, stereo_keys, True, LOSS_RIGID_MOA_WST,
         stereo_batches, {}, {"K1": 16, "K1-bwd": 16}),
        ("joint md2cmb", JOINT_NET, keys, False, MD2CMB_RECIPE, mono_batches,
         {"frozen_nets": ["flownet"]}, {"K1": 8, "K1-bwd": 4, "K2-bf16": 5}),
        ("grad_accum_steps=2", RIGID_NET, keys, False, RECIPE, mono_batches,
         {"grad_accum_steps": 2}, {"K1": 8, "K1-bwd": 8}),
        ("NASNetLarge remat_backbone", {"depth": "NASNetLarge", "camera": "PoseNetImproved"},
         keys, False, RECIPE, mono_batches, {"remat_backbone": True}, {"K1": 4, "K1-bwd": 4})]
    extra = {}
    for label, nets, net_keys, stereo, recipe, batches, kwargs, launches in cases:
        r = _zoo_step(nets, net_keys, recipe, stereo, batches, counts, zero_counts, device, 2,
                      **kwargs)
        add(r)
        per_step = {k: round(v) for k, v in r["per_step"].items()}
        if per_step != launches:
            raise AssertionError(f"zoo {label}: launches per step {r['per_step']}, "
                                 f"want {launches}")
        extra[label] = r
        print(f"timing zoo bf16 {label} ({'+'.join(nets.values())}, batch {BATCH} "
              f"{HEIGHT}x{WIDTH}): elapsed {r['elapsed_ms']:.2f} ms/step, {r['images_s']:.2f} "
              f"images/s, max_memory_allocated {r['peak'] / 2**30:.3f} GiB, launches per step "
              f"{json.dumps(per_step)}, loss {r['loss']:.6f} {tag}", flush=True)
    # the plain NASNetLarge step is the backbone loop's, the same step
    plain, remat = dict(rows)["NASNetLarge"]["peak"], extra["NASNetLarge remat_backbone"]["peak"]
    if not remat < plain:
        raise AssertionError(f"NASNetLarge peak with remat {remat} not below {plain}")
    summary = (f"{len(rows)} backbones at batch {BATCH} {HEIGHT}x{WIDTH} bf16, elapsed ms/step "
               + ", ".join(f"{n} {r['elapsed_ms']:.2f}" for n, r in rows)
               + f"; NASNetLarge peak {plain / 2**30:.3f} GiB, with remat_backbone "
               f"{remat / 2**30:.3f} GiB ({remat / plain:.3f}x); grad_accum_steps=2 K1 "
               f"{extra['grad_accum_steps=2']['per_step']['K1']:g} a step; md2cmb joint K2-bf16 "
               f"{extra['joint md2cmb']['per_step']['K2-bf16']:g} a step")
    return total, summary


TRAIN_MAIN_DRIVER = """
import json, os, sys
import torch
from xpt_mde_tpu_torch.config import (RIGID_NET, SCALE_WEIGHT_T1, Config, TestStage,
                                      TrainStage)
from xpt_mde_tpu_torch.parallel import initialize, make_mesh
from xpt_mde_tpu_torch.parallel.multihost import local_device
from xpt_mde_tpu_torch.scripts import train_main
from xpt_mde_tpu_torch.tools.check_learns import kernel_launches
from xpt_mde_tpu_torch.tools.ddp_check import rank_steps

root, world, rank = sys.argv[1], int(sys.argv[2]), os.environ["RANK"]
cfg = Config(stereo=False, per_replica_batch=8 // world, mesh_shape={"data": world},
             datapath=root, ckpt_name="dp", pretrained_weight=False,
             training_plan=[TrainStage(RIGID_NET, "synthetic", 1, 1e-4,
                                       json.loads(sys.argv[3]), SCALE_WEIGHT_T1)],
             test_plan=[TestStage(RIGID_NET, "synthetic", ["depth", "pose"], "dp")])
# the step cases over this group first; train_main then joins it and ends it
initialize(local_device())
spec = torch.load(f"{root}/cases.pt", weights_only=False)
torch.save(rank_steps(make_mesh(cfg.mesh_shape), spec["cases"], spec["steps"]),
           f"{root}/steps_rank{rank}.pt")
before = kernel_launches()
train_main.main(cfg)
after = kernel_launches()
with open(f"{root}/launches_rank{rank}.json", "w") as f:
    json.dump({k: after[k] - before[k] for k in after}, f)
"""


def _under_torchrun(cases: list, steps: list, tag) -> tuple[list, dict, str]:
    """Phase 30 (a): one process a card under torchrun over NCCL: the step
    cases (``ddp_check.rank_steps``), then ``train_main`` on a one-row
    rigid plan and its predictions. Returns (each case's results in rank
    order, rank 0's plan launches, a summary)."""
    import torch

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(dir=_build_dir()) as root:
        write_synthetic_shards(Path(root) / "shards", HEIGHT, WIDTH,
                               {"train": 16, "val": 8, "test": 8})
        torch.save({"cases": cases, "steps": steps}, Path(root) / "cases.pt")
        driver = Path(root) / "driver.py"
        driver.write_text(TRAIN_MAIN_DRIVER)
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               f"--nproc_per_node={world}", str(driver), root, str(world),
                               json.dumps(RECIPE)],
                              env=env, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"torchrun failed:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        ckpt = Path(root) / "checkpts" / "dp"
        history = (ckpt / "history.csv").read_text().strip().splitlines()
        if len(history) != 2 or not (ckpt / "depthnet_ep01.pt").exists():
            raise AssertionError(f"train_main wrote history {history}")
        if not (Path(root) / "prediction" / "dp" / "synthetic_latest.npz").exists():
            raise AssertionError("train_main's predict_by_plan wrote no predictions")
        launches = [json.loads((Path(root) / f"launches_rank{r}.json").read_text())
                    for r in range(world)]
        ranks = [torch.load(Path(root) / f"steps_rank{r}.pt", weights_only=False)
                 for r in range(world)]
    if any(r["K1"] == 0 or r["K1-bwd"] == 0 for r in launches):
        raise AssertionError(f"the ranks' plan never launched K1 and K1-bwd: {launches}")
    return ([[results[i] for results in ranks] for i in range(len(cases))], launches[0],
            f"torchrun --standalone --nproc_per_node={world} over NCCL: the step cases, then "
            f"train_main on one rigid row of 2 steps at batch 8 {HEIGHT}x{WIDTH} bf16 "
            f"(history.csv {history[1].split(',')[:2]}) and predict on rank 0; {seconds:.1f} s "
            f"for the command; the plan's launches in rank 0 {json.dumps(launches[0])} {tag}")


def _ddp_phase(device, tag) -> tuple[dict, str]:
    """Phase 30: returns ({path: each kernel's launches in rank 0}, a
    summary)."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.config import FLOW_NET, JOINT_NET, RIGID_NET
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.tools import ddp_check, spatial_check
    from xpt_mde_tpu_torch.tools.profile_steps import uint8_coded

    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH, num_batches=1,
                               seed=31)
    keys = dataset.config_keys()
    batch = {k: v.numpy() for k, v in uint8_coded(
        {k: torch.from_numpy(v) for k, v in next(iter(dataset)).items()}).items()}

    def case(nets, recipe, prepare, dtype, **options):
        model = ModelFactory(keys, nets, stereo=False, device=device).get_model()
        prepare(model, device)
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model
        return ddp_check.StepCase(nets, keys, recipe, batch, state=state, lr=LR,
                                  compute_dtype=dtype, **options)

    flow = {"regularize_net": "flownet"}
    joint = {"frozen_nets": ("flownet",)}
    cases = {"rigid float32": case(RIGID_NET, RECIPE, _set_pose_twist, "float32"),
             "flow float32": case(FLOW_NET, FLOW_RECIPE, _set_flow_heads, "float32", **flow),
             "rigid bf16": case(RIGID_NET, RECIPE, _set_pose_twist, "bfloat16"),
             "flow bf16": case(FLOW_NET, FLOW_RECIPE, _set_flow_heads, "bfloat16", **flow)}
    # the joint step (the flownet frozen) runs one process and the spatial
    # mesh only (tests/test_torch_parallel_joint.py holds its data-parallel
    # step)
    joint_cases = {f"joint {dtype}": case(JOINT_NET, JOINT_RECIPE, _set_pose_and_flow_heads,
                                          "float32" if dtype == "float32" else "bfloat16",
                                          **joint)
                   for dtype in ("float32", "bf16")}
    # the height-sharded mesh (two bands of each sample's rows), on the gloo
    # ranks only: the same weights and batch (BATCH snippets of HEIGHT x
    # WIDTH) as the one-process cases
    spatial = {f"{name} spatial": dataclasses.replace((cases | joint_cases)[name],
                                                      mesh_shape=SPATIAL_MESH)
               for name in ("rigid float32", "rigid bf16", "flow float32", "flow bf16",
                            "joint float32", "joint bf16")}
    # float32: one checked step; bfloat16: a warm-up step, then the timed ones
    steps = [1 if "float32" in name else DDP_TIMED_STEPS + 1 for name in cases]
    singles = {name: ddp_check.single_step(c, device) if "float32" in name
               else _single_step_ms(c, device) for name, c in (cases | joint_cases).items()}
    # the bf16 spatial steps' rule: their one-process bf16 step (the timed
    # one-process run's first step) and that step's distance from the
    # one-process float32 step, by stage
    bf16_singles = {stage: singles[f"{stage} bf16"]["first"]
                    for stage in ("rigid", "flow", "joint")}
    bf16_scales = {stage: ddp_check.compare(singles[f"{stage} float32"], [single])
                   for stage, single in bf16_singles.items()}
    torch.cuda.empty_cache()

    launches_by_path, notes = {}, []
    t0 = time.perf_counter()
    nccl, plan_launches, note = _under_torchrun(list(cases.values()), steps, tag)
    launches_by_path["data parallel train_main (rank 0, the plan)"] = plan_launches
    notes.append(note)
    runs = {"nccl": (torch.cuda.device_count(), nccl, time.perf_counter() - t0, cases)}
    t0 = time.perf_counter()
    gloo_cases = cases | spatial
    # in the same two ranks: the steps, then the spatial mesh's map modules
    # in bf16
    tasks = [(ddp_check.rank_steps, (list(gloo_cases.values()), steps + [
        1 if "float32" in name else SPATIAL_TIMED_STEPS + 1 for name in spatial])),
             (spatial_check.rank_modules, (list(spatial_check.MAP_CASES), 0, torch.bfloat16))]
    ranks = ddp_check.run_ranks(ddp_check.rank_tasks, (tasks,), 2, "cuda", "gloo",
                                workdir=_build_dir())
    gloo = [[rank[0][i] for rank in ranks] for i in range(len(gloo_cases))]
    runs["gloo"] = (2, gloo, time.perf_counter() - t0, gloo_cases)
    notes.append(_band_modules_note(ranks[0][1], tag))
    for name in spatial:
        results = gloo[list(gloo_cases).index(name)]
        stage = name.split()[0]
        notes.append(_spatial_note(name, results, singles[f"{stage} float32"],
                                   bf16_singles[stage], bf16_scales[stage], tag,
                                   spatial[name].state))
    for backend, (world, results, seconds, run_cases) in runs.items():
        for (name, c), ranks in zip(run_cases.items(), results):
            if name in spatial:
                launches_by_path[f"data parallel {name} {backend} x{world} (rank 0, a step)"] = \
                    ranks[0]["launches"]
                continue
            launches_by_path[f"data parallel {name} {backend} x{world} (rank 0, a step)"] = \
                ranks[0]["launches"]
            if "float32" in name:
                d = ddp_check.compare(singles[name], ranks)
                notes.append(f"{name} step, {world} rank(s) over {backend} vs one process: "
                             + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in d.items()))
                if not ddp_check.within_tolerance(d):
                    raise AssertionError(f"{name} over {backend}: {d}")
            else:
                ms = [1e3 * t for t, _ in ranks[0]["timed"]]
                reduce = [r for _, r in ranks[0]["timed"]]
                notes.append(
                    f"timing {name} step batch {BATCH} global {HEIGHT}x{WIDTH}, {world} rank(s) "
                    f"over {backend}: {np.median(ms):.2f} ms a step (median of "
                    f"{len(ms)}, host clock around a synchronize, rank 0), gradient all-reduce "
                    f"{np.median(reduce):.2f} ms ({100 * np.median(reduce) / np.median(ms):.1f}%"
                    f" of the step); one process {singles[name]['ms']:.2f} ms; launches a step "
                    f"{json.dumps({k: v for k, v in ranks[0]['launches'].items() if v})} {tag}")
        notes.append(f"{backend} ranks' command took {seconds:.1f} s")
    return launches_by_path, "\n".join(f"phase 30 {n}" for n in notes)


def _band_modules_note(results, tag) -> str:
    """Phase 30's check of the spatial mesh's map modules in bf16 on the
    card (``spatial_check.rank_modules`` in the two gloo ranks): each
    module's output and gradients from its bands within
    ``spatial_check.BF16_RTOL`` of the whole map's."""
    from xpt_mde_tpu_torch.tools import spatial_check

    worst = {name: max(spatial_check.errors(case).values()) for name, case in results.items()}
    bad = {name: err for name, err in worst.items() if not err <= spatial_check.BF16_RTOL}
    if bad:
        raise AssertionError(f"bf16 band modules past {spatial_check.BF16_RTOL}: {bad}")
    name = max(worst, key=worst.get)
    return (f"bf16 band modules on the card ({len(worst)}: convolutions k1-k5 s1-s2, "
            f"depthwise, BatchNorm, squeeze-excite, resizes, pools; PWC-Net's transposed and "
            f"dilated convs, cost volumes on both routes (K2-K4-bf16), feature warp, flow "
            f"coordinates; 2 gloo ranks), bands vs the whole map, forward and backward: worst "
            f"{worst[name]:.3g} of the largest value ({name}) <= "
            f"{spatial_check.BF16_RTOL:.3g}; each: "
            + ", ".join(f"{n} {e:.3g}" for n, e in worst.items()) + f" {tag}")


def _spatial_note(name, ranks, single_f32, single_bf16, bf16_scale, tag, state) -> str:
    """Phase 30's check of a step on the spatial mesh (SPATIAL_MESH, two
    gloo ranks on the card): every rank launched K1 and K1-bwd on its band,
    in a flow step the cost volume's kernels (their bf16 forms in bf16)
    SPATIAL_FLOW_LAUNCHES times each, and a joint step each kernel as
    SPATIAL_JOINT_LAUNCHES says, its flownet (``state``'s, the case's
    initial weights) bit-unchanged on every rank; float32 within
    ``ddp_check.within_tolerance`` of the one-process step, the parameters
    by its spatial rule (a joint step by its joint rule too); bf16: the
    loss within SPATIAL_BF16_RATIO times the one-process bf16 step's own
    distance from the one-process float32 step, at least 2^-8 of the loss
    (one bf16 ulp), with equal replicas and the entries without a gradient
    bit-equal (its gradients are read, not held: see SPATIAL_BF16_RATIO);
    the timed steps' spatial collectives: bytes a step and share of it."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.tools import ddp_check

    bf16 = "float32" not in name
    corr = [f"K{i}{'-bf16' if bf16 else ''}" for i in (2, 3, 4)]
    for rank in ranks:
        if not (rank["launches"]["K1"] and rank["launches"]["K1-bwd"]):
            raise AssertionError(f"{name}: rank {rank['rank']} launched no K1 or K1-bwd on "
                                 f"its band: {rank['launches']}")
        if name.startswith("flow") and any(rank["launches"][k] != SPATIAL_FLOW_LAUNCHES
                                           for k in corr):
            raise AssertionError(f"{name}: rank {rank['rank']} launched {corr} "
                                 f"{[rank['launches'][k] for k in corr]} times, not "
                                 f"{SPATIAL_FLOW_LAUNCHES}: {rank['launches']}")
        if name.startswith("joint"):
            want = dict.fromkeys(rank["launches"], 0) | {
                k: SPATIAL_JOINT_LAUNCHES[k.removesuffix("-bf16")] for k in ("K1", "K1-bwd", *corr)}
            if rank["launches"] != want:
                raise AssertionError(f"{name}: rank {rank['rank']} launched "
                                     f"{rank['launches']}, not {want}")
            changed = [k for k in state if k.startswith("flownet.")
                       and not torch.equal(rank["state"][k], state[k])]
            if changed:
                raise AssertionError(f"{name}: rank {rank['rank']} changed the frozen "
                                     f"flownet: {changed[:5]}")
    if not bf16:
        d = ddp_check.compare(single_f32, ranks)
        rule = ddp_check.within_tolerance(d, spatial=True, joint=name.startswith("joint"))
        text = (f"{name} step, 2 gloo ranks on one card vs one process: "
                + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in d.items()))
    else:
        d = ddp_check.compare(single_bf16, ranks)
        limit = max(SPATIAL_BF16_RATIO * bf16_scale["loss"], 2.0 ** -8)
        rule = (d["loss"] <= limit and d["replicas"] == 0.0 and d["frozen"] == 0.0
                and d["metrics_equal_across_ranks"])
        text = (f"{name} step, 2 gloo ranks on one card vs the one-process bf16 step: loss "
                f"{d['loss']:.3g} (limit {limit:.3g}); read, not held: grad_median "
                f"{d['grad_median']:.3g}, grad {d['grad']:.3g}; the one-process bf16 step vs "
                f"float32: loss {bf16_scale['loss']:.3g}, grad_median "
                f"{bf16_scale['grad_median']:.3g}")
    if not rule:
        raise AssertionError(f"{text}: {d}")
    band = ranks[0]["band"]
    launches = [json.dumps({k: v for k, v in rank["launches"].items() if v}) for rank in ranks]
    text += (f"; rank 0's spatial collectives a step: halo {band['halo_bytes'] / 1e6:.2f} MB, "
             f"gather {band['gather_bytes'] / 1e6:.2f} MB, resizes' gathers "
             f"{band['resize_bytes'] / 1e6:.2f} MB, sums {band['sum_bytes'] / 1e3:.1f} kB "
             f"in {band['calls']} all-reduces; launches by rank {'; '.join(launches)}; rank 0's "
             f"first step {ranks[0]['seconds']:.2f} s, the case {ranks[0]['wall']:.1f} s")
    if ranks[0]["timed"]:
        ms = [1e3 * t for t, _ in ranks[0]["timed"]]
        share = [b["seconds"] * 1e3 / m for b, m in zip(ranks[0]["timed_band"], ms)]
        text += (f"; timing: {np.median(ms):.2f} ms a step (median of {len(ms)}, host clock "
                 f"around a synchronize, rank 0, each spatial all-reduce between two device "
                 f"synchronizes), spatial collectives {100 * np.median(share):.1f}% of the step, "
                 f"gradient all-reduce {np.median([r for _, r in ranks[0]['timed']]):.2f} ms")
    return text + f" {tag}"


def _single_step_ms(case, device) -> dict:
    """``ms``: the median ms of DDP_TIMED_STEPS one-process steps of
    ``case`` after a warm-up one (host clock around a synchronize, as the
    ranks time); ``first``: the warm-up step's result, as
    ``ddp_check.single_step`` gives it."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.tools.ddp_check import _build, _generator, _result
    from xpt_mde_tpu_torch.training import make_train_step
    from xpt_mde_tpu_torch.training.train_step import features_to_device

    model, loss, optimizer, augmenter = _build(case, device)
    step = make_train_step(model, loss, optimizer, augmenter=augmenter,
                           frozen_nets=case.frozen_nets, regularize_net=case.regularize_net)
    features = features_to_device(case.batch, device)
    times, first = [], None
    for _ in range(DDP_TIMED_STEPS + 1):
        t0 = time.perf_counter()
        metrics = step(features, _generator(case))
        torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0))
        if first is None:
            first = _result(model, metrics, times[0] / 1e3, draws=[])
    return {"ms": float(np.median(times[1:])), "first": first}


SERVING_CHECK = """
import json, sys, time
for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu", "xpt_mde_tpu_torch.models",
             "xpt_mde_tpu_torch.training"):
    sys.modules[name] = None
import torch
from xpt_mde_tpu_torch.ops.kernels.correlation import kernels_for
from xpt_mde_tpu_torch.serving import load_predictor

kernels = [*kernels_for(torch.float32), *kernels_for(torch.bfloat16)]
cases = torch.load(sys.argv[1], weights_only=False)
out = {}
for name, case in cases.items():
    t0 = time.perf_counter()
    predictor = load_predictor(case["dir"])
    load_s = time.perf_counter() - t0
    inputs = {k: v.cuda() for k, v in case["inputs"].items()}
    for k in kernels:
        k.launches = 0
    got = predictor(inputs)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels if k.launches}
    errs = {}
    for key, want in case["want"].items():
        pairs = zip(got[key], want) if isinstance(want, list) else [(got[key], want)]
        errs[key] = max(float((g.float().cpu() - w.float()).abs().max()
                              / w.float().abs().max().clamp_min(1e-12)) for g, w in pairs)
    bad = {k: v[:, :, :-8] for k, v in inputs.items()}
    try:
        predictor(bad)
        raised = False
    except ValueError:
        raised = True
    for _ in range(3):
        predictor(inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(case["calls"]):
        predictor(inputs)
    torch.cuda.synchronize()
    rate = case["calls"] * case["batch"] / (time.perf_counter() - t0)
    out[name] = {"load_s": load_s, "launches": launches, "rel_err": errs,
                 "wrong_shape_raises": raised, "images_s": rate}
assert all(sys.modules.get(m) is None for m in ("jax", "xpt_mde_tpu", "xpt_mde_tpu_torch.models"))
print("SERVING " + json.dumps(out))
"""


def _serving_phase(device, tag) -> tuple[dict, str]:
    """Phase 31: returns ({artifact: launches a call}, a summary)."""
    import torch

    from xpt_mde_tpu_torch.config import FLOW_NET, RIGID_NET
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.serving import export_predictor
    from xpt_mde_tpu_torch.tools.profile_steps import uint8_coded
    from xpt_mde_tpu_torch.training import make_predict_step

    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH, num_batches=1,
                               seed=32)
    keys = dataset.config_keys()
    image = uint8_coded({"image5d": torch.from_numpy(next(iter(dataset))["image5d"])})
    inputs = {"image5d": image["image5d"].to(device)}
    cases, notes = {}, []
    with tempfile.TemporaryDirectory(dir=_build_dir()) as root:
        for name, nets, dtype in (("rigid bf16", RIGID_NET, "bfloat16"),
                                  ("flow bf16", FLOW_NET, "bfloat16"),
                                  ("flow float32", FLOW_NET, "float32")):
            model = ModelFactory(keys, nets, stereo=False, compute_dtype=dtype,
                                 device=device).get_model()
            predict = make_predict_step(model)
            want = predict(inputs)
            live_rate = BATCH * SERVE_TIMED_CALLS / (
                _event_ms(lambda: predict(inputs), SERVE_TIMED_CALLS) * SERVE_TIMED_CALLS / 1e3)
            t0 = time.perf_counter()
            out = export_predictor(model, inputs, Path(root) / name.replace(" ", "_"))
            export_s = time.perf_counter() - t0
            size = sum(p.stat().st_size for p in out.iterdir())
            cases[name] = {"dir": str(out), "inputs": {k: v.cpu() for k, v in inputs.items()},
                           "want": {k: [t.cpu() for t in v] if isinstance(v, list) else v.cpu()
                                    for k, v in want.items() if k != "debug_out"},
                           "batch": BATCH, "calls": SERVE_TIMED_CALLS, "dtype": dtype,
                           "export_s": export_s, "bytes": size, "live_images_s": live_rate}
            del model, predict, want
            torch.cuda.empty_cache()
        spec = Path(root) / "cases.pt"
        torch.save(cases, spec)
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
        proc = subprocess.run([sys.executable, "-c", SERVING_CHECK, str(spec)], env=env,
                              capture_output=True, text=True, timeout=600)
    line = [x for x in proc.stdout.splitlines() if x.startswith("SERVING ")]
    if proc.returncode != 0 or not line:
        raise RuntimeError(f"the artifacts' check failed:\n{proc.stderr[-3000:]}")
    results = json.loads(line[0][len("SERVING "):])
    per_call = {}
    for name, r in results.items():
        c = cases[name]
        rtol = SERVE_RTOL[c["dtype"]]
        notes.append(
            f"{name} artifact (batch {BATCH} uint8 {HEIGHT}x{WIDTH}): exported in "
            f"{c['export_s']:.1f} s, {c['bytes']} bytes, loaded in {r['load_s']:.1f} s in an "
            f"interpreter without JAX or the model code; largest difference from the live "
            f"predict step over the largest value {json.dumps(r['rel_err'])} <= {rtol}; "
            f"launches a call {json.dumps(r['launches'])}; wrong shape raises ValueError "
            f"{r['wrong_shape_raises']}; {r['images_s']:.1f} images/s (live predict step "
            f"{c['live_images_s']:.1f}) {tag}")
        if max(r["rel_err"].values()) > rtol or not r["wrong_shape_raises"]:
            raise AssertionError(f"{name} artifact: {r}")
        kernel = {"flow bf16": "K2-bf16", "flow float32": "K2"}.get(name)
        if kernel is not None and r["launches"].get(kernel, 0) <= 0:
            raise AssertionError(f"{name} artifact never launched {kernel}: {r['launches']}")
        per_call[f"serving {name} artifact (a call)"] = r["launches"]
    return per_call, "\n".join(f"phase 31 {n}" for n in notes)


def _timed_rounds(step, step_batches, rounds, steps):
    """Images/s of ``rounds`` rounds of ``steps`` steps each (host clock
    around a synchronize), sorted, and the peak memory over them."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for i in range(steps):
            step(step_batches[i % len(step_batches)])
        torch.cuda.synchronize()
        rates.append(steps * BATCH / (time.perf_counter() - t0))
    return sorted(rates), torch.cuda.max_memory_allocated()


def _valid_terms(height, width, max_displacement, stride):
    """The (pixel, displacement) pairs of one [height, width] plane whose
    displaced position lies in the frame: the terms K2, K3 and K4 compute
    (they skip the others)."""
    offsets = range(-max_displacement, max_displacement + 1, stride)
    return (sum(max(0, height - abs(o)) for o in offsets)
            * sum(max(0, width - abs(o)) for o in offsets))


def bf16_ulp_excess(got, ref) -> tuple[float, float]:
    """(max |got - ref|, the largest of |got - ref| / (one bfloat16 ulp of
    ref + BF16_CORR_ATOL x max |ref|)): the second is at most 1 where the
    kernel holds the bfloat16 rule."""
    import torch
    got, ref = got.double(), ref.double()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126))) - 7)
    diff = (got - ref).abs()
    bound = ulp + BF16_CORR_ATOL * float(ref.abs().max())
    return float(diff.max()), float((diff / bound).max())


def _corr_phase(device, tag, dtype=None, f32=None, earlier=None, size=None, phase_no=None):
    """Phase 8 (float32, the default) or 21 (``dtype`` bfloat16): K2, K3
    and K4 of that dtype against their plain versions at the five PWC-Net
    levels of the flow stage (float32 within CORR_RTOL of the largest plain
    value; bfloat16 within one ulp, ``bf16_ulp_excess``), and their times
    beside the plain versions' and the bounds (and, given ``f32``, phase
    8's stats, beside the float32 kernels' per level; given ``earlier``,
    an earlier checkout's ms per level by kernel name, beside those).
    ``size``: the frame whose levels to take, (HEIGHT, WIDTH) by default;
    with ``phase_no`` the bfloat16 edge shapes are left to phase 21.
    Returns per-kernel sums over the levels (one train step's launches) and
    each level's ms."""
    import torch

    from xpt_mde_tpu_torch.config import NUM_SRC
    from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
    from xpt_mde_tpu_torch.ops.correlation import (correlation_channels,
                                                   correlation_cost_plain,
                                                   correlation_grad_cl_plain,
                                                   correlation_grad_cr_plain)
    from xpt_mde_tpu_torch.ops.kernels.correlation import kernels_for

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    height, width = size or (HEIGHT, WIDTH)
    K2, K3, K4 = kernels_for(dtype)
    keys = ("err", "ulps", "ms", "plain_ms", "bound_ms", "bytes", "flops")
    stats = {name: dict.fromkeys(keys, 0.0) | {"levels": {}} for name in ("K2", "K3", "K4")}
    notes = []
    generator = torch.Generator().manual_seed(2)
    pairs = BATCH * NUM_SRC
    for level in (6, 5, 4, 3, 2):
        md, stride = level_displacement(level)
        chans, h, w = ENCODER_CHANNELS[level - 1], height >> level, width >> level
        n2 = correlation_channels(md, stride)
        cl, cr = ((torch.rand((pairs, chans, h, w), generator=generator) * 2 - 1).to(
            device, dtype) for _ in range(2))
        g = (torch.rand((pairs, n2, h, w), generator=generator) * 2 - 1).to(device, dtype)
        got = {"K2": K2(cl, cr, md, stride), "K3": K3(g, cr, md, stride),
               "K4": K4(g, cl, md, stride)}
        ref = {"K2": correlation_cost_plain(cl, cr, md, stride),
               "K3": correlation_grad_cl_plain(g, cr, md, stride),
               "K4": correlation_grad_cr_plain(g, cl, md, stride)}
        leaves = [cl.clone().requires_grad_(True), cr.clone().requires_grad_(True)]
        autograd = dict(zip(("K3", "K4"), torch.autograd.grad(
            correlation_cost_plain(*leaves, md, stride), leaves, g)))
        torch.cuda.synchronize()
        for name in ("K2", "K3", "K4"):
            if got[name].dtype != dtype:
                raise AssertionError(f"{name} gave {got[name].dtype}, want {dtype}")
            scale = float(ref[name].abs().max())
            if bf16:
                err, ulps = bf16_ulp_excess(got[name], ref[name])
                if name in autograd:
                    err_a, ulps_a = bf16_ulp_excess(got[name], autograd[name])
                    err, ulps = max(err, err_a), max(ulps, ulps_a)
                if not ulps <= 1.0:
                    raise AssertionError(f"{name}-bf16 differs from plain by {ulps:.3g} of its "
                                         f"bound (1 ulp + {BF16_CORR_ATOL} x max) at level "
                                         f"{level}")
                stats[name]["ulps"] = max(stats[name]["ulps"], ulps)
                notes.append(f"L{level} {name} {err:.3g} ({ulps:.3g} of the bound)")
            else:
                err = float((got[name] - ref[name]).abs().max())
                if name in autograd:
                    err = max(err, float((got[name] - autograd[name]).abs().max()))
                if not err <= CORR_RTOL * scale:
                    raise AssertionError(f"{name} differs from plain by {err} (max |plain| "
                                         f"{scale}) at level {level}")
                notes.append(f"L{level} {name} {err:.3g} / {scale:.3g}")
            stats[name]["err"] = max(stats[name]["err"], err)

        # bytes: each input read once, each output written once, where K3
        # and K4 need g only at the in-frame (pixel, displacement) terms (the
        # others meet the frame's outside) and K2 writes every plane; flops:
        # a multiply-add per channel for every in-frame term
        terms = pairs * _valid_terms(h, w, md, stride)
        feat_bytes, g_bytes = cl.numel() * cl.element_size(), g.numel() * g.element_size()
        g_used, flops = terms * g.element_size(), 2 * chans * terms
        work = {"K2": (2 * feat_bytes + g_bytes, flops),
                "K3": (g_used + 2 * feat_bytes, flops), "K4": (g_used + 2 * feat_bytes, flops)}
        runs = {"K2": (lambda: K2(cl, cr, md, stride),
                       lambda: correlation_cost_plain(cl, cr, md, stride)),
                "K3": (lambda: K3(g, cr, md, stride),
                       lambda: correlation_grad_cl_plain(g, cr, md, stride)),
                "K4": (lambda: K4(g, cl, md, stride),
                       lambda: correlation_grad_cr_plain(g, cl, md, stride))}
        line = []
        for name, (kernel, plain) in runs.items():
            t_k, t_p = _graph_ms(kernel), _graph_ms(plain)
            bound_ms, bound_by = _bound(*work[name], bf16=bf16)
            for key, value in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", bound_ms),
                               ("bytes", work[name][0]), ("flops", work[name][1])):
                stats[name][key] += value
            stats[name]["levels"][level] = t_k
            beside = (f"float32 {f32[name]['levels'][level]:.4f}, "
                      if f32 is not None else "")
            full_name = f"{name}{'-bf16' if bf16 else ''}"
            if str(level) in (earlier or {}).get(full_name, {}):
                beside += f"earlier checkout {earlier[full_name][str(level)]:.4f}, "
            line.append(f"{full_name} {t_k:.4f} ms ({beside}plain {t_p:.4f}, "
                        f"bound {bound_ms:.4f} by {bound_by})")
        print(f"timing L{level} [{pairs},{chans},{h},{w}] {dtype} md {md} stride {stride} n^2 "
              f"{n2}: device (graph replay) {'; '.join(line)} {tag}", flush=True)
    if phase_no is not None:
        print(f"phase {phase_no} {dtype} correlation kernels vs plain at the levels of "
              f"{height}x{width}: max abs err K2 {stats['K2']['err']:.3g}, K3 "
              f"{stats['K3']['err']:.3g}, K4 {stats['K4']['err']:.3g} (K3, K4 also vs the "
              f"plain cost volume's autograd; {'; '.join(notes)})", flush=True)
        return stats
    if bf16:
        edge = _bf16_edge_checks(device, kernels_for(dtype))
        print(f"phase 21 bfloat16 correlation kernels vs plain: max abs err K2 "
              f"{stats['K2']['err']:.3g}, K3 {stats['K3']['err']:.3g}, K4 "
              f"{stats['K4']['err']:.3g}, each within 1 bfloat16 ulp of the plain value + "
              f"{BF16_CORR_ATOL} x max |plain| (K3, K4 also vs the plain cost volume's "
              f"autograd; {'; '.join(notes)}); edge shapes, aligned (TMA-staged where W % 8 "
              f"== 0) and offset by one value (staged by the threads; the same bits): {edge}",
              flush=True)
        return stats
    print(f"phase 8 correlation kernels vs plain: max abs err K2 {stats['K2']['err']:.3g}, "
          f"K3 {stats['K3']['err']:.3g}, K4 {stats['K4']['err']:.3g}, each <= {CORR_RTOL} x "
          f"max |plain| (K3, K4 also vs the plain cost volume's autograd; err / max |plain|: "
          f"{'; '.join(notes)})", flush=True)
    return stats


def _band_corr_phase(device, tag, dtype, stats) -> str:
    """Phases 8 and 21, the spatial mesh's shapes: K2, K3 and K4 of
    ``dtype`` on two bands (rows 0..h/2 - 1 and h/2..h - 1) of each PWC
    level of the headline 128x512 frame, against the rows of cr that
    ``spatial.correlation_rows`` gives a band (the whole map and the band's
    first row as the row offset where md exceeds the band's rows: every
    level here), and on its halo route at level 2 of a 256x1024 frame
    (the band's rows with md rows beyond each side, zeros outside the
    frame, row offset md), each held to its plain twin with that row offset
    (float32 within CORR_RTOL of the largest plain value; bfloat16 within
    one bfloat16 ulp + BF16_CORR_ATOL x max, ``bf16_ulp_excess``) and timed
    by graph replay beside the whole frame's launch (``stats``: the whole
    128x512 levels', from ``_corr_phase``). Returns a summary."""
    import torch
    import torch.nn.functional as F

    from xpt_mde_tpu_torch.config import NUM_SRC
    from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
    from xpt_mde_tpu_torch.ops.correlation import (correlation_channels,
                                                   correlation_cost_plain,
                                                   correlation_grad_cl_plain,
                                                   correlation_grad_cr_plain)
    from xpt_mde_tpu_torch.ops.kernels.correlation import kernels_for

    bf16 = dtype == torch.bfloat16
    k2, k3, k4 = kernels_for(dtype)
    generator = torch.Generator().manual_seed(7)
    pairs = BATCH * NUM_SRC
    worst = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    routes = set()
    cases = [(f"{HEIGHT}x{WIDTH}", HEIGHT, WIDTH, level) for level in (6, 5, 4, 3, 2)]
    cases.append((f"{2 * HEIGHT}x{2 * WIDTH}", 2 * HEIGHT, 2 * WIDTH, 2))
    for frame, height, width, level in cases:
        md, stride = level_displacement(level)
        chans, h, w = ENCODER_CHANNELS[level - 1], height >> level, width >> level
        n2 = correlation_channels(md, stride)
        cl, cr = ((torch.rand((pairs, chans, h, w), generator=generator) * 2 - 1).to(
            device, dtype) for _ in range(2))
        g = (torch.rand((pairs, n2, h, w), generator=generator) * 2 - 1).to(device, dtype)
        if height == HEIGHT:
            whole = {name: stats[name]["levels"][level] for name in worst}
        else:
            whole = {"K2": _graph_ms(lambda: k2(cl, cr, md, stride)),
                     "K3": _graph_ms(lambda: k3(g, cr, md, stride)),
                     "K4": _graph_ms(lambda: k4(g, cl, md, stride))}
        rows = h // 2
        for first in (0, rows):
            if md <= rows:  # the halo route
                top, bottom = max(0, md - first), max(0, first + rows + md - h)
                cr_rows = F.pad(cr, (0, 0, top, bottom))[:, :, first - md + top:
                                                         first + rows + md + top].contiguous()
                offset, route = md, "halo"
            else:
                cr_rows, offset, route = cr, first, "gathered"
            routes.add(f"{frame} L{level} {route}")
            cl_b = cl[:, :, first: first + rows].contiguous()
            g_b = g[:, :, first: first + rows].contiguous()
            runs = {"K2": (lambda: k2(cl_b, cr_rows, md, stride, offset),
                           lambda: correlation_cost_plain(cl_b, cr_rows, md, stride, offset)),
                    "K3": (lambda: k3(g_b, cr_rows, md, stride, offset),
                           lambda: correlation_grad_cl_plain(g_b, cr_rows, md, stride, offset)),
                    "K4": (lambda: k4(g_b, cl_b, md, stride, offset, cr_rows.shape[2]),
                           lambda: correlation_grad_cr_plain(g_b, cl_b, md, stride, offset,
                                                             cr_rows.shape[2]))}
            line = []
            for name, (kernel, plain) in runs.items():
                got, ref = kernel(), plain()
                torch.cuda.synchronize()
                if got.shape != ref.shape or got.dtype != dtype:
                    raise AssertionError(f"band {name} gave {tuple(got.shape)} {got.dtype}, "
                                         f"want {tuple(ref.shape)} {dtype}")
                if bf16:
                    err, ulps = bf16_ulp_excess(got, ref)
                    ok, measure = ulps <= 1.0, ulps
                else:
                    err = float((got - ref).abs().max())
                    measure = err / max(float(ref.abs().max()), 1e-30)
                    ok = err <= CORR_RTOL * float(ref.abs().max())
                if not ok:
                    raise AssertionError(f"band {name}{'-bf16' if bf16 else ''} differs from "
                                         f"plain by {err:.3g} ({measure:.3g}) at {frame} L{level} "
                                         f"rows {first}+{rows}, {route} route")
                worst[name] = max(worst[name], measure)
                line.append(f"{name}{'-bf16' if bf16 else ''} {_graph_ms(kernel):.4f} ms "
                            f"(whole frame {whole[name]:.4f})")
            print(f"timing band L{level} of {frame} [{pairs},{chans},{rows} of {h},{w}] rows "
                  f"{first}..{first + rows - 1}, {route} route (cr {cr_rows.shape[2]} rows, "
                  f"row offset {offset}): device (graph replay) {'; '.join(line)} {tag}",
                  flush=True)
    rule = "1 bfloat16 ulp + " + f"{BF16_CORR_ATOL} x max" if bf16 else f"{CORR_RTOL} x max"
    return (f"band {'bfloat16' if bf16 else 'float32'} correlation kernels vs plain with a row "
            f"offset (two bands of each PWC level of 128x512, gathered route; 256x1024 L2, halo "
            f"route): worst K2 {worst['K2']:.3g}, K3 {worst['K3']:.3g}, K4 {worst['K4']:.3g} "
            f"({'of the bound' if bf16 else 'of the largest plain value'}, rule {rule}); routes "
            f"{sorted(routes)}")


def _bf16_edge_checks(device, kernels) -> str:
    """The bfloat16 K2, K3 and K4 at the card tests' edge shapes
    (CORR_EDGE_SHAPES), on aligned inputs and on views offset by one value
    (the scalar staging and store paths): within the bfloat16 rule of the
    plain versions, and the same bits on both. Returns a summary."""
    import torch

    from xpt_mde_tpu_torch.ops.correlation import (correlation_channels,
                                                   correlation_cost_plain,
                                                   correlation_grad_cl_plain,
                                                   correlation_grad_cr_plain)

    def offset_copy(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    k2, k3, k4 = kernels
    worst = 0.0
    for shape, md, stride in CORR_EDGE_SHAPES:
        generator = torch.Generator().manual_seed(sum(shape))
        cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(device, torch.bfloat16)
                  for _ in range(2))
        n2 = correlation_channels(md, stride)
        g = (torch.rand((shape[0], n2) + shape[2:], generator=generator) * 2 - 1).to(
            device, torch.bfloat16)
        runs = {"K2": (lambda a, b, c: k2(b, c, md, stride), (g, cl, cr),
                       correlation_cost_plain(cl, cr, md, stride)),
                "K3": (lambda a, b, c: k3(a, c, md, stride), (g, cl, cr),
                       correlation_grad_cl_plain(g, cr, md, stride)),
                "K4": (lambda a, b, c: k4(a, b, md, stride), (g, cl, cr),
                       correlation_grad_cr_plain(g, cl, md, stride))}
        for name, (run, args, ref) in runs.items():
            got = run(*args)
            shifted = run(*(offset_copy(t) for t in args))
            _, ulps = bf16_ulp_excess(got, ref)
            if not ulps <= 1.0 or not torch.equal(got, shifted):
                raise AssertionError(f"{name}-bf16 at {shape} md {md} stride {stride}: "
                                     f"{ulps:.3g} of the bound, offset run "
                                     f"{'equal' if torch.equal(got, shifted) else 'differs'}")
            worst = max(worst, ulps)
    return (f"{len(CORR_EDGE_SHAPES)} shapes x K2, K3, K4 within {worst:.3g} of the bound, "
            f"offset runs bit-equal")


# the bfloat16 cross-check (phase 23): one bfloat16 step on the card against
# the float32 step of the same call, from the same weights and batch, held
# to the distance the CPU's bfloat16 step lies from the CPU's float32 step
# (which tests/test_torch_bf16_*.py hold to the JAX package's): at most
# BF16_MEDIAN_RATIO times at the median and BF16_MAX_RATIO times at the
# maximum, over the loss terms, the parameter tensors (relative distances
# of those above GRAD_FLOOR) and the BatchNorm statistics (elementwise,
# pooled, beside BF16_STAT_ATOL of their scale)
BF16_MEDIAN_RATIO, BF16_MAX_RATIO, BF16_STAT_ATOL = 2.0, 4.0, 1e-6


def _ratio_rule(card, cpu, label):
    """``card`` and ``cpu``: distances of bfloat16 from float32 per element
    (a 1-d array). Raise unless the card's median and maximum stay within
    BF16_MEDIAN_RATIO and BF16_MAX_RATIO of the CPU's; return a summary."""
    import numpy as np
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    med = (float(np.median(card)), float(np.median(cpu)))
    top = (float(card.max()), float(cpu.max()))
    if not (med[0] <= BF16_MEDIAN_RATIO * med[1] and top[0] <= BF16_MAX_RATIO * top[1]):
        raise AssertionError(f"{label}: card bf16-vs-f32 median {med[0]:.3g}, max {top[0]:.3g} "
                             f"against the CPU's {med[1]:.3g}, {top[1]:.3g}")
    return f"{label} median {med[0]:.3g} (CPU {med[1]:.3g}), max {top[0]:.3g} (CPU {top[1]:.3g})"


def _bf16_cross_check(check, device, f32_runs=None):
    """Phase 23 for one stage: one train step of ``check`` in bfloat16 and
    one in float32, on the card and on the CPU (from ``_CPU_RUNS``), from
    the same seeded weights (``check.prepare`` sets the heads' biases), no
    augmentation; the card's bfloat16-vs-float32 distances held to the
    CPU's by ``_ratio_rule``. ``f32_runs``: the float32 steps of
    ``_step_cross_check`` on the same inputs, not run again. Returns a
    summary."""
    import numpy as np
    import torch

    from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory

    label = check.label
    runs = dict(f32_runs or {})
    for dtype in ("bfloat16", "float32"):
        if ("card", dtype) not in runs:
            model = _seeded_model(check.keys, check.nets, device, dtype)
            check.prepare(model, device)
            step = make_train_step(model, check.loss,
                                   optimizer_factory("adam_constant", LR, model),
                                   **check.step_kwargs)
            metrics = step({k: v.to(device) for k, v in check.tensors().items()})
            runs["card", dtype] = {
                "metrics": metrics, "float32_params": all(p.dtype == torch.float32
                                                          for p in model.parameters()),
                "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                          if p.grad is not None},
                "stats": {k: v.detach().cpu() for k, v in model.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}}
        if ("cpu", dtype) not in runs:
            runs["cpu", dtype] = _cpu_run(check, dtype)
            _check_digest(f"{label} {dtype}", runs["cpu", dtype]["digest"],
                          _prepared_state(check, dtype))
    for key, run in runs.items():
        if isinstance(run, tuple):  # from f32_runs
            continue
        if not all(bool(torch.isfinite(v).all()) for v in run["metrics"].values()):
            raise AssertionError(f"{label} {key}: non-finite metrics")
        if not run["float32_params"]:
            raise AssertionError(f"{label} {key}: a parameter is not float32")
        runs[key] = ({k: float(v) for k, v in run["metrics"].items() if k.startswith("loss")},
                     _cast(run["grads"], torch.float64), _cast(run["stats"], torch.float64))

    def pair(where, part):
        return runs[where, "bfloat16"][part], runs[where, "float32"][part]

    lines = []
    terms = sorted(runs["cpu", "float32"][0])
    rel = {}
    for where in ("card", "cpu"):
        lo, hi = pair(where, 0)
        rel[where] = np.array([abs(lo[k] - hi[k]) / abs(hi[k]) for k in terms])
    if not rel["card"].max() <= BF16_MAX_RATIO * rel["cpu"].max() + 1e-6:
        raise AssertionError(f"{label} losses: card bf16-vs-f32 {rel['card'].tolist()} "
                             f"against the CPU's {rel['cpu'].tolist()}")
    lines.append(f"loss terms' relative distance max {rel['card'].max():.3g} "
                 f"(CPU {rel['cpu'].max():.3g})")
    floor = {n for n, g in runs["cpu", "float32"][1].items()
             if float(torch.linalg.norm(g)) > GRAD_FLOOR}
    grad_rel = {}
    for where in ("card", "cpu"):
        lo, hi = pair(where, 1)
        grad_rel[where] = [float(torch.linalg.norm(lo[n] - hi[n]) / torch.linalg.norm(hi[n]))
                           for n in sorted(floor)]
    lines.append(_ratio_rule(grad_rel["card"], grad_rel["cpu"],
                             f"{len(floor)} gradient tensors' relative distance"))
    stats = sorted(runs["cpu", "float32"][2])
    if stats:
        pooled = {}
        for where in ("card", "cpu"):
            lo, hi = pair(where, 2)
            pooled[where] = torch.cat([(lo[k] - hi[k]).abs().reshape(-1) for k in stats])
        scale = float(torch.cat([runs["cpu", "float32"][2][k].abs().reshape(-1)
                                 for k in stats]).max())
        lines.append(_ratio_rule((pooled["card"] - BF16_STAT_ATOL * scale).clamp_min(0).numpy(),
                                 pooled["cpu"].numpy(), "BN statistics"))
    card16 = runs["card", "bfloat16"][0]
    return (f"{label}: card bf16 losses {json.dumps({k: round(v, 6) for k, v in card16.items()})}"
            f"; {'; '.join(lines)}")


def _bf16_steps_phase(device, batches, counts, zero_counts, all_kernels, f32_rates, rounds,
                      steps, tag):
    """Phase 22: the bfloat16 steps at full width (B5 / PWC-Net, batch 8,
    128x512): rigid predict, rigid train (default augmentation), flow
    train, joint train (the flownet frozen) and stereo train (the MS
    recipe, default augmentation). Each runs 2 steps from zero counts with
    its launches per step checked (the bfloat16 K2, K3 and K4, never the
    float32 ones) and float32, finite outputs, then ``rounds`` timed
    rounds of ``steps``; images/s and peak memory beside the float32
    step's of this call (``f32_rates``: {step: (images/s, peak bytes)}).
    ``batches``: {"mono", "mono uint8", "stereo uint8": card batches}.
    Returns {step: launches per step}."""
    import torch

    from xpt_mde_tpu_torch.config import (AUGMENT_PROBS, FLOW_NET, JOINT_NET, RIGID_NET,
                                          SCALE_WEIGHT_T1)
    from xpt_mde_tpu_torch.losses import loss_factory
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.tools.profile_steps import STEREO_KEYS, STEREO_RECIPE
    from xpt_mde_tpu_torch.training import (augmentation_factory, make_predict_step,
                                            make_train_step, optimizer_factory)

    keys = ["image", "intrinsic", "depth_gt", "pose_gt"]
    zeros = dict.fromkeys(all_kernels, 0)
    generator = torch.Generator().manual_seed(0)
    cases = [  # (label, nets, keys, recipe, step kwargs, augment, batches, launches per step)
        ("predict", RIGID_NET, keys, None, {}, False, "mono", {}),
        ("train", RIGID_NET, keys, RECIPE, {}, True, "mono uint8", {"K1": 4, "K1-bwd": 4}),
        ("flow train", FLOW_NET, keys, FLOW_RECIPE, {"regularize_net": "flownet"}, False,
         "mono uint8", {"K1": 4, "K1-bwd": 4, "K2-bf16": 5, "K3-bf16": 5, "K4-bf16": 5}),
        ("joint train", JOINT_NET, keys, JOINT_RECIPE, {"frozen_nets": ["flownet"]}, False,
         "mono uint8", {"K1": 8, "K1-bwd": 4, "K2-bf16": 5}),
        ("stereo train", RIGID_NET, STEREO_KEYS, STEREO_RECIPE, {}, True, "stereo uint8",
         {"K1": 16, "K1-bwd": 16})]
    per_step = {}
    for label, nets, net_keys, recipe, kwargs, augment, which, launches in cases:
        stereo = which.startswith("stereo")
        model = ModelFactory(net_keys, nets, stereo=stereo, compute_dtype="bfloat16",
                             device=device, seed=0).get_model()
        if recipe is None:
            step = make_predict_step(model)
        else:
            loss = loss_factory(net_keys, recipe, SCALE_WEIGHT_T1, stereo=stereo,
                                batch_size=BATCH)
            optimizer = optimizer_factory("adam_constant", LR, model,
                                          frozen_nets=kwargs.get("frozen_nets", []))
            train = make_train_step(model, loss, optimizer, augmenter=augmentation_factory(
                AUGMENT_PROBS) if augment else None, **kwargs)
            step = (lambda f, train=train: train(f, generator)) if augment else train
        step_batches = batches[which]
        zero_counts()
        for i in range(2):
            before = counts()
            out = step(step_batches[i])
            delta = {k: v - before[k] for k, v in counts().items()}
            if delta != zeros | launches:
                raise AssertionError(f"bf16 {label} step {i} launched {delta}, want {launches}")
            values = out["depth_ms"] + [out["pose"]] if recipe is None else list(out.values())
            if not all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                       for v in values):
                raise AssertionError(f"bf16 {label}: outputs not float32 or not finite")
        per_step[label] = launches
        rates, peak = _timed_rounds(step, step_batches, rounds, steps)
        median = rates[rounds // 2]
        f32_median, f32_peak = f32_rates[label]
        print(f"timing bf16 {label} {'+'.join(nets.values())} batch {BATCH} {HEIGHT}x{WIDTH} "
              f"(cuDNN heuristics): median {median:.2f} images/s ({1000 * BATCH / median:.2f} "
              f"ms/step), min {rates[0]:.2f}, max {rates[-1]:.2f} over {rounds} rounds of "
              f"{steps} steps, {median / f32_median:.3f}x the float32 step's {f32_median:.2f} "
              f"in this call; max_memory_allocated {peak / 2**30:.3f} GiB "
              f"({peak / f32_peak:.3f}x float32's {f32_peak / 2**30:.3f}); launches per step "
              f"{json.dumps(launches)} {tag}", flush=True)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 22 bf16 steps at full width: {', '.join(per_step)}; launches per step as "
          f"stated, the float32 correlation kernels never, every output float32 and finite",
          flush=True)
    return per_step


def main(argv=()) -> int:
    """Run the phases; ``argv``: the command line's arguments."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--earlier", metavar="DIR",
                        help="a checkout of an earlier commit whose kernels to time first")
    args = parser.parse_args(list(argv))
    t_script = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 1
    try:
        from xpt_mde_tpu_torch.config import (AUGMENT_PROBS, FLOW_NET, JOINT_NET, LOSS_FLOW,
                                              LOSS_RIGID_COMB, NUM_SRC, RIGID_NET,
                                              SCALE_WEIGHT_T1)
        from xpt_mde_tpu_torch.data import SyntheticDataset
        from xpt_mde_tpu_torch.losses import loss_factory
        from xpt_mde_tpu_torch.models import ModelFactory
        from xpt_mde_tpu_torch.ops.kernels import correlation as corr_kernels
        from xpt_mde_tpu_torch.ops.kernels import warp as kernels
        from xpt_mde_tpu_torch.tools.profile_steps import (STEREO_KEYS, STEREO_RECIPE,
                                                           profile_step, uint8_coded)
        from xpt_mde_tpu_torch.training import (augmentation_factory, make_eval_step,
                                                make_predict_step, make_train_step,
                                                optimizer_factory)
        from xpt_mde_tpu_torch.utils.precision import full_f32
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1

    K1, K1_BWD = kernels.K1, kernels.K1_BWD
    K2, K3, K4 = corr_kernels.K2, corr_kernels.K3, corr_kernels.K4
    f32_kernels = {"K1": K1, "K1-bwd": K1_BWD, "K2": K2, "K3": K3, "K4": K4}
    bf16_kernels = {k.name: k for k in corr_kernels.kernels_for(torch.bfloat16)}
    all_kernels = f32_kernels | bf16_kernels

    def zero_counts():
        for kernel in all_kernels.values():
            kernel.launches = 0

    def counts():
        return {name: kernel.launches for name, kernel in all_kernels.items()}

    device = torch.device("cuda", 0)
    clock_state = {"name": None, "t": time.perf_counter()}

    def clock(name):
        """Print the seconds the phase before ``name`` took; return ``name``."""
        now = time.perf_counter()
        if clock_state["name"] is not None:
            print(f"phase seconds: {clock_state['name']} {now - clock_state['t']:.1f} s",
                  flush=True)
        clock_state.update(name=name, t=now)
        return name

    phase = clock("device")
    # full float32 (TF32 off for cuBLAS and cuDNN) in every phase, so the
    # kernel checks and the GPU/CPU comparisons test float32 numerics
    try:
        with full_f32():
            # 1. device and build
            smi = _nvidia_smi_line()
            tag = f"[{smi}]"
            name = torch.cuda.get_device_name(0)
            count = torch.cuda.device_count()
            print(f"phase 1 device: {name}, count {count}, nvidia-smi name/power.limit: {smi}",
                  flush=True)
            # the CPU workers of the cross-checks start first, beside the compilers
            phase = clock("cross-checks' float64 runs queued")
            _CPU_RUNS.start()
            keys = ["image", "intrinsic", "depth_gt", "pose_gt"]
            # stereo snippets in the kitti_raw schema; their left views are
            # the mono snippets of the same seed
            dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                                       num_batches=NUM_BATCHES, stereo=True, seed=0)
            stereo_feature_keys = ["image5d", "intrinsic", "depth_gt", "pose_gt", "image5d_R",
                                   "intrinsic_R", "stereo_T_LR"]
            stereo_batches = [{k: b[k] for k in stereo_feature_keys} for b in dataset]
            batches = [{k: b[k] for k in stereo_feature_keys[:4]} for b in stereo_batches]

            # the cross-checked steps of phases 7, 11, 14 and 17 (and 23),
            # on the first samples of batch 0, and phase 29's: their float64
            # CPU runs queued now, in the order the checks take them
            def first(source, n):
                return {k: v[:n] for k, v in source[0].items()}

            stereo_check = first(stereo_batches, CHECK_BATCH)
            stereo_check["stereo_T_LR"] = np.array([CHECK_T_LR] * CHECK_BATCH, np.float32)
            checks = {
                "rigid": _Check("train", RIGID_NET, keys, first(batches, CHECK_BATCH),
                                loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                             batch_size=CHECK_BATCH), _set_pose_twist),
                "flow": _Check("flow train", FLOW_NET, keys, first(batches, FLOW_CHECK_BATCH),
                               loss_factory(keys, FLOW_RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                            batch_size=FLOW_CHECK_BATCH), _set_flow_heads,
                               {"regularize_net": "flownet"}),
                "joint": _Check("joint train", JOINT_NET, keys, first(batches, CHECK_BATCH),
                                loss_factory(keys, JOINT_RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                             batch_size=CHECK_BATCH), _set_pose_and_flow_heads,
                                {"frozen_nets": ["flownet"]}),
                "stereo": _Check("stereo train", RIGID_NET, STEREO_KEYS, stereo_check,
                                 loss_factory(STEREO_KEYS, STEREO_RECIPE, SCALE_WEIGHT_T1,
                                              batch_size=CHECK_BATCH), _set_pose_twist)}
            for check in checks.values():
                _CPU_RUNS.submit([((check.label, "float64"), _cpu_step, (check, "float64"))])
            for check in _zoo_checks().values():
                _CPU_RUNS.submit([((check.label, "backbone torch.float64"), _cpu_backbone,
                                   (check, "float64"))])

            phase = clock("build")
            t0 = time.perf_counter()
            # one nvcc per source, started together; the other entries of
            # each library then load the built file
            with ThreadPoolExecutor(2) as pool:
                for future in [pool.submit(K1.build), pool.submit(K2.build)]:
                    future.result()
            for kernel in (K1_BWD, K3, K4, *bf16_kernels.values()):
                kernel.build()
            ptxas = [ln.strip() for log in (K1.build_log, K2.build_log)
                     for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            print(f"phase 1 build: K1, K1-bwd, K2, K3 and K4 (float32 and bfloat16) built in "
                  f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}", flush=True)
            phase = clock("SASS check")
            print(f"phase 1 SASS of the tensor-core kernels: "
                  f"{_sass_check(K2.library_path)}", flush=True)

            earlier, earlier_levels = {}, {}
            if args.earlier:
                phase = clock("earlier kernels")
                earlier, earlier_levels = _earlier_kernels(args.earlier, tag, device)
                print(f"phase 1 earlier kernels ({args.earlier}), device ms per train step: "
                      f"{json.dumps(earlier)} {tag}", flush=True)

            # 2. the kernels against their plain versions, and their times
            phase = clock("kernels vs plain")
            kstats = _warp_phase(batches, device, np.random.RandomState(0), tag)
            print(_band_warp_phase(batches, device, np.random.RandomState(3), tag), flush=True)
            n1_errs, n1_times = _cross_warp_check(stereo_batches[0], device,
                                                  np.random.RandomState(1), tag)

            # 3. predict, 4. eval: one path, its counts read from zero
            phase = clock("predict")
            model = ModelFactory(keys, RIGID_NET, stereo=False, device=device, seed=0).get_model()
            init_state = copy.deepcopy(model.state_dict())

            def make_loss(batch_size):
                return loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                    batch_size=batch_size)

            total_loss = make_loss(BATCH)
            predict_step = make_predict_step(model)
            eval_step = make_eval_step(model, total_loss)
            gpu_batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                           for b in batches]
            zero_counts()
            for features in gpu_batches:
                preds = predict_step(features)
                for i in range(len(SCALES)):
                    want = (BATCH, HEIGHT >> i, WIDTH >> i, 1)
                    for key in ("depth_ms", "disp_ms"):
                        got_shape = tuple(preds[key][i].shape)
                        if got_shape != want:
                            raise AssertionError(f"{key}[{i}] is {got_shape}, want {want}")
                        if not bool(torch.isfinite(preds[key][i]).all()):
                            raise AssertionError(f"{key}[{i}] is not finite")
                if tuple(preds["pose"].shape) != (BATCH, 4, 6) \
                        or not bool(torch.isfinite(preds["pose"]).all()):
                    raise AssertionError(f"pose {tuple(preds['pose'].shape)} bad or not finite")
            torch.cuda.synchronize()
            print(f"phase 3 predict: {NUM_BATCHES} batches, depth_ms[0] "
                  f"{tuple(preds['depth_ms'][0].shape)}, pose {tuple(preds['pose'].shape)}, "
                  f"all finite", flush=True)

            phase = clock("eval")
            gpu_metrics = []
            for features in gpu_batches:
                before = K1.launches
                metrics = eval_step(features)
                if K1.launches - before != len(SCALES):
                    raise AssertionError(f"eval step launched K1 {K1.launches - before} "
                                         f"times, want {len(SCALES)}")
                values = {k: float(v) for k, v in metrics.items()}
                if not all(np.isfinite(v) for v in values.values()):
                    raise AssertionError(f"non-finite eval metrics {values}")
                gpu_metrics.append(values)
            eval_counts = counts()
            if eval_counts != dict.fromkeys(all_kernels, 0) | {"K1": len(SCALES) * NUM_BATCHES}:
                raise AssertionError(f"predict + eval launched {eval_counts}")
            losses0 = {k: v for k, v in gpu_metrics[0].items() if k.startswith("loss")}
            print(f"phase 4 eval: {NUM_BATCHES} steps, K1 launches {eval_counts['K1']}, "
                  f"K1-bwd launches {eval_counts['K1-bwd']}, batch 0 {json.dumps(losses0)}",
                  flush=True)

            # 5. the same eval step on the CPU: the plain warp and CPU convs
            phase = clock("eval cross-check")
            cpu_model = copy.deepcopy(model).cpu()
            cpu_metrics = make_eval_step(cpu_model, total_loss)(
                {k: torch.from_numpy(v) for k, v in batches[0].items()})
            _, rel = _check_losses(gpu_metrics[0], cpu_metrics, "eval")
            print(f"phase 5 eval cross-check: GPU vs CPU eval losses agree within "
                  f"(rtol, atol) {json.dumps(LOSS_TOL)} (rel diff {json.dumps(rel)}); CPU "
                  f"{json.dumps({k: float(cpu_metrics[k]) for k in LOSS_TOL})}", flush=True)

            # 6. train: the rigid train path, its counts read from zero
            phase = clock("train")
            model.load_state_dict(init_state)
            optimizer = optimizer_factory("adam_constant", LR, model)
            train_step = make_train_step(model, total_loss, optimizer,
                                         augmenter=augmentation_factory(AUGMENT_PROBS))
            generator = torch.Generator().manual_seed(0)
            # the loaders ship uint8 snippets; the step decodes them
            train_batches = [uint8_coded(b) for b in gpu_batches]
            zero_counts()
            train_losses = []
            for i in range(TRAIN_STEPS):
                metrics = train_step(train_batches[i % NUM_BATCHES], generator)
                values = {k: float(v) for k, v in metrics.items()}
                if not all(np.isfinite(v) for v in values.values()):
                    raise AssertionError(f"non-finite train metrics at step {i}: {values}")
                train_losses.append(values["loss"])
            train_counts = counts()
            if train_counts != dict.fromkeys(all_kernels, 0) | dict.fromkeys(
                    ("K1", "K1-bwd"), len(SCALES) * TRAIN_STEPS):
                raise AssertionError(f"{TRAIN_STEPS} train steps launched {train_counts}")
            state = model.state_dict()
            for suffix in ("weight", "running_mean", "running_var"):
                names = [k for k in state if k.endswith(suffix)]
                moved = sum(not torch.equal(state[k], init_state[k]) for k in names)
                if moved != len(names):
                    raise AssertionError(f"{len(names) - moved} of {len(names)} *.{suffix} "
                                         f"tensors did not change in training")
            print(f"phase 6 train: {TRAIN_STEPS} steps, K1 launches {train_counts['K1']}, "
                  f"K1-bwd launches {train_counts['K1-bwd']}, losses "
                  f"{json.dumps([round(v, 6) for v in train_losses])}, every weight and BN "
                  f"statistic moved", flush=True)

            # 7. one train step on the card and on the CPU
            phase = clock("train cross-check")
            f32_runs = {"rigid": _train_cross_check(7, checks["rigid"], device,
                                                    ("depth_ms", "pose"), LOSS_TOL)}

            # 8. the correlation kernels against their plain versions
            phase = clock("correlation kernels vs plain")
            cstats = _corr_phase(device, tag)
            print(f"phase 8 {_band_corr_phase(device, tag, torch.float32, cstats)}", flush=True)

            # 9. flow predict: its counts read from zero
            phase = clock("flow predict")
            flow_model = ModelFactory(keys, FLOW_NET, stereo=False, device=device,
                                      seed=0).get_model()
            flow_init = copy.deepcopy(flow_model.state_dict())

            def make_flow_loss(batch_size):
                return loss_factory(keys, FLOW_RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                    batch_size=batch_size)

            flow_predict = make_predict_step(flow_model)
            per_forward = dict.fromkeys(all_kernels, 0) | {"K2": 5}
            zero_counts()
            for features in gpu_batches:
                before = counts()
                flow_ms = flow_predict(features)["flow_ms"]
                delta = {k: v - before[k] for k, v in counts().items()}
                if delta != per_forward:
                    raise AssertionError(f"a flow forward launched {delta}, want {per_forward}")
                for i, flow in enumerate(flow_ms):
                    want = (BATCH, NUM_SRC, HEIGHT >> (i + 2), WIDTH >> (i + 2), 2)
                    if tuple(flow.shape) != want or not bool(torch.isfinite(flow).all()):
                        raise AssertionError(f"flow_ms[{i}] {tuple(flow.shape)} (want {want}) "
                                             f"bad or not finite")
            flow_predict_counts = counts()
            print(f"phase 9 flow predict: {NUM_BATCHES} batches, flow_ms "
                  f"{[tuple(f.shape) for f in flow_ms]}, all finite, launches "
                  f"{json.dumps(flow_predict_counts)}", flush=True)

            # 10. flow train: the flow stage's train path, its counts read from zero
            phase = clock("flow train")
            flow_optimizer = optimizer_factory("adam_constant", LR, flow_model)
            flow_train = make_train_step(flow_model, make_flow_loss(BATCH), flow_optimizer,
                                         regularize_net="flownet")
            per_step = dict.fromkeys(all_kernels, 0) | {"K1": 4, "K1-bwd": 4, "K2": 5, "K3": 5,
                                                        "K4": 5}
            zero_counts()
            flow_losses = []
            for i in range(FLOW_TRAIN_STEPS):
                before = counts()
                metrics = flow_train(train_batches[i % NUM_BATCHES])
                delta = {k: v - before[k] for k, v in counts().items()}
                if delta != per_step:
                    raise AssertionError(f"flow train step {i} launched {delta}, "
                                         f"want {per_step}")
                values = {k: float(v) for k, v in metrics.items()}
                if not all(np.isfinite(v) for v in values.values()):
                    raise AssertionError(f"non-finite flow train metrics at step {i}: {values}")
                flow_losses.append({k: round(v, 6) for k, v in values.items()})
            flow_train_counts = counts()
            state = flow_model.state_dict()
            moved = sum(not torch.equal(state[k], flow_init[k]) for k in state)
            if moved != len(state):
                raise AssertionError(f"{len(state) - moved} of {len(state)} flownet tensors "
                                     f"did not change in training")
            print(f"phase 10 flow train: {FLOW_TRAIN_STEPS} steps, launches "
                  f"{json.dumps(flow_train_counts)} ({json.dumps(per_step)} per step), every "
                  f"weight moved, metrics {json.dumps(flow_losses)}", flush=True)

            # 11. one flow train step on the card and on the CPU
            phase = clock("flow train cross-check")
            f32_runs["flow"] = _train_cross_check(11, checks["flow"], device, ("flow_ms",),
                                                  FLOW_LOSS_TOL)

            # the zoo's float64 runs in too: no timed phase shares the host
            # with the workers
            phase = clock("cross-checks' float64 runs")
            print(f"phase 11 cross-checks' float64 runs: waited {_CPU_RUNS.drain():.1f} s for "
                  f"the last of them", flush=True)
            _CPU_RUNS.stop()

            # 12. step timings and peak memory
            phase = clock("timings")
            # the steps are host-bound: report the spread (3 rounds of 1
            # step, float32 and bfloat16 alike: the script, phases 30-32
            # with it, must stay well inside its 1200 s)
            rounds, steps = 3, 1
            f32_rates = {}  # step: (median images/s, peak bytes), for the bf16 phase
            for label, step, step_batches, net, opt, opt_model in (
                    ("predict", predict_step, gpu_batches, "B5", None, None),
                    ("eval", eval_step, gpu_batches, "B5", None, None),
                    ("train", lambda f: train_step(f, generator), train_batches, "B5",
                     optimizer, model),
                    ("flow predict", flow_predict, gpu_batches, "PWCNet", None, None),
                    ("flow train", flow_train, train_batches, "PWCNet", flow_optimizer,
                     flow_model)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                step(step_batches[0])
                torch.cuda.synchronize()
                rates = []
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    for i in range(steps):
                        step(step_batches[i % NUM_BATCHES])
                    torch.cuda.synchronize()
                    rates.append(steps * BATCH / (time.perf_counter() - t0))
                rates.sort()
                median = rates[rounds // 2]
                peak = torch.cuda.max_memory_allocated(device)
                f32_rates[label] = (median, peak)
                if opt is not None:  # the optimizer alone, on the last gradients
                    n_params = sum(p.numel() for p in opt_model.parameters())
                    print(f"timing {label} Adam step alone: {_event_ms(opt.step, iters=10):.4f} "
                          f"ms per call (eager, CUDA events) over {n_params} parameters in "
                          f"{len(list(opt_model.parameters()))} tensors {tag}", flush=True)
                print(f"timing {label} {net} batch {BATCH} {HEIGHT}x{WIDTH} f32 (cuDNN "
                      f"heuristics): median "
                      f"{median:.2f} images/s ({1000 * BATCH / median:.2f} ms/step), "
                      f"min {rates[0]:.2f}, max {rates[-1]:.2f} over {rounds} rounds of "
                      f"{steps} steps; max_memory_allocated {peak / 2**30:.3f} GiB {tag}",
                      flush=True)
            for line in profile_step("flow-train (PWCNet)", flow_train, train_batches):
                print(f"profile {line} {tag}", flush=True)
            # the rigid and flow models go before the joint one is built
            del (model, optimizer, train_step, predict_step, eval_step, cpu_model, flow_model,
                 flow_optimizer, flow_train, flow_predict, step, opt, opt_model, state,
                 init_state, flow_init, preds, flow_ms)
            gc.collect()
            torch.cuda.empty_cache()

            # 13. joint train: its counts read from zero
            phase = clock("joint train")
            joint_model = ModelFactory(keys, JOINT_NET, stereo=False, device=device,
                                       seed=0).get_model()
            flow_before = copy.deepcopy(joint_model.flownet.state_dict())

            def make_joint_loss(batch_size):
                return loss_factory(keys, JOINT_RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                    batch_size=batch_size)

            joint_train = make_train_step(
                joint_model, make_joint_loss(BATCH),
                optimizer_factory("adam_constant", LR, joint_model, frozen_nets=["flownet"]),
                frozen_nets=["flownet"])
            zero_counts()
            joint_losses = []
            for i in range(JOINT_TRAIN_STEPS):
                before = counts()
                metrics = joint_train(train_batches[i % NUM_BATCHES])
                delta = {k: v - before[k] for k, v in counts().items()}
                if delta != dict.fromkeys(all_kernels, 0) | JOINT_PER_STEP:
                    raise AssertionError(f"joint train step {i} launched {delta}, "
                                         f"want {JOINT_PER_STEP}")
                values = {k: float(v) for k, v in metrics.items()}
                if not all(np.isfinite(v) for v in values.values()):
                    raise AssertionError(f"non-finite joint train metrics at step {i}: {values}")
                joint_losses.append({k: round(v, 6) for k, v in values.items()
                                     if k.startswith("loss")})
            joint_counts = counts()
            flow_after = joint_model.flownet.state_dict()
            changed = [k for k in flow_before if not torch.equal(flow_before[k], flow_after[k])]
            if changed:
                raise AssertionError(f"the frozen flownet changed: {changed[:5]}")
            print(f"phase 13 joint train: {JOINT_TRAIN_STEPS} steps, launches "
                  f"{json.dumps(joint_counts)} ({json.dumps(JOINT_PER_STEP)} per step), the "
                  f"flownet's {len(flow_before)} tensors bit-unchanged, losses "
                  f"{json.dumps(joint_losses)}", flush=True)
            rates, peak = _timed_rounds(joint_train, train_batches, rounds, steps)
            median = rates[rounds // 2]
            f32_rates["joint train"] = (median, peak)
            print(f"timing joint train B5+PWCNet batch {BATCH} {HEIGHT}x{WIDTH} f32 (cuDNN "
                  f"heuristics): median {median:.2f} images/s ({1000 * BATCH / median:.2f} "
                  f"ms/step), min {rates[0]:.2f}, max {rates[-1]:.2f} over {rounds} rounds of "
                  f"{steps} steps; max_memory_allocated {peak / 2**30:.3f} GiB {tag}", flush=True)
            del joint_model, joint_train
            gc.collect()
            torch.cuda.empty_cache()

            # 14. one joint train step on the card and on the CPU
            phase = clock("joint train cross-check")
            f32_runs["joint"] = _train_cross_check(14, checks["joint"], device,
                                                   ("depth_ms", "pose"), JOINT_LOSS_TOL,
                                                   fixed_keys=("flow_ms",),
                                                   loss_grad_rule=JOINT_LOSS_GRAD_RULE)

            # 15. the plan: the slice's main path, its counts read from zero
            phase = clock("plan")
            with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
                plan_counts, plan_note = _plan_phase(workdir, device, counts, zero_counts,
                                                     tag)
            missing = [k for k in f32_kernels if plan_counts[k] == 0]
            if missing or any(plan_counts[k] for k in bf16_kernels):
                raise AssertionError(f"the plan never launched {missing}: {plan_counts}")
            print(f"phase 15 plan: {plan_note}; launches {json.dumps(plan_counts)}", flush=True)

            # 16. stereo train: the MS recipe, its counts read from zero
            phase = clock("stereo train")
            stereo_gpu = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                          for b in stereo_batches]
            stereo_train_batches = [uint8_coded(b) for b in stereo_gpu]

            def make_stereo_loss(recipe, batch_size):
                return loss_factory(STEREO_KEYS, recipe, SCALE_WEIGHT_T1, batch_size=batch_size)

            def run_steps(label, step, per_step, n_steps, args=()):
                """``n_steps`` steps from zero counts, each launching ``per_step``."""
                zero_counts()
                losses = []
                for i in range(n_steps):
                    before = counts()
                    metrics = step(stereo_train_batches[i % NUM_BATCHES], *args)
                    delta = {k: v - before[k] for k, v in counts().items()}
                    if delta != dict.fromkeys(all_kernels, 0) | per_step:
                        raise AssertionError(f"{label} step {i} launched {delta}, "
                                             f"want {per_step}")
                    values = {k: float(v) for k, v in metrics.items()}
                    if not all(np.isfinite(v) for v in values.values()):
                        raise AssertionError(f"non-finite {label} metrics at step {i}: {values}")
                    losses.append({k: round(v, 6) for k, v in values.items()
                                   if k.startswith("loss")})
                return counts(), losses

            def report_rate(label, step, args=()):
                rates, peak = _timed_rounds(lambda f: step(f, *args), stereo_train_batches,
                                            rounds, steps)
                median = rates[rounds // 2]
                f32_rates[label.split(" B5")[0]] = (median, peak)
                print(f"timing {label} batch {BATCH} {HEIGHT}x{WIDTH} f32 (cuDNN heuristics): "
                      f"median {median:.2f} images/s ({1000 * BATCH / median:.2f} ms/step), min "
                      f"{rates[0]:.2f}, max {rates[-1]:.2f} over {rounds} rounds of {steps} steps; "
                      f"max_memory_allocated {peak / 2**30:.3f} GiB {tag}", flush=True)

            stereo_model = ModelFactory(STEREO_KEYS, RIGID_NET, device=device, seed=0).get_model()
            if not (stereo_model.stereo and stereo_model.stereo_pose):
                raise AssertionError("the stereo keys did not build the stereo model")
            stereo_train = make_train_step(
                stereo_model, make_stereo_loss(STEREO_RECIPE, BATCH),
                optimizer_factory("adam_constant", LR, stereo_model),
                augmenter=augmentation_factory(AUGMENT_PROBS))
            stereo_generator = torch.Generator().manual_seed(0)
            stereo_counts, stereo_losses = run_steps("stereo train", stereo_train,
                                                     STEREO_PER_STEP, STEREO_TRAIN_STEPS,
                                                     (stereo_generator,))
            print(f"phase 16 stereo train (EfficientNetB5 + PoseNetImproved, MS recipe, default "
                  f"augmentation): {STEREO_TRAIN_STEPS} steps, launches "
                  f"{json.dumps(stereo_counts)} ({json.dumps(STEREO_PER_STEP)} per step), "
                  f"losses {json.dumps(stereo_losses)}", flush=True)
            report_rate("stereo train B5 MS recipe", stereo_train, (stereo_generator,))
            del stereo_model, stereo_train
            gc.collect()
            torch.cuda.empty_cache()

            # 17. one stereo train step on the card and on the CPU
            phase = clock("stereo train cross-check")
            f32_runs["stereo"] = _train_cross_check(
                17, checks["stereo"], device, ("depth_ms", "pose", "depth_ms_R", "pose_R",
                                               "pose_LR", "pose_RL"), STEREO_LOSS_TOL)

            # 18. stereo joint train: LOSS_RIGID_COMB, the flownet frozen
            phase = clock("stereo joint train")
            stereo_joint = ModelFactory(STEREO_KEYS, JOINT_NET, device=device, seed=0).get_model()
            flow_before = copy.deepcopy(stereo_joint.flownet.state_dict())
            stereo_joint_train = make_train_step(
                stereo_joint, make_stereo_loss(LOSS_RIGID_COMB, BATCH),
                optimizer_factory("adam_constant", LR, stereo_joint, frozen_nets=["flownet"]),
                frozen_nets=["flownet"])
            stereo_joint_counts, joint_losses = run_steps(
                "stereo joint train", stereo_joint_train, STEREO_JOINT_PER_STEP,
                STEREO_TRAIN_STEPS)
            flow_after = stereo_joint.flownet.state_dict()
            if any(not torch.equal(flow_before[k], flow_after[k]) for k in flow_before):
                raise AssertionError("the stereo joint step changed the frozen flownet")
            print(f"phase 18 stereo joint train (B5 + PoseNetImproved + PWCNet, "
                  f"LOSS_RIGID_COMB, flownet frozen): {STEREO_TRAIN_STEPS} steps, launches "
                  f"{json.dumps(stereo_joint_counts)} ({json.dumps(STEREO_JOINT_PER_STEP)} per "
                  f"step), the flownet bit-unchanged, losses {json.dumps(joint_losses)}",
                  flush=True)
            report_rate("stereo joint train B5+PWCNet LOSS_RIGID_COMB", stereo_joint_train)
            del stereo_joint, stereo_joint_train, flow_before, flow_after
            gc.collect()
            torch.cuda.empty_cache()

            # 19. the stereo flow row's step: LOSS_FLOW in full
            phase = clock("stereo flow train")
            stereo_flow = ModelFactory(STEREO_KEYS, FLOW_NET, device=device, seed=0).get_model()
            stereo_flow_train = make_train_step(
                stereo_flow, make_stereo_loss(LOSS_FLOW, BATCH),
                optimizer_factory("adam_constant", LR, stereo_flow), regularize_net="flownet")
            stereo_flow_counts, flow_losses = run_steps(
                "stereo flow train", stereo_flow_train, STEREO_FLOW_PER_STEP, 2)
            print(f"phase 19 stereo flow train (PWCNet, LOSS_FLOW): 2 steps, launches "
                  f"{json.dumps(stereo_flow_counts)} ({json.dumps(STEREO_FLOW_PER_STEP)} per "
                  f"step), losses {json.dumps(flow_losses)}", flush=True)
            del stereo_flow, stereo_flow_train
            gc.collect()
            torch.cuda.empty_cache()

            # 20. the stereo plan, its counts read from zero
            phase = clock("stereo plan")
            with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
                stereo_plan_counts, stereo_note = _stereo_plan_phase(
                    workdir, device, counts, zero_counts, tag)
            missing = [k for k in f32_kernels if stereo_plan_counts[k] == 0]
            if missing or any(stereo_plan_counts[k] for k in bf16_kernels):
                raise AssertionError(f"the stereo plan never launched {missing}: "
                                     f"{stereo_plan_counts}")
            print(f"phase 20 stereo plan: {stereo_note}; launches "
                  f"{json.dumps(stereo_plan_counts)}", flush=True)
            stereo_paths = {"stereo train": stereo_counts, "stereo joint train":
                            stereo_joint_counts, "stereo flow train": stereo_flow_counts,
                            "stereo plan": stereo_plan_counts}

            # 21. the bfloat16 correlation kernels against their plain versions
            phase = clock("bf16 correlation kernels vs plain")
            cstats16 = _corr_phase(device, tag, torch.bfloat16, cstats, earlier_levels)
            print(f"phase 21 {_band_corr_phase(device, tag, torch.bfloat16, cstats16)}",
                  flush=True)
            print("timing bf16 vs float32 correlation kernels, device ms per flow train step "
                  "(5 levels, graph replay, this call): " + "; ".join(
                      f"{k}-bf16 {cstats16[k]['ms']:.4f} (float32 {cstats[k]['ms']:.4f}"
                      + (f", earlier checkout {earlier[k + '-bf16']:.4f}"
                         if k + "-bf16" in earlier else "")
                      + f"), bound {cstats16[k]['bound_ms']:.4f} (float32 "
                      f"{cstats[k]['bound_ms']:.4f}), plain {cstats16[k]['plain_ms']:.4f}"
                      for k in ("K2", "K3", "K4")) + f" {tag}", flush=True)

            # 22. the bfloat16 steps at full width, each path's counts read from zero
            phase = clock("bf16 steps")
            bf16_per_step = _bf16_steps_phase(
                device, {"mono": gpu_batches, "mono uint8": train_batches,
                         "stereo uint8": stereo_train_batches},
                counts, zero_counts, all_kernels, f32_rates, rounds, steps, tag)

            # 23. one bfloat16 step of each stage against the float32 step, card and CPU
            phase = clock("bf16 cross-check")
            # the float32 steps of phases 7, 11, 14 and 17, on the same inputs
            notes = [_bf16_cross_check(check, device, f32_runs.pop(stage))
                     for stage, check in checks.items()]
            print(f"phase 23 bf16 cross-check (one step each at batch {CHECK_BATCH}, card bf16 "
                  f"vs card float32 held to CPU bf16 vs CPU float32, ratios "
                  f"{BF16_MEDIAN_RATIO}/{BF16_MAX_RATIO}): {' | '.join(notes)}", flush=True)

            # 24. the stereo plan at the default Config(), bfloat16, its
            # counts read from zero
            phase = clock("bf16 stereo plan")
            with tempfile.TemporaryDirectory(dir=_build_dir()) as workdir:
                bf16_plan_counts, bf16_note = _stereo_plan_phase(
                    workdir, device, counts, zero_counts, tag, compute_dtype=None)
            on_path = ["K1", "K1-bwd", *bf16_kernels]
            missing = [k for k in on_path if bf16_plan_counts[k] == 0]
            if missing or any(bf16_plan_counts[k] for k in ("K2", "K3", "K4")):
                raise AssertionError(f"the bf16 stereo plan launched {bf16_plan_counts}")
            print(f"phase 24 bf16 stereo plan (Config() default, compute_dtype bfloat16): "
                  f"{bf16_note}; launches {json.dumps(bf16_plan_counts)}", flush=True)
            bf16_paths = {f"bf16 {label}": {k: n * 2 for k, n in launches.items()}
                          for label, launches in bf16_per_step.items()}
            bf16_paths["bf16 stereo plan"] = bf16_plan_counts

            # 25. the kernels at the miniature plan's shapes
            phase = clock("kernels at the mini plan's shapes")
            mini_errs = _mini_plan_kernels(device, tag)

            # 26, 27. the miniature plan learns: this slice's main path,
            # each dtype's counts read from zero
            phase = clock("mini plan")
            t0 = time.perf_counter()
            learning = _learning_phase(device, counts, zero_counts, tag)
            mini_counts, bf16_mini_counts = learning["float32"][0], learning["bfloat16"][0]
            missing = [k for k in f32_kernels if mini_counts[k] == 0]
            if missing or any(mini_counts[k] for k in bf16_kernels):
                raise AssertionError(f"the float32 mini plan launched {mini_counts}")
            missing = [k for k in ("K1", "K1-bwd", *bf16_kernels) if bf16_mini_counts[k] == 0]
            if missing or any(bf16_mini_counts[k] for k in ("K2", "K3", "K4")):
                raise AssertionError(f"the bfloat16 mini plan launched {bf16_mini_counts}")
            print(f"phase 26-27 mini plan: launches float32 {json.dumps(mini_counts)}, "
                  f"bfloat16 {json.dumps(bf16_mini_counts)}; {time.perf_counter() - t0:.1f} s "
                  f"for both; the script so far {time.perf_counter() - t_script:.1f} s {tag}",
                  flush=True)
            paths_f32 = {"mini plan": mini_counts, "bf16 mini plan": bf16_mini_counts}

            # 28. the shard chain: the port's own shards, serially and over
            # the spawn pool, then a bfloat16 rigid row, predict and evaluate
            # on them, the counts read from zero
            phase = clock("shard chain")
            t0 = time.perf_counter()
            shard_counts, shard_note = _shard_phase(device, counts, zero_counts, tag)
            print(f"phase 28 shard chain: {shard_note}; launches {json.dumps(shard_counts)}; "
                  f"{time.perf_counter() - t0:.1f} s for the phase {tag}", flush=True)
            paths_f32["shard chain row"] = shard_counts

            # 29. the model zoo at full width: each other backbone's bf16
            # rigid step and its float32 cross-check, the other pose nets,
            # the md2/moa/md2cmb recipes, grad accumulation and remat
            phase = clock("model zoo")
            t0 = time.perf_counter()
            zoo_counts, zoo_note = _zoo_phase(device, counts, zero_counts, kstats, tag)
            print(f"phase 29 model zoo: {zoo_note}; launches {json.dumps(zoo_counts)}; "
                  f"{time.perf_counter() - t0:.1f} s for the phase {tag}", flush=True)
            paths_f32["model zoo"] = zoo_counts

            # 30. data parallel: train_main under torchrun, the two-rank and
            # one-rank-a-card steps against the one-process step, timings
            phase = clock("data parallel")
            t0 = time.perf_counter()
            ddp_paths, ddp_note = _ddp_phase(device, tag)
            print(f"{ddp_note}\nphase 30 data parallel: {time.perf_counter() - t0:.1f} s for "
                  f"the phase {tag}", flush=True)

            # 31. serving: exported artifacts loaded without the model code
            phase = clock("serving")
            t0 = time.perf_counter()
            serving_paths, serving_note = _serving_phase(device, tag)
            print(f"{serving_note}\nphase 31 serving: {time.perf_counter() - t0:.1f} s for "
                  f"the phase {tag}", flush=True)
            # 32. weights in, diagnostics out: a pretrained backbone file,
            # a bf16 rigid row from it, its debug evaluation, their counts
            # read from zero
            phase = clock("weights in, diagnostics out")
            t0 = time.perf_counter()
            pretrained_paths, pretrained_note = _pretrained_phase(device, counts, zero_counts,
                                                                  tag)
            print(f"phase 32 weights in, diagnostics out: {pretrained_note}; launches "
                  f"{json.dumps(pretrained_paths)}; {time.perf_counter() - t0:.1f} s for the "
                  f"phase {tag}", flush=True)
            extra_paths = ddp_paths | serving_paths | pretrained_paths

            # ms, plain_ms, library_ms, bound_ms: device time per train step,
            # summed over the scales or levels; launches: the mini plan run's
            # of the kernel's dtype (this slice's main path); max_abs_err:
            # over the headline shapes and the mini plan's
            report = []
            for kname, full_name, replaces in (
                    ("K1", "K1 warp_const_src_fwd", kernels.REPLACES),
                    ("K1-bwd", "K1-bwd warp_const_src_bwd", kernels.REPLACES_BWD)):
                s = kstats[kname]
                report.append({
                    "name": full_name, "route": "cuda", "source": kernels.SOURCE,
                    "replaces": replaces, "launches": mini_counts[kname],
                    "launches_by_path": {"predict+eval": eval_counts[kname],
                                         "train": train_counts[kname],
                                         "flow train": flow_train_counts[kname],
                                         "joint train": joint_counts[kname],
                                         "plan": plan_counts[kname]}
                    | {path: c[kname] for path, c in stereo_paths.items()}
                    | {path: c.get(kname, 0) for path, c in bf16_paths.items()}
                    | {path: c[kname] for path, c in paths_f32.items()}
                    | {path: c.get(kname, 0) for path, c in extra_paths.items()},
                    "max_abs_err": max(s["err"], n1_errs[kname], mini_errs[kname]),
                    "ms": s["ms"],
                    "plain_ms": s["plain_ms"],
                    "n1_ms": n1_times[kname], "n1_plain_ms": n1_times[f"{kname} plain"],
                    "n1_bound_ms": n1_times[f"{kname} bound"],
                    "bound_ms": s["bound_ms"],
                    "bound_by": _bound(s["bytes"], s["flops"])[1],
                    "library_ms": s["library_ms"], "earlier_ms": earlier.get(kname)}
                    | ({"redesigned_in": REDESIGNED[kname]} if kname in REDESIGNED else {}))
            for kname, full_name in (("K2", "K2 corr_fwd"), ("K3", "K3 corr_bwd_cl"),
                                     ("K4", "K4 corr_bwd_cr")):
                s = cstats[kname]
                report.append({
                    "name": full_name, "route": "cuda", "source": corr_kernels.SOURCE,
                    "replaces": corr_kernels.REPLACES[kname],
                    "launches": mini_counts[kname],
                    "launches_by_path": {"flow predict": flow_predict_counts[kname],
                                         "flow train": flow_train_counts[kname],
                                         "joint train": joint_counts[kname],
                                         "plan": plan_counts[kname]}
                    | {path: c[kname] for path, c in stereo_paths.items()}
                    | {path: c[kname] for path, c in paths_f32.items()}
                    | {path: c.get(kname, 0) for path, c in extra_paths.items()},
                    "max_abs_err": max(s["err"], mini_errs[kname]), "ms": s["ms"],
                    "plain_ms": s["plain_ms"],
                    "bound_ms": s["bound_ms"],
                    "bound_by": _bound(s["bytes"], s["flops"])[1],
                    "library_ms": None,
                    "library": "none: no single PyTorch call computes the cost volume",
                    "earlier_ms": earlier.get(kname)}
                    | ({"redesigned_in": REDESIGNED[kname]} if kname in REDESIGNED else {}))
            # the bfloat16 forms: launches from the bfloat16 stereo plan run
            for kname, full_name in (("K2", "K2-bf16 corr_fwd_bf16"),
                                     ("K3", "K3-bf16 corr_bwd_cl_bf16"),
                                     ("K4", "K4-bf16 corr_bwd_cr_bf16")):
                s = cstats16[kname]
                bname = f"{kname}-bf16"
                report.append({
                    "name": full_name, "route": "cuda", "source": bf16_kernels[bname].source,
                    "replaces": corr_kernels.REPLACES[kname],
                    "launches": bf16_mini_counts[bname],
                    "launches_by_path": {path: c.get(bname, 0)
                                         for path, c in bf16_paths.items()}
                    | {path: c[bname] for path, c in paths_f32.items()}
                    | {path: c.get(bname, 0) for path, c in extra_paths.items()},
                    "max_abs_err": max(s["err"], mini_errs[bname]),
                    "max_err_of_bound": s["ulps"], "ms": s["ms"],
                    "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                    "bound_by": _bound(s["bytes"], s["flops"], bf16=True)[1],
                    "library_ms": None,
                    "library": "none: no single PyTorch call computes the cost volume",
                    "float32_ms": cstats[kname]["ms"], "earlier_ms": earlier.get(bname)}
                    | ({"design": TENSOR_CORE_DESIGN} if bname in TENSOR_CORE_KERNELS else {}))
            clock("report")
            print(f"chip_smoke: the script took {time.perf_counter() - t_script:.1f} s {tag}",
                  flush=True)
            print(json.dumps({"kernels": report}), flush=True)
            print(smi, flush=True)
    except Exception:  # the boundary: report the failed phase, print no result
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        traceback.print_exc()
        return 1
    finally:
        _CPU_RUNS.stop()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
