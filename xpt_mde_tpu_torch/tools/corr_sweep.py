"""Time the correlation kernels K2 and K4, and the bfloat16 K3-bf16, under
other launch plans than their own, at the flow stage's five PWC-Net
levels, on one CUDA card.

Usage, from the repository root:

    python -m xpt_mde_tpu_torch.tools.corr_sweep [--levels 2,3] [--kernels K2,K4,K3-bf16]

For K2 it tries its plan's tile and half of it, each displacement-row
staging (one row a stage, or all in-frame rows at once) and a range of
channel-group counts; for K4 every channel-block count with both
stagings; for K3-bf16 every channel-block count (of 16 channels) with
every count of rows a stage. Each float32 variant is checked against the
plain version (within 1e-5 of the largest plain value), each K3-bf16
variant against its own plan's bits (the sums' order does not depend on
the plan), and each is timed as the mean device time of 20 launches
replayed from one CUDA graph. One line per variant, the kernel's own plan
marked ``plan``, each tagged with the card's name and power limit. It
fails without a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from xpt_mde_tpu_torch.config import NUM_SRC
from xpt_mde_tpu_torch.models.flow_net import ENCODER_CHANNELS, level_displacement
from xpt_mde_tpu_torch.ops import correlation as corr
from xpt_mde_tpu_torch.ops.kernels import correlation as kcorr

PAIRS, HEIGHT, WIDTH = 8 * NUM_SRC, 128, 512
K2_GROUPS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 49, 64)


def _graph_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call of ``fn``, ``iters`` calls replayed from one
    CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def k2_variants(channels, height, width, md, stride):
    """K2 launches to time: the plan's tile and half of it, one
    displacement row a stage or every in-frame row at once, each channel
    group count that fits 256 threads and 227 KB."""
    plan_tile = kcorr.fwd_plan(1, channels, height, width, md, stride)["tile_x"]
    cluster = kcorr.PIX * stride
    n = kcorr.num_displacements(md, stride)
    tiles = {plan_tile, max(cluster, plan_tile // 2 // cluster * cluster)}
    for tile_x in sorted(tiles, reverse=True):
        groups = tile_x // kcorr.PIX
        for rows in sorted({1, kcorr.rows_max(n, stride, height)}):
            for chan_groups in K2_GROUPS:
                if chan_groups > channels or groups * rows * chan_groups > kcorr.MAX_THREADS:
                    continue
                launch = kcorr.fwd_launch(channels, height, width, md, stride, tile_x, rows,
                                          chan_groups)
                if launch["smem_bytes"] <= kcorr.SMEM_LIMIT:
                    yield launch


def k4_variants(batch, channels, height, width, md, stride):
    """K4 launches to time: the plan's tile and skew with each channel
    block count (fewer channels a block, more blocks) and staging."""
    plan = kcorr.bwd_plan(batch, channels, height, width, md, stride)
    n = kcorr.num_displacements(md, stride)
    most = kcorr.rows_max(n, stride, height)
    all_blocks = -(-channels // kcorr.BWD_CHAN)
    for chan_blocks in range(1, all_blocks + 1):
        if chan_blocks * plan["tile_x"] // kcorr.PIX > kcorr.MAX_THREADS:
            break
        for rows in sorted({1, most}):
            buffers = 1 if rows >= most else 2
            smem = kcorr.bwd_smem_bytes(plan["tile_x"], chan_blocks, n, stride, plan["cb_skew"],
                                        rows, buffers)
            working = chan_blocks * plan["tile_x"] // kcorr.PIX
            if smem <= kcorr.SMEM_LIMIT:
                yield dict(plan, chan_blocks=chan_blocks, rows_per_stage=rows, buffers=buffers,
                           smem_bytes=smem,
                           threads=max(kcorr.MIN_THREADS, -(-working // 32) * 32))


def k3_bf16_variants(channels, height, width, md, stride):
    """K3-bf16 launches to time: its plan's tile with each channel block
    count that fits 8 warps and each count of rows a stage, within 227
    KB."""
    tile_x = kcorr.bwd_cl_plan_bf16(1, channels, height, width, md, stride)["tile_x"]
    n = kcorr.num_displacements(md, stride)
    most = min(kcorr.rows_max(n, stride, height), kcorr.BF16_ROWS_PER_STAGE)
    for chan_blocks in range(1, min(-(-channels // 16), kcorr.TMA_BOX // 16) + 1):
        warps = tile_x // kcorr.BF16_TILE_P * -(-chan_blocks // kcorr.BF16_GROUP_BLOCKS)
        for rows in range(1, most + 1):
            smem = kcorr.bwd_cl_bf16_layout(stride, n, tile_x, chan_blocks, rows,
                                            height)["total"]
            if warps <= kcorr.BF16_MAX_WARPS and smem <= kcorr.SMEM_LIMIT:
                yield {"tile_x": tile_x, "chan_blocks": chan_blocks, "rows_per_stage": rows,
                       "threads": 32 * warps, "smem_bytes": smem}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--levels", default="6,5,4,3,2")
    parser.add_argument("--kernels", default="K2,K4")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("corr_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    device = torch.device("cuda", 0)
    generator = torch.Generator().manual_seed(2)
    kernels = args.kernels.split(",")
    for level in (int(v) for v in args.levels.split(",")):
        md, stride = level_displacement(level)
        shape = (PAIRS, ENCODER_CHANNELS[level - 1], HEIGHT >> level, WIDTH >> level)
        cl, cr = ((torch.rand(shape, generator=generator) * 2 - 1).to(device) for _ in range(2))
        n2 = corr.correlation_channels(md, stride)
        g = (torch.rand((PAIRS, n2) + shape[2:], generator=generator) * 2 - 1).to(device)
        runs = []
        if "K2" in kernels:
            ref = corr.correlation_cost_plain(cl, cr, md, stride)
            out = torch.empty_like(ref)
            own = kcorr.fwd_plan(*shape, md, stride)
            runs += [("K2", ref, out, launch, own,
                      lambda launch=launch, out=out: kcorr.K2.launch(cl, cr, out, md, stride,
                                                                     launch))
                     for launch in k2_variants(*shape[1:], md, stride)]
        if "K4" in kernels:
            ref = corr.correlation_grad_cr_plain(g, cl, md, stride)
            out = torch.empty_like(ref)
            own = kcorr.bwd_plan(*shape, md, stride)
            runs += [("K4", ref, out, launch, own,
                      lambda launch=launch, out=out: kcorr.K4.launch(g, cl, out, md, stride,
                                                                     launch))
                     for launch in k4_variants(*shape, md, stride)]
        if "K3-bf16" in kernels:
            g16, cr16 = g.to(torch.bfloat16), cr.to(torch.bfloat16)
            ref = kcorr.K3_BF16(g16, cr16, md, stride)
            out = torch.empty_like(ref)
            own = kcorr.bwd_cl_plan_bf16(*shape, md, stride)
            runs += [("K3-bf16", ref, out, launch, own,
                      lambda launch=launch, out=out: kcorr.K3_BF16.launch(g16, cr16, out, md,
                                                                          stride, launch))
                     for launch in k3_bf16_variants(*shape[1:], md, stride)]
        for name, ref, out, launch, own, fn in runs:
            fn()
            torch.cuda.synchronize()
            if name == "K3-bf16":
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} at L{level} with {launch} changed the bits")
            else:
                err = float((out - ref).abs().max())
                if not err <= 1e-5 * float(ref.abs().max()):
                    raise AssertionError(f"{name} at L{level} with {launch} differs by {err}")
            keys = {"K2": kcorr.FWD_LAUNCH_KEYS, "K4": kcorr.BWD_LAUNCH_KEYS,
                    "K3-bf16": kcorr.BWD_BF16_LAUNCH_KEYS}[name]
            mark = " plan" if all(launch[k] == own[k] for k in keys) else ""
            print(f"sweep {name} L{level} {' '.join(f'{k} {launch[k]}' for k in keys)}: "
                  f"{_graph_ms(fn):.4f} ms{mark} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
