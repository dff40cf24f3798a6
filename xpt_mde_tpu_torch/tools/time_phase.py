"""Time chip_smoke.py's phases alone, in one or several checkouts, on the
card: each run is a process of its own, started from the checkout's root,
that imports that checkout's ``chip_smoke`` and package and calls the
phase's function, in the order given (e.g. parent, change, change, parent
to compare two trees in one call).

    python -m xpt_mde_tpu_torch.tools.time_phase --phase ddp . ../parent . ../parent

Phases: ``ddp`` (phase 30, ``_ddp_phase``), ``band_warp`` (phase 2's band
shapes, ``_band_warp_phase``, where the checkout has it) and ``band_corr``
(phases 8 and 21: the correlation kernels at the PWC levels, then on the
spatial mesh's bands, ``_band_corr_phase``, in float32 and bfloat16). Each run prints
the phase's own summary, then ``PHASE <name> <checkout> <seconds> s``, the
host seconds of the call (the checkout's kernels built before it, as the
whole script builds them in phase 1); exits 1 if a run fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

RUN = """
import sys, time
import numpy as np, torch
import chip_smoke as cs
from xpt_mde_tpu_torch.utils.precision import full_f32
from concurrent.futures import ThreadPoolExecutor
from xpt_mde_tpu_torch.ops.kernels import correlation as kc, warp as kw
phase, tag = sys.argv[1], f"[{cs._nvidia_smi_line()}]"
device = torch.device("cuda", 0)
# the checkout's kernels built first, outside the timed phase (the whole
# script builds them in phase 1)
with ThreadPoolExecutor(2) as pool:
    for future in [pool.submit(kw.K1.build), pool.submit(kc.K2.build)]:
        future.result()
for kernel in (kw.K1_BWD, kc.K3, kc.K4, *kc.kernels_for(torch.bfloat16)):
    kernel.build()
with full_f32():
    t0 = time.perf_counter()
    if phase == "ddp":
        _, note = cs._ddp_phase(device, tag)
    elif phase == "band_corr":
        notes = []
        for dtype in (torch.float32, torch.bfloat16):
            stats = cs._corr_phase(device, tag, dtype, phase_no=8 if dtype == torch.float32
                                   else 21)
            notes.append(cs._band_corr_phase(device, tag, dtype, stats))
        note = chr(10).join(notes)
    else:
        from xpt_mde_tpu_torch.data import SyntheticDataset
        batches = list(SyntheticDataset(batch_size=cs.BATCH, height=cs.HEIGHT, width=cs.WIDTH,
                                        num_batches=1, seed=0))
        note = cs._band_warp_phase(batches, device, np.random.RandomState(3), tag)
    seconds = time.perf_counter() - t0
print(note)
print(f"PHASE_SECONDS {seconds:.1f}", flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", choices=("ddp", "band_warp", "band_corr"), default="ddp")
    parser.add_argument("checkouts", nargs="+")
    args = parser.parse_args(argv)
    status = 0
    for checkout in args.checkouts:
        root = Path(checkout).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", RUN, args.phase], cwd=root, env=env,
                              capture_output=True, text=True)
        wall = time.perf_counter() - t0
        print(proc.stdout[-20000:], flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], flush=True)
            status = 1
        inner = [line.split()[1] for line in proc.stdout.splitlines()
                 if line.startswith("PHASE_SECONDS")]
        print(f"PHASE {args.phase} {checkout} {inner[0] if inner else 'failed'} s "
              f"(process {wall:.1f} s)", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
