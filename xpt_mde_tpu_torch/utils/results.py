"""The port's ledger of learning results (port of ``xpt_mde_tpu.utils.results``).

Each learning check (``tools/check_learns.py``, ``chip_smoke.py``'s
learning phase) appends one JSON line per run to ``RESULTS_torch.jsonl``
at the repository root, beside the JAX package's ``RESULTS.jsonl``, which
the port never writes. Each line carries what the numbers depend on: the
card's name and power limit (as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them), ``torch.version.cuda`` and the
compute dtype.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch

LEDGER = Path(__file__).resolve().parents[2] / "RESULTS_torch.jsonl"


def card() -> str:
    """The card's "name, power limit" line from ``nvidia-smi``, or why
    there is none."""
    if not torch.cuda.is_available():
        return "no CUDA device"
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"{torch.cuda.get_device_name(0)}, nvidia-smi failed: {exc}"
    if proc.returncode != 0 or not proc.stdout.strip():
        return f"{torch.cuda.get_device_name(0)}, nvidia-smi failed: {proc.stderr.strip()}"
    return proc.stdout.strip().splitlines()[0]


def record(check: str, payload: dict, compute_dtype: str, ledger=LEDGER) -> dict:
    """Append ``{check, date, card, cuda, compute_dtype, **payload}`` to
    ``ledger`` and print it as one JSON line. A failed write is reported
    and does not end the run that measured the numbers."""
    entry = {"check": check,
             "date": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
             "card": card(), "cuda": torch.version.cuda, "compute_dtype": compute_dtype,
             **payload}
    line = json.dumps(entry)
    try:
        with open(ledger, "a") as f:
            f.write(line + "\n")
    except OSError as exc:
        print(f"[results] ledger write failed: {exc}", flush=True)
    print(line, flush=True)
    return entry
