"""Build a CUDA source of ``csrc/`` into a ``ctypes``-loadable library.

The library goes to ``<repo>/build/kernels/<hash>/``, where the hash
covers the sources and the compiler flags, so an edited source rebuilds
and an unchanged one is reused. ``nvcc`` runs with ``-Xptxas -v``; its
register, shared-memory and spill report is kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load_library(name: str, sources: tuple[str, ...]) -> tuple[ctypes.CDLL, str]:
    """Compile ``sources`` (file names under ``csrc/``) unless already
    built, load the library and return it with the compiler's report."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        digest.update(path.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / f"{name}.log"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # a private temporary name, then an atomic rename: concurrent
        # processes building at the same time never load a half-written library
        tmp_path = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp_path),
               *(str(p) for p in paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp_path, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    return ctypes.CDLL(str(lib_path)), log
