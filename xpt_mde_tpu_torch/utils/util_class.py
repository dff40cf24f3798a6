"""Infra classes: transactional output directories, timing, input errors
(port of ``xpt_mde_tpu.utils.util_class``, copied so the port needs no
JAX).

Every output directory is transactional (removed on abnormal exit unless
marked ok), and per-frame data errors are recoverable skips rather than
aborts.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path


class RecoverableSkip(Exception):
    """Raised by data readers for frames that should be skipped (static
    scene, night frame, missing pose, ...). Caught by maker loops."""


class WrongInputError(Exception):
    """Unrecoverable configuration / input error."""


class PathManager:
    """Context manager for atomic output directories.

    Creates ``path`` on enter; if the block exits without ``set_ok()``
    having been called, the directory tree is removed so partial outputs
    never survive. Used by shard builders, prediction and eval writers.
    """

    def __init__(self, path, closer_func=None):
        self.path = Path(path)
        self.safe_exit = False
        self.closer = closer_func

    def __enter__(self):
        self.path.mkdir(parents=True, exist_ok=True)
        return self

    def set_ok(self):
        self.safe_exit = True

    def __exit__(self, exc_type, exc_val, exc_tb):
        if not self.safe_exit:
            print(f"[PathManager] not ok, removing: {self.path}")
            if self.closer:
                self.closer()
            if self.path.is_dir():
                shutil.rmtree(self.path, ignore_errors=True)
        return False


class DurationTime:
    """Context manager measuring wall time in seconds into ``.duration``."""

    def __init__(self):
        self.start = 0.0
        self.duration = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.duration = time.perf_counter() - self.start
        return False
