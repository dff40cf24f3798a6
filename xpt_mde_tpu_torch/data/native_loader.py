"""ctypes bridge to the native shard reader, and the prefetching loaders
(port of ``xpt_mde_tpu.data.native_loader``, copied so the port needs no
JAX).

``data/native/shard_reader.cpp`` is built with ``g++`` at first use into
``<repo>/build/native/<source hash>/`` (never beside the source, and
never loaded from a committed library). It gives:

- ``NativeShardReader``: mmap-backed multithreaded batch gather and
  uint8 -> float image decode;
- ``NativeDatasetLoader``: ``DatasetLoader`` with that gather;
- ``PrefetchLoader``: any loader behind a background thread and a
  bounded queue, so host batch assembly overlaps device compute;
- ``MultiWorkerLoader``: N threads build different batches, released in
  step order (the same stream as one thread).

``make_loader`` returns the native loader, or the numpy one where the
library cannot be built; the returned loader's ``kind`` says which.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import queue
import subprocess
import threading
from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.data.shard_io import MAGIC, DatasetLoader, ShardDataset

SOURCE = Path(__file__).resolve().parent / "native" / "shard_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the reader unless built already (the directory is named by a
    hash of the source and flags) and load it. Raises where ``g++`` fails."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out_dir / "libshardreader.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # a private name, then an atomic rename: concurrent builders never
        # load a half-written library
        tmp_path = out_dir / f"libshardreader.so.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp_path), str(SOURCE),
                               "-lpthread"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}")
        os.replace(tmp_path, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.sr_open.restype = ctypes.c_void_p
    lib.sr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.sr_num_records.restype = ctypes.c_int64
    lib.sr_num_records.argtypes = [ctypes.c_void_p]
    lib.sr_read_batch.restype = ctypes.c_int
    lib.sr_read_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int64, ctypes.c_void_p]
    lib.sr_decode_images.restype = None
    lib.sr_decode_images.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int]
    lib.sr_close.restype = None
    lib.sr_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeShardReader:
    """mmap + multithreaded gather over a shard directory."""

    def __init__(self, shard_dir, num_threads: int = 8):
        self.lib = load_library()
        self.num_threads = num_threads
        self.ds = ShardDataset(shard_dir)  # schema + length bookkeeping
        paths = sorted(Path(shard_dir).glob("shard_*.vrec"))
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        self.handle = self.lib.sr_open(arr, len(paths), self.ds.record_nbytes,
                                       len(MAGIC), num_threads)
        if not self.handle:
            raise RuntimeError(f"sr_open failed for {shard_dir}")
        if self.lib.sr_num_records(self.handle) != len(self.ds):
            raise RuntimeError(f"the native reader counts another number of records "
                               f"than {shard_dir}'s config")
        # per-key (offset, nbytes, dtype, shape) in record order
        self.layout = {}
        pos = 0
        for key in sorted(self.ds.schema.keys()):
            spec = self.ds.schema[key]
            dt = np.dtype(spec["dtype"])
            nbytes = int(dt.itemsize * np.prod(spec["shape"], dtype=np.int64))
            self.layout[key] = (pos, nbytes, dt, tuple(spec["shape"]))
            pos += nbytes

    def __len__(self):
        return len(self.ds)

    def read_batch(self, indices: np.ndarray, decode_images: bool = True) -> dict:
        n = len(indices)
        idx = np.ascontiguousarray(indices, np.int64)
        if n and (idx.min() < 0 or idx.max() >= len(self.ds)):
            raise IndexError(f"record index out of [0, {len(self.ds)})")
        out = np.empty((n, self.ds.record_nbytes), np.uint8)
        rc = self.lib.sr_read_batch(
            self.handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IndexError("sr_read_batch failed")
        batch = {}
        for key, (off, nbytes, dt, shape) in self.layout.items():
            field = np.ascontiguousarray(out[:, off:off + nbytes])
            if key.startswith("image") and decode_images:
                dec = np.empty(field.size, np.float32)
                self.lib.sr_decode_images(field.ctypes.data_as(ctypes.c_void_p),
                                          dec.ctypes.data_as(ctypes.c_void_p),
                                          field.size, self.num_threads)
                batch[key] = dec.reshape((n,) + shape)
            else:
                batch[key] = field.view(dt).reshape((n,) + shape)
        return batch

    def close(self):
        if getattr(self, "handle", None):
            self.lib.sr_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()


class NativeDatasetLoader(DatasetLoader):
    """DatasetLoader with the gather and decode in native code."""

    kind = "native"

    def __init__(self, shard_dir, batch_size: int, snippet_len: int = 5,
                 shuffle: bool = True, seed: int = 0, num_threads: int = 8,
                 process_index: int = 0, process_count: int = 1,
                 raw_images: bool = False, microbatches: int = 1):
        self.native = NativeShardReader(shard_dir, num_threads)
        super().__init__(self.native.ds, batch_size, snippet_len, shuffle, seed,
                         process_index=process_index, process_count=process_count,
                         raw_images=raw_images, microbatches=microbatches)

    def config_keys(self):
        return self.ds.keys()

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_step: int):
        """Epoch iterator from batch ``start_step`` (the skipped batches
        cost nothing: the shuffle order is sliced)."""
        order = self._epoch_order()
        for start in range(start_step * self.batch_size,
                           self.steps_per_epoch * self.batch_size, self.batch_size):
            idxs = order[start:start + self.batch_size]
            yield self._format_batch(
                self.native.read_batch(idxs, decode_images=not self.raw_images))

    def example_batch(self) -> dict:
        idxs = np.arange(min(self.batch_size, len(self.ds)), dtype=np.int64)
        return self._format_batch(
            self.native.read_batch(idxs, decode_images=not self.raw_images))


class PrefetchLoader:
    """Wrap any iterable loader with a background producer thread."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return self.loader.steps_per_epoch

    def __iter__(self):
        return self._iter(self.loader)

    def iter_from(self, start_step: int):
        """Resume-aware epoch iterator (the wrapped loader slices its order
        where it can; else the first ``start_step`` batches are discarded)."""
        if hasattr(self.loader, "iter_from"):
            return self._iter(self.loader.iter_from(start_step))
        return self._iter(itertools.islice(iter(self.loader), start_step, None))

    def _iter(self, source):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in source:
                    if not put(item):
                        return  # the consumer abandoned the iterator
            except Exception as e:  # handed to the consumer, raised there
                err.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            # abandoning mid-epoch must not leave the producer blocked on
            # the full queue
            stop.set()
            thread.join()


class MultiWorkerLoader:
    """Order-preserving multi-threaded batch producer: ``workers`` threads
    build different batches (the native gather releases the GIL) and a
    sequencer releases them in step order, so the stream equals the
    single-threaded loader's.

    :param workers: concurrent batch builders
    :param depth: most batches built but not yet delivered
    """

    def __init__(self, loader, workers: int = 4, depth: int = 8):
        self.loader = loader
        self.workers = workers
        self.depth = max(depth, workers)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self):
        return self.loader.steps_per_epoch

    def __iter__(self):
        return self.iter_from(0)

    def _build(self, order, step):
        idxs = order[step * self.loader.batch_size:(step + 1) * self.loader.batch_size]
        raw = self.loader.native.read_batch(idxs, decode_images=not self.loader.raw_images)
        return self.loader._format_batch(raw)

    def iter_from(self, start_step: int):
        order = self.loader._epoch_order()
        steps = self.loader.steps_per_epoch
        lock = threading.Lock()
        ready = threading.Condition(lock)
        results: dict = {}
        state = {"next_task": start_step, "next_emit": start_step, "stop": False}
        errors: list = []

        def worker():
            while True:
                with lock:
                    while (not state["stop"] and state["next_task"] < steps
                           and state["next_task"] - state["next_emit"] >= self.depth):
                        ready.wait(timeout=0.1)
                    if state["stop"] or state["next_task"] >= steps:
                        return
                    step = state["next_task"]
                    state["next_task"] += 1
                try:
                    batch = self._build(order, step)
                except Exception as e:  # handed to the consumer, raised there
                    with lock:
                        errors.append(e)
                        state["stop"] = True
                        ready.notify_all()
                    return
                with lock:
                    results[step] = batch
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.workers)]
        for t in threads:
            t.start()
        try:
            for step in range(start_step, steps):
                with lock:
                    while step not in results and not errors:
                        ready.wait(timeout=0.1)
                    if errors:
                        raise errors[0]
                    batch = results.pop(step)
                    state["next_emit"] = step + 1
                    ready.notify_all()
                yield batch
        finally:
            with lock:
                state["stop"] = True
                ready.notify_all()
            for t in threads:
                t.join()


def make_loader(shard_dir, batch_size: int, snippet_len: int = 5,
                shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                process_index: int = 0, process_count: int = 1,
                raw_images: bool = False, workers: int = 1, microbatches: int = 1):
    """The native loader behind a prefetch thread (``workers > 1``: the
    multi-threaded one), else the numpy loader where the native library
    cannot be built. The result's ``kind`` is ``"native"`` or ``"numpy"``.

    ``batch_size`` is per process (``microbatches``: ``DatasetLoader``'s);
    ``raw_images`` ships ``image5d`` as
    uint8, which the train, eval and predict steps decode on the device."""
    try:
        load_library()
    except (OSError, RuntimeError) as e:
        print(f"[make_loader] native loader unavailable ({e}); numpy path")
        loader = DatasetLoader(ShardDataset(shard_dir), batch_size, snippet_len, shuffle,
                               seed, process_index=process_index,
                               process_count=process_count, raw_images=raw_images,
                               microbatches=microbatches)
    else:
        loader = NativeDatasetLoader(shard_dir, batch_size, snippet_len, shuffle, seed,
                                     num_threads=max(2, 8 // max(workers, 1)),
                                     process_index=process_index,
                                     process_count=process_count, raw_images=raw_images,
                                     microbatches=microbatches)
        if workers > 1:
            return MultiWorkerLoader(loader, workers=workers,
                                     depth=max(2 * workers, prefetch))
    if prefetch > 0:
        return PrefetchLoader(loader, prefetch)
    return loader
