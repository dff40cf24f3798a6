"""Migrate the reference framework's TFRecords into the port's shards
(port of ``xpt_mde_tpu.data.migrate_tfrecords``).

Users of the reference hold datasets as TFRecord directories with a
``tfr_config.txt`` schema. This tool reads them with tf.data (TensorFlow
is needed only while it migrates) and rewrites them as fixed-record
shards (``data/shard_io.ShardWriter``), so prepared datasets work
without rerunning the data preparation:

    python -m xpt_mde_tpu_torch.data.migrate_tfrecords <tfrecord_dir> <shard_dir>
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.data.shard_io import ShardWriter
from xpt_mde_tpu_torch.utils.util_class import PathManager


def read_tfr_config(tfrecord_dir) -> dict:
    return json.loads((Path(tfrecord_dir) / "tfr_config.txt").read_text())


def iterate_tfrecord_examples(tfrecord_dir):
    """Yield the feature dicts of a reference TFRecord directory."""
    import tensorflow as tf

    config = read_tfr_config(tfrecord_dir)
    feature_keys = {k: v for k, v in config.items()
                    if isinstance(v, dict) and "parse_type" in v}
    spec = {key: tf.io.FixedLenFeature((), tf.string if info["parse_type"] == "tf.string"
                                       else tf.int64)
            for key, info in feature_keys.items()}
    dtypes = {"tf.uint8": tf.uint8, "tf.float32": tf.float32}
    files = sorted(str(p) for p in Path(tfrecord_dir).glob("*.tfrecord"))
    for raw in tf.data.TFRecordDataset(files):
        parsed = tf.io.parse_single_example(raw, spec)
        out = {}
        for key, info in feature_keys.items():
            if info["parse_type"] == "tf.string":
                decoded = tf.io.decode_raw(parsed[key], dtypes[info["decode_type"]])
                out[key] = np.asarray(decoded).reshape(info["shape"])
            else:
                out[key] = np.asarray(parsed[key])
        yield out


def migrate(tfrecord_dir, shard_dir, frames_per_shard: int = 2000) -> Path:
    """Convert one TFRecord directory into a shard directory, atomically
    (a ``__tmp`` directory renamed when complete); an existing
    ``shard_dir`` is left as it is."""
    shard_dir = Path(shard_dir)
    if shard_dir.exists():
        print(f"[migrate] exists, skip: {shard_dir}")
        return shard_dir
    config = read_tfr_config(tfrecord_dir)
    tmp = shard_dir.parent / (shard_dir.name + "__tmp")
    with PathManager(tmp) as pm:
        with ShardWriter(tmp, frames_per_shard) as writer:
            for example in iterate_tfrecord_examples(tfrecord_dir):
                writer.write(example)
            writer.write_config({k: v for k, v in config.items() if not isinstance(v, dict)})
        pm.set_ok()
    tmp.rename(shard_dir)
    print(f"[migrate] {tfrecord_dir} -> {shard_dir}")
    return shard_dir


if __name__ == "__main__":
    migrate(sys.argv[1], sys.argv[2])
