"""The port's TFRecord -> shard migration (``data/migrate_tfrecords.py``)
against the JAX package's, on the fixture of
``tests/test_migrate_tfrecords.py`` (a miniature reference-format TFRecord
directory): the migrated shard directories are equal byte for byte, the
port's loader reads the examples back exactly, and a second run skips.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from test_migrate_tfrecords import reference_tfrecords  # noqa: E402,F401
from xpt_mde_tpu.data.migrate_tfrecords import migrate as j_migrate  # noqa: E402
from xpt_mde_tpu_torch.data.migrate_tfrecords import migrate, read_tfr_config  # noqa: E402
from xpt_mde_tpu_torch.data.shard_io import ShardDataset  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the test workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_migration_matches_jax(reference_tfrecords, tmp_path):  # noqa: F811
    tfr_dir, examples = reference_tfrecords
    with contextlib.redirect_stdout(io.StringIO()):
        out = migrate(tfr_dir, tmp_path / "port" / "kitti_raw_train", frames_per_shard=2)
        ref = j_migrate(tfr_dir, tmp_path / "jax" / "kitti_raw_train", frames_per_shard=2)
    assert out == tmp_path / "port" / "kitti_raw_train"
    ours, theirs = _files(out), _files(ref)
    assert len([name for name in ours if name.endswith(".vrec")]) == 3  # 5 examples, 2 a shard
    assert ours == theirs
    ds = ShardDataset(out)
    assert len(ds) == 5 and ds.config.get("imshape") == [5, 16, 32, 3]
    for i, ex in enumerate(examples):
        back = ds.read_example(i)
        for key, val in ex.items():
            assert np.array_equal(back[key], val), key
    assert read_tfr_config(tfr_dir)["length"] == 5
    with contextlib.redirect_stdout(io.StringIO()) as log:
        assert migrate(tfr_dir, out) == out
    assert "exists, skip" in log.getvalue()
    assert _files(out) == ours
