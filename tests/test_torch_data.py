"""The port's copies of the reference's constants and synthetic data.

``xpt_mde_tpu_torch.config`` and ``xpt_mde_tpu_torch.data`` are copies,
so the port runs without the JAX package. They must stay exact: every
constant equal, every batch equal bit for bit for a given seed.
"""

import numpy as np
import pytest

from xpt_mde_tpu import config as jconfig
from xpt_mde_tpu.data import SyntheticDataset as JSyntheticDataset
from xpt_mde_tpu.models import flow_net as j_flow_net
from xpt_mde_tpu_torch import config
from xpt_mde_tpu_torch.data import SyntheticDataset


@pytest.mark.parametrize("name", ["SNIPPET_LEN", "NUM_SRC", "SCALE_WEIGHT_T1",
                                  "SCALE_WEIGHT_T2", "RIGID_NET", "FLOW_NET", "LOSS_FLOW"])
def test_config_constant_matches_jax(name):
    assert getattr(config, name) == getattr(jconfig, name)


def test_max_displacement_matches_jax():
    assert config.MAX_DISPLACEMENT == j_flow_net.MAX_DISPLACEMENT


@pytest.mark.parametrize("options", [
    dict(),
    dict(seed=3, batch_size=3, height=16, width=40, num_batches=2),
    dict(seed=7, batch_size=1, height=64, width=128, num_batches=1),
    dict(seed=1, height=9, width=13, num_batches=3),
    # the stereo world: right views, their copies of K and the poses, T_LR
    dict(stereo=True),
    dict(stereo=True, seed=4, batch_size=3, height=16, width=40, num_batches=2,
         baseline_m=0.54),
])
def test_synthetic_batches_match_jax(options):
    ours = SyntheticDataset(**options)
    ref = JSyntheticDataset(**options)
    assert len(ours) == len(ref)
    assert ours.config_keys() == ref.config_keys()
    batches = list(zip(ours, ref, strict=True))
    assert len(batches) == len(ref)
    for got, want in batches:
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
