"""The port's data-parallel joint step against the JAX package's:
EfficientNetB0 + PoseNetImproved + PWCNet under the md2cmb recipe with the
flownet frozen, two gloo ranks on a global batch of 4 at 64x128, held as
``test_torch_parallel.py`` holds the rigid step (whose helpers it uses).
md2cmb divides each sample's sum by the kept pixels of the WHOLE batch, so
the ranks' counts are summed: one rank's own count would make its terms
about twice JAX's. The frozen flownet gets no gradient on either side and
stays bit-unchanged.
"""

import pytest
import torch

from test_torch_parallel import (NETS_B0, _batch, check_against_jax, jax_and_port_case,
                                 run_two_ranks)

NETS = dict(NETS_B0, flow="PWCNet")
MD2CMB = {"md2cmbL1": 5.0, "md2cmbSSIM": 0.5, "smoothe": 20.0}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_two_ranks_match_jax_joint_md2cmb_step(tmp_path):
    keys, batch = _batch()
    jmodel, variables, case = jax_and_port_case(keys, batch, NETS, MD2CMB,
                                                {"frozen_nets": ("flownet",)})
    ranks = run_two_ranks({"joint md2cmb": case}, tmp_path)["joint md2cmb"]
    check_against_jax(jmodel, variables, case, ranks)
