"""The port's keras-twin backbones in bfloat16, the JAX package's default
compute dtype, against the flax ones with ``dtype=jnp.bfloat16``:
ResNet50V2, MobileNetV2, VGG16, DenseNet121, Xception, NASNetMobile and
NASNetLarge, the 5 taps in eval mode.

Weights as in test_torch_backbones.py (eval_shape'd flax variables filled
from numpy, converted); the input a bfloat16 image, as the depth net
hands the backbone one, of seeded uniform [0, 255) values at 2 x 64 x
128 (why [0, 255): test_torch_backbones.py).

Tolerance, the distance rule of test_torch_bf16_models.py: the port's
bfloat16 tap at most 2x (median) / 4x (max) as far from JAX's bfloat16 tap
as that is from JAX's float32 tap on the same input, elementwise, plus
1e-6 of the tap's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16_models import _bf16_round, _flax_pair, _nchw, _nhwc, assert_bf16_distance
from xpt_mde_tpu.models.backbones import backbone_factory as j_backbone_factory
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.models.backbones import backbone_factory
from xpt_mde_tpu_torch.utils.precision import full_f32

ZOO = ["ResNet50V2", "MobileNetV2", "VGG16", "DenseNet121", "Xception", "NASNetMobile",
       "NASNetLarge"]
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # four intra-op threads: the workers beside this module share the
    # cores, and the CPU's summation order stays the same on any host
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    with full_f32():
        yield


@pytest.mark.parametrize("name", ZOO)
def test_bf16_backbone_matches_flax(name):
    seed = ZOO.index(name)
    x = _bf16_round(np.random.RandomState(seed).uniform(0, 255, (2, 64, 128, 3))
                    .astype(np.float32))
    variables, ref16, ref32 = _flax_pair(lambda d: j_backbone_factory(name, d),
                                         jnp.asarray(x, jnp.bfloat16), False, seed=seed + 1)
    net = load_flax_variables(backbone_factory(name, BF16), variables).eval()
    with torch.no_grad():
        got = net(_nchw(x, BF16))
    assert len(got) == 5
    for i, (g, r16, r32) in enumerate(zip(got, ref16, ref32)):
        # bfloat16, but NASNet's last tap: flax's count-excluding average
        # pool divides by float32 counts, and the cells' sums promote
        want = jnp.float32 if name.startswith("NASNet") and i == 4 else jnp.bfloat16
        assert r16.dtype == want and str(g.dtype) == f"torch.{jnp.dtype(want).name}"
        assert_bf16_distance(_nhwc(g), r16, r32, f"{name} tap {i}")
    assert {p.dtype for p in net.parameters()} == {torch.float32}
