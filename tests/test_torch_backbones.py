"""The port's keras-twin backbones against the JAX package's flax ones:
ResNet50V2, MobileNetV2, VGG16, DenseNet121, Xception, NASNetMobile and
NASNetLarge (``xpt_mde_tpu_torch/models/backbones/``), in float32.

Weights: the flax variable tree (``jax.eval_shape`` of ``init``) filled
from a seeded numpy RandomState (``test_torch_models.random_variables``:
random BatchNorm statistics and scales too), converted into the port's
module; the converter must map every leaf and set every tensor.

Inputs: seeded uniform [0, 255) images, 2 x 64 x 128 (the stride-32 map
2 x 4). The pipeline feeds [-1, 1] floats, which the "tf"-mode nets map
to -1 +- 0.008: every channel of the stem is then nearly constant, and a
train-mode BatchNorm there loses ~4 digits in flax's E[x^2] - E[x]^2
(the port's float32 lands 100x nearer a float64 run); [0, 255) is the
range the keras preprocessing expects and keeps both sides well
conditioned. The JAX modules run under ``jax.jit``.

Tolerances: each of the 5 taps in eval mode within 1e-4 x its largest
|value| (float32 convolutions summed in another order through up to ~200
layers: the measured worst is ~2e-6), and each BatchNorm running
statistic after one train-mode forward within 1e-4 x the largest |value|
of that tensor (worst ~1e-5, NASNetLarge's last stage).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables
from xpt_mde_tpu.models.backbones import backbone_factory as j_backbone_factory
from xpt_mde_tpu_torch.convert import flax_to_state_dict
from xpt_mde_tpu_torch.models.backbones import BACKBONE_NAMES, backbone_factory
from xpt_mde_tpu_torch.tools import zoo_precision
from xpt_mde_tpu_torch.utils.precision import full_f32

ZOO = ["ResNet50V2", "MobileNetV2", "VGG16", "DenseNet121", "Xception", "NASNetMobile",
       "NASNetLarge"]
TAP_TOL = STAT_TOL = 1e-4


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


def _images(seed, batch=2, height=64, width=128):
    return np.random.RandomState(seed).uniform(0, 255, (batch, height, width, 3)).astype(
        np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_backbone_names_are_the_jax_zoo():
    from xpt_mde_tpu.models.backbones import BACKBONE_NAMES as J_NAMES
    assert BACKBONE_NAMES == J_NAMES
    with pytest.raises(ValueError, match="unknown backbone"):
        backbone_factory("ResNet18")
    with pytest.raises(ValueError, match="unknown backbone"):
        j_backbone_factory("ResNet18", jnp.float32)


@pytest.mark.parametrize("name", ZOO)
def test_backbone_matches_flax(name):
    x = _images(ZOO.index(name))
    jnet = j_backbone_factory(name, jnp.float32)
    variables = random_variables(jnet, jnp.asarray(x), True, seed=ZOO.index(name) + 1)
    ref = jax.jit(lambda v, a: jnet.apply(v, a, False))(variables, jnp.asarray(x))
    _, new_state = jax.jit(lambda v, a: jnet.apply(v, a, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))

    net = backbone_factory(name, torch.float32)
    # the converter covers the tree: every leaf maps to one tensor, every
    # tensor is set (BatchNorm's num_batches_tracked has no flax leaf)
    state = flax_to_state_dict(variables, net)
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == len(jax.tree_util.tree_leaves(variables)) + n_bn \
        == len(net.state_dict())
    net.load_state_dict(state, strict=True)

    with torch.no_grad():
        got = net.eval()(_nchw(x))
    assert len(got) == 5
    assert net.out_channels == [int(r.shape[-1]) for r in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.permute(0, 2, 3, 1).numpy(), np.asarray(r)
        assert g.shape == r.shape == (2, 32 >> i, 64 >> i, r.shape[-1]), (i, g.shape, r.shape)
        err = float(np.abs(g - r).max())
        assert err <= TAP_TOL * float(np.abs(r).max()), (name, i, err)

    # one train-mode forward folds the biased batch statistics in, as flax
    with torch.no_grad():
        net.train()(_nchw(x))
    want = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, {**variables, **new_state}), net)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * n_bn and (name == "VGG16") == (n_bn == 0)
    for key in stats:
        got_stat, want_stat = net.state_dict()[key], want[key]
        err = float((got_stat - want_stat).abs().max())
        assert err <= STAT_TOL * float(want_stat.abs().max()), (name, key, err)
        assert not torch.equal(want_stat, state[key]), key  # the forward moved it


def test_zoo_precision_report_on_the_cpu():
    """``tools/zoo_precision.py`` on its CPU setting: VGG16's float32
    gradients (no BatchNorm, a well-conditioned backward) within 1e-2 of
    float64 at the median and the worst tensor."""
    image = zoo_precision.check_image(32, 64)
    assert tuple(image.shape) == (2, 3, 32, 64) and float(image.min()) >= 0.0
    line = zoo_precision.report("VGG16", image, zoo_precision.SETTINGS[:1])
    median, worst = (float(v) for v in line.rsplit("cpu ", 1)[1].split(" / "))
    assert line.startswith("VGG16: ") and median <= worst <= 1e-2, line
