"""The port's other pose nets and the backbone remat against the JAX
package: ``PoseNetDeep`` in float32 and bfloat16 at ``high_res`` False and
True; ``PoseNetPreTrained`` over every net of ``BACKBONE_NAMES``, held to
flax where JAX's runs on the 15-channel snippet and refused (ValueError at
build time) where JAX's cannot run; ``ModelFactory(remat_backbone=True)``
against the same step without it.

Weights: flax variables from ``jax.eval_shape`` filled from a seeded numpy
RandomState (``test_torch_models.random_variables``) and converted; inputs
seeded [-1, 1] snippets, 2 x 64 x 128, as the pipeline feeds them. The
pose nets run in eval mode (the BatchNorm running statistics): a
backbone's train-mode numerics are test_torch_backbones.py's.

Tolerances: float32 poses within rtol 1e-4 (atol 1e-5 of poses ~1e-2:
convolutions summed in another order through up to ~200 layers);
bfloat16 by the distance rule of test_torch_bf16_models.py; remat:
gradients and updated parameters within 1e-6 relative, BatchNorm running
statistics bit-equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16_models import _flax_pair, assert_bf16_distance
from test_torch_models import random_variables
from xpt_mde_tpu.models.backbones import BACKBONE_NAMES
from xpt_mde_tpu.models.backbones import backbone_factory as j_backbone_factory
from xpt_mde_tpu.models.pose_net import PoseNetDeep as JPoseNetDeep
from xpt_mde_tpu.models.pose_net import PoseNetPreTrained as JPoseNetPreTrained
from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.models.backbones import backbone_factory
from xpt_mde_tpu_torch.models.pose_net import PoseNetDeep, PoseNetPreTrained
from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
from xpt_mde_tpu_torch.utils.precision import full_f32

# the backbones whose preprocessing takes any channel count ("tf" mode)
FIFTEEN_CHANNELS = ["ResNet50V2", "MobileNetV2", "Xception", "NASNetMobile", "NASNetLarge"]


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


def _image5d(seed, batch=2, height=64, width=128):
    return np.random.RandomState(seed).uniform(
        -1, 1, (batch, 5, height, width, 3)).astype(np.float32)


@pytest.mark.parametrize("high_res", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_posenet_deep_matches_flax(dtype, high_res):
    x = _image5d(1 + high_res)
    if dtype == "float32":
        jnet = JPoseNetDeep(high_res)
        variables = random_variables(jnet, jnp.asarray(x), seed=3)
        ref = jax.jit(lambda v, a: jnet.apply(v, a))(variables, jnp.asarray(x))["pose"]
    else:
        variables, ref16, ref32 = _flax_pair(lambda d: JPoseNetDeep(high_res, dtype=d),
                                             jnp.asarray(x), seed=3)
    net = PoseNetDeep(5, high_res, torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    load_flax_variables(net, variables)
    # 18 convs and the pose head, 3 more with the high-resolution block
    assert sum(name.startswith("Conv_") for name, _ in net.named_children()) == 19 + 3 * high_res
    with torch.no_grad():
        got = net(torch.from_numpy(x))["pose"]
    assert tuple(got.shape) == (2, 4, 6) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    else:
        assert_bf16_distance(got, ref16["pose"], ref32["pose"], "PoseNetDeep pose")


@pytest.mark.parametrize("name", BACKBONE_NAMES)
def test_posenet_pretrained_matches_flax_or_refuses(name):
    """Where JAX's PoseNetPreTrained runs on the snippet's 15 channels the
    port's matches it; where JAX's fails (a 3-entry preprocessing constant
    meets 15 channels), the port raises ValueError at build time."""
    x = _image5d(4)
    jnet = JPoseNetPreTrained(j_backbone_factory(name, jnp.float32))
    if name not in FIFTEEN_CHANNELS:
        with pytest.raises(ValueError, match="broadcasting"):
            jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        with pytest.raises(ValueError, match="takes 3 channels, not 15"):
            backbone_factory(name, in_channels=15)
        with pytest.raises(ValueError, match="takes 3 channels, not 15"):
            ModelFactory(["image", "intrinsic"], {"camera": name}, stereo=False,
                         device="cpu").get_model()
        return
    variables = random_variables(jnet, jnp.asarray(x), seed=5)
    ref = jax.jit(lambda v, a: jnet.apply(v, a))(variables, jnp.asarray(x))["pose"]
    net = ModelFactory(["image", "intrinsic"], {"camera": name}, stereo=False,
                       device="cpu").get_model().posenet
    assert isinstance(net, PoseNetPreTrained) and net.backbone.in_channels == 15
    load_flax_variables(net, variables).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x))["pose"]
    assert tuple(got.shape) == (2, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_backbone_step_equals_the_plain_step(dtype):
    """One train step with the depth net's backbone checkpointed equals the
    step without: the backbone runs twice (forward, then the backward's
    recompute, which may stop early), the gradients and updated
    parameters agree within 1e-6 relative, and the BatchNorm running
    statistics took the forward's batch statistics once (bit-equal)."""
    dataset = SyntheticDataset(batch_size=2, height=64, width=128, num_batches=1, seed=6)
    keys = dataset.config_keys()
    batch = {k: torch.from_numpy(v) for k, v in next(iter(dataset)).items()}
    nets = {"depth": "MobileNetV2", "camera": "PoseNetBasic"}
    runs = {}
    for remat in (False, True):
        model = ModelFactory(keys, nets, stereo=False, compute_dtype=dtype, device="cpu",
                             seed=7, remat_backbone=remat).get_model()
        assert model.depthnet.remat_backbone == remat
        calls = []
        # a pre-hook: the recompute stops once it has what the backward needs
        model.depthnet.backbone.register_forward_pre_hook(lambda *args: calls.append(None))
        loss = loss_factory(keys, {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}, SCALE_WEIGHT_T1,
                            stereo=False, batch_size=2)
        step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-3, model))
        before = copy.deepcopy(model.state_dict())
        metrics = step(batch)
        assert len(calls) == 1 + remat  # the recompute ran: nothing ran unchecked
        runs[remat] = (metrics, {n: p.grad.clone() for n, p in model.named_parameters()},
                       model.state_dict(), before)
    (m0, g0, s0, b0), (m1, g1, s1, b1) = runs[False], runs[True]
    assert all(torch.equal(b0[k], b1[k]) for k in b0)  # one seed, one start
    assert float(m0["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    for name, grad in g0.items():
        scale = float(grad.abs().max())
        assert float((grad - g1[name]).abs().max()) <= 1e-6 * scale, name
    for key, value in s0.items():
        if key.endswith(("running_mean", "running_var")):
            assert torch.equal(value, s1[key]), key
            if key.startswith("depthnet.backbone"):
                assert not torch.equal(value, b0[key]), key  # folded in once, not zero times
        elif value.is_floating_point():
            scale = float(value.abs().max())
            assert float((value - s1[key]).abs().max()) <= 1e-6 * scale, key
