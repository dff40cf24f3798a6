"""The stereo ("MS") path of the port against the JAX package: the stereo
VodeModel (the right views, the stereo pose, the BatchNorm running
statistics after a train-mode forward that calls each net several
times), the wrapper choice, each stereo loss term with its gradient, and
the factory on the published stereo recipes.

Inputs and weights come from seeded numpy RandomStates and go, as the
same arrays, to both sides (weights through ``xpt_mde_tpu_torch.convert``).
Each test states its tolerance and why. The train steps of the stereo
recipes are in test_torch_stereo_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.config import (LOSS_FLOW, LOSS_RIGID_COMB, LOSS_RIGID_MD2, LOSS_RIGID_MOA,
                                LOSS_RIGID_T1, LOSS_RIGID_T2, SCALE_WEIGHT_T1, SCALE_WEIGHT_T2)
from xpt_mde_tpu.data.shard_maker import DEFAULT_DATA_KEYS
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.utils import image as jimage
from xpt_mde_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.utils import image as timage
from xpt_mde_tpu_torch.utils.precision import full_f32

NETS = {"depth": "EfficientNetB0", "camera": "PoseNetImproved", "flow": "PWCNet"}
BATCH, HEIGHT, WIDTH = 2, 64, 128
KITTI_KEYS = DEFAULT_DATA_KEYS["kitti_raw"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the forwards are heavy: two intra-op threads keep the test workers
    # that run beside this module from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    # parity is checked in full float32: TF32 off for cuBLAS and cuDNN
    with full_f32():
        yield


def _fill(shapes, seed):
    """A flax variable tree shaped like ``shapes``, filled from numpy:
    random BN statistics and scales too, so a swapped mapping shows."""
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean", "input_mean"):
            return (rng.randn(*sd.shape) * 0.05).astype(np.float32)
        return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stereo_forward():
    """The JAX and the port's stereo model (the three nets) on one stereo
    batch from the same weights: eval-mode predictions, train-mode
    predictions and the running statistics after the train-mode forward."""
    with full_f32():
        dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                                   num_batches=1, stereo=True, seed=6)
        keys = dataset.config_keys()
        batch = next(iter(dataset))
        jmodel = JModelFactory(keys, NETS).get_model()
        jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)),
                          7)
        ref_eval = _tree_np(jax.jit(lambda v, f: jmodel.apply(v, f, train=False))(
            variables, jfeats))
        ref_train, new_vars = jax.jit(lambda v, f: jmodel.apply(
            v, f, train=True, mutable=["batch_stats"]))(variables, jfeats)

        model = ModelFactory(keys, NETS, device="cpu").get_model()
        load_flax_variables(model, variables)
        feats = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            got_eval = model.eval()(feats)
            got_train = model.train()(feats)
    return dict(model=model, variables=variables, batch=batch, ref_eval=ref_eval,
                got_eval=got_eval,
                ref_train=_tree_np(ref_train), got_train=got_train,
                new_stats=_tree_np(new_vars["batch_stats"]))


def _assert_preds_close(got, ref, scaled_atol=0.0):
    """rtol 1e-4 (atol 1e-5), as test_torch_models.py holds whole nets:
    float32 through ~100 layers summed in another order; plus
    ``scaled_atol`` times the tensor's largest magnitude."""
    assert set(got) == set(ref)
    for key, want in ref.items():
        values = got[key] if isinstance(got[key], list) else [got[key]]
        wants = want if isinstance(want, list) else [want]
        assert len(values) == len(wants), key
        for g, w in zip(values, wants):
            assert tuple(g.shape) == w.shape, key
            atol = 1e-5 + scaled_atol * float(np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol, err_msg=key)


def test_stereo_model_forward_matches_jax(stereo_forward):
    """Every key of the stereo forward; the weights went through
    convert.py unchanged (the stereo model has the mono model's parameter
    tree, and the converter sets every tensor or raises)."""
    ref = stereo_forward["ref_eval"]
    want_keys = {k + sfx for k in ("depth_ms", "disp_ms", "debug_out", "pose", "flow_ms")
                 for sfx in ("", "_R")} | {"pose_LR", "pose_RL"}
    assert set(ref) == want_keys
    assert ref["pose_LR"].shape == ref["pose_RL"].shape == (BATCH, 4, 6)
    assert stereo_forward["model"].stereo and stereo_forward["model"].stereo_pose
    _assert_preds_close(stereo_forward["got_eval"], ref)


def test_stereo_train_forward_and_running_stats_match_flax(stereo_forward):
    """One train-mode forward calls the depth net twice and the posenet
    four times; each call folds its batch statistics into the running
    ones in turn, as flax's mutable batch_stats do."""
    # train-mode BatchNorm normalizes by the statistics of as few as 16
    # values per channel (B0's stride-32 map at batch 2), which magnifies
    # the float32 rounding of the layers before it: 1e-4 of the tensor's
    # largest value on top (the decoder's pre-activation maps differ by up
    # to 2.5e-5 of theirs)
    _assert_preds_close(stereo_forward["got_train"], stereo_forward["ref_train"], 1e-4)
    model, variables = stereo_forward["model"], stereo_forward["variables"]
    want = flax_to_state_dict({"params": variables["params"],
                               "batch_stats": stereo_forward["new_stats"]}, model)
    before = flax_to_state_dict(variables, model)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    moved = 0
    for key in stats:
        got = model.state_dict()[key].numpy()
        # as test_torch_train.py holds one call's update (atol 2e-5, rtol
        # 1e-5): several updates of weight 0.01 each, of batch statistics
        # that differ like the activations
        np.testing.assert_allclose(got, want[key].numpy(), atol=2e-5, rtol=1e-5, err_msg=key)
        moved += not np.array_equal(got, before[key].numpy())
    assert moved == len(stats)
    # a single train-mode call per net would leave other statistics: the
    # order and number of calls is what this test pins
    mono = ModelFactory(["image", "intrinsic"], NETS, stereo=False, device="cpu").get_model()
    load_flax_variables(mono, variables)
    with torch.no_grad():
        mono.train()({"image5d": torch.from_numpy(stereo_forward["batch"]["image5d"])})
    assert any(not np.allclose(mono.state_dict()[k].numpy(), want[k].numpy(), atol=2e-5,
                               rtol=1e-5) for k in stats)


@pytest.mark.parametrize("keys,nets,cfg_stereo", [
    (KITTI_KEYS, NETS, True),
    (KITTI_KEYS, NETS, False),                 # the extrinsic turns stereo on alone
    (KITTI_KEYS, {"flow": "PWCNet"}, True),     # no depth net: no stereo pose
    (KITTI_KEYS, {"flow": "PWCNet"}, False),
    (["image", "intrinsic", "image_R", "intrinsic_R"], NETS, True),
    (["image", "intrinsic", "image_R", "intrinsic_R"], NETS, False),
    (DEFAULT_DATA_KEYS["synthetic"], NETS, True),
])
def test_wrapper_choice_matches_jax(keys, nets, cfg_stereo):
    ref = JModelFactory(keys, nets, stereo=cfg_stereo).get_model()
    got = ModelFactory(keys, nets, stereo=cfg_stereo, device="meta").get_model()
    assert (got.stereo, got.stereo_pose) == (ref.stereo, ref.stereo_pose)


# --------------------------------------------------------------------------
# the stereo loss terms


def _loss_inputs(seed, height=32, width=64):
    """Stereo features and predictions: random snippets, depths, twists
    and flows; a right intrinsic unlike the left one (cross-synthesis must
    use the left one for both directions) and an extrinsic with a
    baseline and a small rotation."""
    rng = np.random.RandomState(seed)

    def k(fx):
        return np.tile(np.array([[fx, 0.0, width / 2], [0.0, fx, height / 2], [0, 0, 1]],
                                np.float32), (BATCH, 1, 1))

    t_lr = np.tile(np.eye(4, dtype=np.float32), (BATCH, 1, 1))
    t_lr[:, 0, 3] = 0.3
    t_lr[:, :3, :3] = np.array([[1.0, 0.0, 0.02], [0.0, 1.0, 0.0], [-0.02, 0.0, 1.0]],
                               np.float32)
    features = {"image5d": rng.uniform(-1, 1, (BATCH, 5, height, width, 3)),
                "image5d_R": rng.uniform(-1, 1, (BATCH, 5, height, width, 3)),
                "intrinsic": k(0.6 * width), "intrinsic_R": k(0.5 * width),
                "stereo_T_LR": t_lr}
    preds = {}
    for sfx in ("", "_R"):
        preds["depth_ms" + sfx] = [rng.uniform(2.0, 20.0, (BATCH, height >> s, width >> s, 1))
                                   for s in range(4)]
        preds["pose" + sfx] = rng.uniform(-0.05, 0.05, (BATCH, 4, 6))
        preds["flow_ms" + sfx] = [rng.uniform(-2, 2, (BATCH, 4, height >> s, width >> s, 2))
                                  for s in (2, 3, 4, 5)]
    preds["pose_LR"] = rng.uniform(-0.3, 0.3, (BATCH, 4, 6))
    preds["pose_RL"] = rng.uniform(-0.3, 0.3, (BATCH, 4, 6))
    def cast(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)

    return cast(features), cast(preds)


# the differentiated predictions of each term
TERMS = {"L1_R": ("depth_ms_R", "pose_R"), "SSIM_R": ("depth_ms_R", "pose_R"),
         "smoothe_R": ("depth_ms_R",), "cmbL1_R": ("depth_ms_R", "pose_R"),
         "cmbSSIM_R": ("depth_ms_R", "pose_R"), "flowL2_R": ("flow_ms_R",),
         "stereoL1": ("depth_ms", "depth_ms_R"), "stereoSSIM": ("depth_ms", "depth_ms_R"),
         "stereoPose": ("pose_LR", "pose_RL")}


def _flat(tree):
    return [x for v in tree for x in (v if isinstance(v, list) else [v])]


@pytest.fixture(scope="module")
def stereo_terms():
    """Every stereo term's value and gradients on both sides, from one
    TotalLoss holding all of them (one jitted JAX Jacobian, one torch
    graph): (jax values, jax gradients per term, torch values, torch
    gradients per term), gradients as {prediction key: flat list}."""
    features, preds = _loss_inputs(11)
    names = list(TERMS)
    diff_keys = sorted({k for keys in TERMS.values() for k in keys})
    recipe = dict.fromkeys(names, 1.0)
    weights = SCALE_WEIGHT_T2  # unequal scale weights, so a swapped scale shows
    jloss = j_loss_factory(KITTI_KEYS, recipe, weights, batch_size=BATCH)
    tloss = loss_factory(KITTI_KEYS, recipe, weights, batch_size=BATCH)
    assert list(tloss.loss_objects) == names

    def run(loss, diff, conv, recip):
        merged = {k: ([conv(x) for x in v] if isinstance(v, list) else conv(v))
                  for k, v in preds.items()}
        merged.update(diff)
        for sfx in ("", "_R"):
            merged["disp_ms" + sfx] = recip(merged["depth_ms" + sfx])
        return loss(merged, {k: conv(v) for k, v in features.items()})[1]

    def j_terms(diff):
        by_type = run(jloss, diff, jnp.asarray, jimage.safe_reciprocal_ms)
        return jnp.stack([by_type[n] for n in names])

    j_diff = {k: jax.tree_util.tree_map(jnp.asarray, preds[k]) for k in diff_keys}
    j_values, j_jac = jax.jit(lambda d: (j_terms(d), jax.jacrev(j_terms)(d)))(j_diff)
    j_grads = {n: {k: [np.asarray(g[i]) for g in _flat([j_jac[k]])] for k in diff_keys}
               for i, n in enumerate(names)}
    t_diff = {k: ([torch.tensor(x, requires_grad=True) for x in preds[k]]
                  if isinstance(preds[k], list) else torch.tensor(preds[k], requires_grad=True))
              for k in diff_keys}
    by_type = run(tloss, t_diff, torch.from_numpy, timage.safe_reciprocal_ms)
    t_grads = {}
    for n in names:
        grads = torch.autograd.grad(by_type[n], _flat([t_diff[k] for k in diff_keys]),
                                    retain_graph=True, allow_unused=True)
        grads = iter(grads)
        t_grads[n] = {k: [next(grads) for _ in _flat([t_diff[k]])] for k in diff_keys}
    return (dict(zip(names, np.asarray(j_values).tolist())), j_grads,
            {n: float(v.detach()) for n, v in by_type.items()}, t_grads)


@pytest.mark.parametrize("name", list(TERMS))
def test_stereo_loss_term_and_gradient_match_jax(name, stereo_terms):
    j_values, j_grads, t_values, t_grads = stereo_terms
    # the value: float32 chains of the same ops, rtol 1e-5
    np.testing.assert_allclose(t_values[name], j_values[name], rtol=1e-5, atol=1e-7)
    assert t_values[name] > 0
    for key in t_grads[name]:
        for i, (g, r) in enumerate(zip(t_grads[name][key], j_grads[name][key])):
            if key not in TERMS[name]:  # a prediction the term does not read
                assert g is None or not torch.any(g), (name, key)
                assert not np.any(r), (name, key)
                continue
            # per tensor: rtol 1e-4 of its norm, as test_torch_train.py holds
            # the total loss's (the reprojection divides by z: coordinates
            # carry ~1e-6 relative float32 error into the warps)
            err = float(np.linalg.norm(g.numpy() - r))
            assert err <= 1e-4 * float(np.linalg.norm(r)) + 1e-7, (name, key, i, err)
    for key in TERMS[name]:
        assert any(np.any(r) for r in j_grads[name][key]), (name, key)


@pytest.mark.parametrize("recipe_name", ["LOSS_RIGID_T1", "LOSS_RIGID_T2", "LOSS_RIGID_COMB",
                                         "LOSS_FLOW"])
def test_factory_keeps_every_term_of_the_stereo_recipes(recipe_name):
    recipe = {"LOSS_RIGID_T1": LOSS_RIGID_T1, "LOSS_RIGID_T2": LOSS_RIGID_T2,
              "LOSS_RIGID_COMB": LOSS_RIGID_COMB, "LOSS_FLOW": LOSS_FLOW}[recipe_name]
    got = loss_factory(KITTI_KEYS, recipe, SCALE_WEIGHT_T1)
    ref = j_loss_factory(KITTI_KEYS, recipe, SCALE_WEIGHT_T1)
    assert list(got.loss_weights.items()) == list(ref.loss_weights.items()) \
        == list(recipe.items())
    assert got.stereo and ref.stereo
    assert [type(v).__name__ for v in got.loss_objects.values()] \
        == [type(v).__name__ for v in ref.loss_objects.values()]


@pytest.mark.parametrize("recipe", [LOSS_RIGID_MOA, LOSS_RIGID_MD2])
def test_unported_stereo_recipes_raise_naming_the_roadmap(recipe):
    """The MD2 and MOA recipes, once refused, build the JAX loss objects
    (their terms and gradients: test_torch_zoo_losses.py)."""
    got = loss_factory(KITTI_KEYS, recipe, SCALE_WEIGHT_T1)
    ref = j_loss_factory(KITTI_KEYS, recipe, SCALE_WEIGHT_T1)
    assert list(got.loss_weights.items()) == list(ref.loss_weights.items()) \
        == list(recipe.items())
    assert [type(v).__name__ for v in got.loss_objects.values()] \
        == [type(v).__name__ for v in ref.loss_objects.values()]
