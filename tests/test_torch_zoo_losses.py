"""The md2, md2cmb and moa loss families of the port against the JAX
package (``losses/total.py``): ``md2L1``, ``md2SSIM``, ``md2cmbL1``,
``md2cmbSSIM``, ``moaL1``, ``moaSSIM`` and their ``_R`` twins, each term's
value and its gradient with respect to every prediction, and the factory
on the published recipes that use them (``LOSS_RIGID_MD2``,
``LOSS_RIGID_MOA``, ``LOSS_RIGID_MOA_WST``) on mono and stereo keys.

Inputs: ``test_torch_stereo._loss_inputs`` (seeded random stereo snippets,
depths, twists and flows; a right intrinsic unlike the left one; an
extrinsic with a baseline and a small rotation), as the same arrays to
both sides; the JAX gradients from one jitted Jacobian of all the terms.

Tolerances, those of test_torch_stereo.py's terms: values rtol 1e-5;
gradients per tensor within 1e-4 of the reference's norm (the
reprojection divides by z, so the warps carry ~1e-6 relative float32
error). A prediction a term does not differentiate (the flows in md2cmb
reach it only through its outlier mask) gets zero gradient on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_stereo import KITTI_KEYS, _flat, _loss_inputs
from xpt_mde_tpu.config import (LOSS_RIGID_MD2, LOSS_RIGID_MOA, LOSS_RIGID_MOA_WST,
                                SCALE_WEIGHT_T2)
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.utils import image as jimage
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.utils import image as timage
from xpt_mde_tpu_torch.utils.precision import full_f32

BATCH = 2
# each term and the predictions it differentiates
TERMS = {}
for _family in ("md2", "md2cmb", "moa"):
    for _method in ("L1", "SSIM"):
        TERMS[f"{_family}{_method}"] = ("depth_ms", "pose")
        TERMS[f"{_family}{_method}_R"] = ("depth_ms_R", "pose_R")
MONO_KEYS = ["image", "intrinsic", "depth_gt", "pose_gt"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    with full_f32():
        yield


@pytest.fixture(scope="module")
def zoo_terms():
    """Every term's value and gradients on both sides, from one TotalLoss
    holding all of them: (jax values, jax gradients per term, torch
    values, torch gradients per term), gradients as {prediction key: flat
    list}."""
    features, preds = _loss_inputs(23)
    names = list(TERMS)
    diff_keys = ["depth_ms", "depth_ms_R", "flow_ms", "flow_ms_R", "pose", "pose_R"]
    recipe = dict.fromkeys(names, 1.0)
    weights = SCALE_WEIGHT_T2  # unequal scale weights, so a swapped scale shows
    with full_f32():
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
                      if isinstance(preds[k], list)
                      else torch.tensor(preds[k], requires_grad=True))
                  for k in diff_keys}
        by_type = run(tloss, t_diff, torch.from_numpy, timage.safe_reciprocal_ms)
        t_grads = {}
        for n in names:
            grads = iter(torch.autograd.grad(by_type[n], _flat([t_diff[k] for k in diff_keys]),
                                             retain_graph=True, allow_unused=True))
            t_grads[n] = {k: [next(grads) for _ in _flat([t_diff[k]])] for k in diff_keys}
    return (dict(zip(names, np.asarray(j_values).tolist())), j_grads,
            {n: float(v.detach()) for n, v in by_type.items()}, t_grads)


@pytest.mark.parametrize("name", list(TERMS))
def test_zoo_loss_term_and_gradient_match_jax(name, zoo_terms):
    j_values, j_grads, t_values, t_grads = zoo_terms
    np.testing.assert_allclose(t_values[name], j_values[name], rtol=1e-5, atol=1e-7)
    assert t_values[name] > 0
    for key in t_grads[name]:
        for i, (g, r) in enumerate(zip(t_grads[name][key], j_grads[name][key])):
            if key not in TERMS[name]:  # a prediction the term does not differentiate
                assert g is None or not torch.any(g), (name, key)
                assert not np.any(r), (name, key)
                continue
            err = float(np.linalg.norm(g.numpy() - r))
            assert err <= 1e-4 * float(np.linalg.norm(r)) + 1e-7, (name, key, i, err)
    for key in TERMS[name]:
        assert any(np.any(r) for r in j_grads[name][key]), (name, key)


@pytest.mark.parametrize("keys", ["mono", "stereo"])
@pytest.mark.parametrize("recipe_name", ["LOSS_RIGID_MD2", "LOSS_RIGID_MOA",
                                         "LOSS_RIGID_MOA_WST"])
def test_factory_builds_the_zoo_recipes_as_jax(recipe_name, keys):
    """The published recipes build the JAX loss objects; on mono keys the
    dependency rule drops the same terms (the _R twins, the stereo and moa
    terms) in both packages."""
    recipe = {"LOSS_RIGID_MD2": LOSS_RIGID_MD2, "LOSS_RIGID_MOA": LOSS_RIGID_MOA,
              "LOSS_RIGID_MOA_WST": LOSS_RIGID_MOA_WST}[recipe_name]
    data_keys = MONO_KEYS if keys == "mono" else KITTI_KEYS
    stereo = keys == "stereo"
    got = loss_factory(data_keys, recipe, SCALE_WEIGHT_T2, stereo=stereo)
    ref = j_loss_factory(data_keys, recipe, SCALE_WEIGHT_T2, stereo=stereo)
    assert list(got.loss_weights.items()) == list(ref.loss_weights.items())
    assert [type(v).__name__ for v in got.loss_objects.values()] \
        == [type(v).__name__ for v in ref.loss_objects.values()]
    if stereo:
        assert list(got.loss_weights) == list(recipe)
    else:
        assert got.loss_weights and not any(
            k.endswith("_R") or k.startswith(("moa", "stereo")) for k in got.loss_weights)
