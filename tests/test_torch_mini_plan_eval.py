"""The evaluation helpers of ``training/mini_plan.py`` against the JAX
package's, on the same weights: ``evaluate_checkpoint`` with
``band_abs_rel`` and ``unscaled_abs_rel``, ``evaluate_flow_epe`` and
``evaluate_stereo_extrinsic``. Split from test_torch_mini_plan.py, whose
fixtures they share, only to keep each file's time on one worker short.

Weights: the JAX helpers' train states, filled from a seeded numpy
RandomState (``test_torch_train._fill``), saved as the port's checkpoint.
Tolerance: rtol 1e-4, atol 1e-6 on the metrics (float32 predictions on
both sides, summed in another order).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_mini_plan import _no_tf32  # noqa: F401
from test_torch_train import _fill
from xpt_mde_tpu.data import SyntheticDataset as JSyntheticDataset
from xpt_mde_tpu.training import mini_plan as jmp
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import mini_plan as mp


@pytest.fixture
def jax_init(monkeypatch):
    """JAX's mini_plan helpers with restore=False start from seeded numpy
    fills (``test_torch_train._fill``, shaped by ``jax.eval_shape``)
    instead of flax's init, which runs op by op and takes ~30-50 s on the
    CPU for these nets. Returns the variables of each train state they
    create, in order."""
    import xpt_mde_tpu.training.train_step as jts

    created = []

    def create(model, example_features, tx, rng=None):
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), example_features,
                                                   train=False))
        variables = _fill(shapes, seed=7 + len(created))
        created.append(variables)
        return TrainState.create(apply_fn=model.apply, params=variables["params"],
                                 batch_stats=variables.get("batch_stats"), tx=tx)

    monkeypatch.setattr(jts, "create_train_state", create)
    return created


def _save_port_checkpoint(cfg, nets, val_data, variables, stereo=False):
    """The JAX init variables as the port's "latest" per-net files."""
    model = ModelFactory(val_data.config_keys(), nets, "Exponential", stereo=stereo,
                         device="cpu").get_model()
    load_flax_variables(model, variables)
    ckpt = Path(cfg.datapath_ckp) / cfg.ckpt_name
    ckpt.mkdir(parents=True, exist_ok=True)
    for name, net in model.named_children():
        torch.save(net.state_dict(), ckpt / f"{name}_latest.pt")


def _assert_metrics_close(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        # the predictions agree to ~1e-6 relative (float32, another order);
        # rot_err sits near 0 at init, hence the absolute bound
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)


def test_evaluate_checkpoint_and_depth_metrics_match_jax(tmp_path, jax_init):
    cfg = mp.make_config(tmp_path, mp.miniature_plan(1, 1, 1), batch=2)
    jcfg = jmp.make_config(tmp_path / "jax", jmp.miniature_plan(1, 1, 1), batch=2)
    val = dict(batch_size=2, height=mp.RIGID_SIZE[0], width=mp.RIGID_SIZE[1], num_batches=1,
               varying_depth=True, vary_motion=True, seed=99)
    want = jmp.evaluate_checkpoint(jcfg, jmp.RIGID_NETS, JSyntheticDataset(**val),
                                   restore=False, return_results=True)
    _save_port_checkpoint(cfg, mp.RIGID_NETS, SyntheticDataset(**val), jax_init[0])
    got = mp.evaluate_checkpoint(cfg, mp.RIGID_NETS, SyntheticDataset(**val),
                                 return_results=True, device="cpu")
    results, jresults = got.pop("_results"), want.pop("_results")
    _assert_metrics_close(got, want)
    assert set(results) == set(jresults)
    # the analyses of mini_plan on the same predictions (the port's)
    r0, r1 = SyntheticDataset(**val, moving_object=True).object_rows()
    _assert_metrics_close(mp.band_abs_rel(results, r0, r1), jmp.band_abs_rel(results, r0, r1))
    assert mp.unscaled_abs_rel(results) == jmp.unscaled_abs_rel(results)
    with pytest.raises(FileNotFoundError):
        mp.evaluate_checkpoint(mp.make_config(tmp_path / "empty", []), mp.RIGID_NETS,
                               SyntheticDataset(**val), device="cpu")


def test_evaluate_flow_epe_matches_jax(tmp_path, jax_init):
    cfg = mp.make_config(tmp_path, mp.miniature_plan(1, 1, 1), batch=1)
    jcfg = jmp.make_config(tmp_path / "jax", jmp.miniature_plan(1, 1, 1), batch=1)
    val = dict(batch_size=1, height=mp.FLOW_SIZE[0], width=mp.FLOW_SIZE[1], num_batches=1,
               varying_depth=True, vary_motion=True, seed=99)
    want = jmp.evaluate_flow_epe(jcfg, JSyntheticDataset(**val), restore=False)
    _save_port_checkpoint(cfg, mp.FLOW_NETS, SyntheticDataset(**val), jax_init[0])
    got = mp.evaluate_flow_epe(cfg, SyntheticDataset(**val), device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_evaluate_stereo_extrinsic_matches_jax(tmp_path, jax_init):
    cfg = mp.make_config(tmp_path, [], batch=1, stereo=True)
    jcfg = jmp.make_config(tmp_path / "jax", [], batch=1, stereo=True)
    val = dict(batch_size=1, height=mp.RIGID_SIZE[0], width=mp.RIGID_SIZE[1], num_batches=1,
               varying_depth=True, stereo=True, seed=99)
    want = jmp.evaluate_stereo_extrinsic(jcfg, jmp.RIGID_NETS, JSyntheticDataset(**val),
                                         restore=False)
    _save_port_checkpoint(cfg, mp.RIGID_NETS, SyntheticDataset(**val), jax_init[0],
                          stereo=True)
    got = mp.evaluate_stereo_extrinsic(cfg, mp.RIGID_NETS, SyntheticDataset(**val),
                                       device="cpu")
    _assert_metrics_close(got, want)
