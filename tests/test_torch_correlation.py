"""The port's correlation cost volume (``ops/correlation.py``) against the
JAX package's: the XLA twin ``correlation_cost`` and the Pallas kernel
``correlation_cost_pallas`` in interpret mode, values and both input
gradients; and the wiring of ``Correlation``, the autograd Function of
kernels K2, K3 and K4 (``ops/kernels/correlation.py``), with the kernels
stood in for by their plain versions (they run only on the card).

Inputs from seeded numpy RandomStates. Tolerance 1e-6 absolute on values
and gradients of order 1: float32 means over 8 channels, or sums over up
to 81 displacements, in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.ops.correlation import correlation_cost as j_corr
from xpt_mde_tpu.ops.pallas.correlation import correlation_cost_pallas as j_corr_pallas
from xpt_mde_tpu_torch.ops import correlation as tcorr
from xpt_mde_tpu_torch.ops.kernels import correlation as kcorr

TOL = dict(atol=1e-6, rtol=1e-6)
# (md, stride): levels 6 and 5..2 of PWC-Net have (2, 1), (4, 1), (8, 2),
# (16, 4), (32, 8); (32, 8) reaches past a 12x16 frame everywhere
LEVELS = [(2, 1), (4, 2), (8, 2), (32, 8)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _features(seed, shape=(2, 12, 16, 8)):
    rng = np.random.RandomState(seed)
    cl = rng.uniform(-1, 1, shape).astype(np.float32)
    cr = rng.uniform(-1, 1, shape).astype(np.float32)
    return cl, cr


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("md,stride", LEVELS)
def test_plain_correlation_matches_jax_values_and_gradients(md, stride):
    cl, cr = _features(md + stride)
    n2 = tcorr.correlation_channels(md, stride)
    cot = np.random.RandomState(7).uniform(-1, 1, cl.shape[:3] + (n2,)).astype(np.float32)

    ref = {}
    for name, fn in (("xla", j_corr),
                     ("pallas", lambda a, b, m, s: j_corr_pallas(a, b, m, s, interpret=True))):
        out, vjp = jax.vjp(lambda a, b, fn=fn: fn(a, b, md, stride), jnp.asarray(cl),
                           jnp.asarray(cr))
        ref[name] = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]

    tcl, tcr = _nchw(cl).requires_grad_(True), _nchw(cr).requires_grad_(True)
    before = (kcorr.K2.launches, kcorr.K3.launches, kcorr.K4.launches)
    out = tcorr.correlation_cost(tcl, tcr, md, stride)  # CPU: the plain version
    assert tuple(out.shape) == (2, n2, 12, 16)
    dcl, dcr = torch.autograd.grad(out, (tcl, tcr), _nchw(cot))
    assert (kcorr.K2.launches, kcorr.K3.launches, kcorr.K4.launches) == before
    # the explicit plain gradients (the oracles of K3 and K4)
    dcl_plain = tcorr.correlation_grad_cl_plain(_nchw(cot), _nchw(cr), md, stride)
    dcr_plain = tcorr.correlation_grad_cr_plain(_nchw(cot), _nchw(cl), md, stride)
    for name, (r_out, r_dcl, r_dcr) in ref.items():
        np.testing.assert_allclose(_nhwc(out), r_out, err_msg=name, **TOL)
        for got in (dcl, dcl_plain):
            np.testing.assert_allclose(_nhwc(got), r_dcl, err_msg=name, **TOL)
        for got in (dcr, dcr_plain):
            np.testing.assert_allclose(_nhwc(got), r_dcr, err_msg=name, **TOL)


def test_correlation_zero_outside_and_channel_count():
    """A displacement that leaves the frame contributes zero, and the
    channel count is len(range(-md, md + 1, stride)) ** 2."""
    cl = torch.ones(1, 3, 4, 5)
    out = tcorr.correlation_cost_plain(cl, cl, 2, 1)
    assert tuple(out.shape) == (1, 25, 4, 5)
    assert float(out[0, 0, 0, 0]) == 0.0  # (dy, dx) = (-2, -2) at the corner
    assert float(out[0, 12, 0, 0]) == 1.0  # (0, 0): mean of 1 * 1
    assert float(out[0, 24, 3, 4]) == 0.0
    for md, stride, n in ((2, 1, 5), (4, 1, 9), (8, 2, 9), (16, 4, 9), (32, 8, 9), (5, 3, 4)):
        assert kcorr.num_displacements(md, stride) == n
        assert tcorr.correlation_channels(md, stride) == n * n


def test_kernels_check_their_inputs_before_launching():
    cl, cr = (_nchw(a) for a in _features(0))
    g = torch.zeros(2, 25, 12, 16)
    before = (kcorr.K2.launches, kcorr.K3.launches, kcorr.K4.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kcorr.K2(cl, cr, 2, 1)
    with pytest.raises(ValueError, match="one shape"):
        kcorr.K2(cl, cr[:, :4], 2, 1)
    with pytest.raises(ValueError, match="stride"):
        kcorr.K2(cl, cr, 2, 0)
    with pytest.raises(ValueError, match="max_displacement"):
        kcorr.K2(cl, cr, -1, 1)
    with pytest.raises(ValueError, match="grad_out"):
        kcorr.K3(g, cr, 4, 1)  # 81 channels expected
    with pytest.raises(ValueError, match="CUDA"):
        kcorr.K4(g, cl, 2, 1)
    assert (kcorr.K2.launches, kcorr.K3.launches, kcorr.K4.launches) == before


def test_correlation_function_wiring(monkeypatch):
    """``Correlation`` with K2, K3 and K4 stood in for by their plain
    versions: K2 forward, then K3 and K4 only for the inputs that need a
    gradient; nothing but K2 under inference."""
    calls = []
    monkeypatch.setattr(kcorr, "K2", lambda *a: calls.append("K2")
                        or tcorr.correlation_cost_plain(*a))
    monkeypatch.setattr(kcorr, "K3", lambda *a: calls.append("K3")
                        or tcorr.correlation_grad_cl_plain(*a))
    monkeypatch.setattr(kcorr, "K4", lambda *a: calls.append("K4")
                        or tcorr.correlation_grad_cr_plain(*a))
    cl, cr = (_nchw(a).requires_grad_(True) for a in _features(1))
    g = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (2, 81, 12, 16))
                         .astype(np.float32))
    out = kcorr.Correlation.apply(cl, cr, 8, 2)
    torch.testing.assert_close(out, tcorr.correlation_cost_plain(cl, cr, 8, 2))
    out.backward(g)
    assert calls == ["K2", "K3", "K4"]
    torch.testing.assert_close(cl.grad, tcorr.correlation_grad_cl_plain(g, cr, 8, 2))
    torch.testing.assert_close(cr.grad, tcorr.correlation_grad_cr_plain(g, cl, 8, 2))
    # only the right features need a gradient: K4 alone
    kcorr.Correlation.apply(cl.detach(), cr, 8, 2).backward(g)
    assert calls == ["K2", "K3", "K4", "K2", "K4"]
    with torch.inference_mode():  # a predict step: forward only
        kcorr.Correlation.apply(cl, cr, 8, 2)
    assert calls == ["K2", "K3", "K4", "K2", "K4", "K2"]
