"""The correlation cost volume in bfloat16, the JAX package's default
compute dtype: the plain versions of kernels K2, K3 and K4
(``ops/correlation.py``) on bfloat16 operands against the JAX Pallas
kernel ``correlation_cost_pallas`` and its VJP in interpret mode, at the
(md, stride) of each of PWC-Net's five levels; and the dtype dispatch of
``Correlation`` to the bfloat16 kernels, stood in for by the plain
versions (the kernels run only on the card).

Inputs are bfloat16 roundings of seeded numpy draws. Both sides read the
operands as float32, sum the products in float32, divide by C and round
once to bfloat16, so they differ only in the order of one float32 sum:
each value is held to one bfloat16 ulp of the JAX value, plus 1e-6 of the
largest value for a sum that cancels (where a float32 order difference
can exceed the ulp of a result near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from xpt_mde_tpu.ops.pallas.correlation import correlation_cost_pallas as j_corr_pallas
from xpt_mde_tpu_torch.ops import correlation as tcorr
from xpt_mde_tpu_torch.ops.kernels import correlation as kcorr

# (md, stride) of PWC-Net's levels 6, 5, 4, 3 and 2
LEVELS = [(2, 1), (4, 1), (8, 2), (16, 4), (32, 8)]
SHAPE = (2, 8, 16, 12)  # B, H, W, C (channel-last, the JAX layout)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def assert_within_one_ulp(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """The rule of ``chip_smoke.bf16_ulp_excess``, which the card checks
    use too."""
    err, excess = chip_smoke.bf16_ulp_excess(torch.from_numpy(got.astype(np.float32)),
                                             torch.from_numpy(want.astype(np.float32)))
    assert excess <= 1.0, (what, err, excess)


def _bf16_draws(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [np.asarray(jnp.asarray(rng.uniform(-1, 1, s), jnp.bfloat16)) for s in shapes]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.astype(np.float32).transpose(0, 3, 1, 2))
                            ).to(torch.bfloat16)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("md,stride", LEVELS)
def test_bf16_twins_match_the_pallas_kernels(md, stride):
    n2 = tcorr.correlation_channels(md, stride)
    cl, cr, cot = _bf16_draws(md + stride, SHAPE, SHAPE, SHAPE[:3] + (n2,))
    out, vjp = jax.vjp(lambda a, b: j_corr_pallas(a, b, md, stride, interpret=True),
                       jnp.asarray(cl), jnp.asarray(cr))
    dcl, dcr = vjp(jnp.asarray(cot))
    assert out.dtype == dcl.dtype == dcr.dtype == jnp.bfloat16
    ref = {"K2": np.asarray(out), "K3": np.asarray(dcl), "K4": np.asarray(dcr)}

    tcl, tcr, tg = _nchw(cl), _nchw(cr), _nchw(cot)
    plain = {"K2": tcorr.correlation_cost_plain(tcl, tcr, md, stride),
             "K3": tcorr.correlation_grad_cl_plain(tg, tcr, md, stride),
             "K4": tcorr.correlation_grad_cr_plain(tg, tcl, md, stride)}
    # the CPU path: the cost volume and its autograd
    tcl.requires_grad_(True)
    tcr.requires_grad_(True)
    cost = tcorr.correlation_cost(tcl, tcr, md, stride)
    auto_dcl, auto_dcr = torch.autograd.grad(cost, (tcl, tcr), tg)
    autograd = {"K2": cost, "K3": auto_dcl, "K4": auto_dcr}
    for name in ("K2", "K3", "K4"):
        for label, got in (("plain", plain[name]), ("autograd", autograd[name])):
            assert got.dtype == torch.bfloat16, (name, label)
            assert_within_one_ulp(_nhwc(got), ref[name], f"{name} {label}")


def test_bf16_kernels_check_their_dtypes_before_launching():
    cl, cr = (_nchw(a) for a in _bf16_draws(0, SHAPE, SHAPE))
    counts = lambda: tuple(k.launches for k in (*kcorr.kernels_for(torch.float32),
                                                 *kcorr.kernels_for(torch.bfloat16)))
    before = counts()
    with pytest.raises(ValueError, match="float32"):  # a bfloat16 kernel's float32 operand
        kcorr.K2_BF16(cl.float(), cr.float(), 2, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        kcorr.K2(cl, cr, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kcorr.K3_BF16(torch.zeros(2, 25, 8, 16, dtype=torch.bfloat16), cr, 2, 1)
    with pytest.raises(ValueError, match="one dtype"):
        kcorr.Correlation.apply(cl, cr.float(), 2, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kcorr.Correlation.apply(cl.half(), cr.half(), 2, 1)
    assert counts() == before
    assert [k.name for k in kcorr.kernels_for(torch.bfloat16)] == ["K2-bf16", "K3-bf16",
                                                                  "K4-bf16"]


def test_bf16_correlation_function_wiring(monkeypatch):
    """``Correlation`` on bfloat16 operands takes the bfloat16 kernels (here
    the plain versions standing in for them), never the float32 ones, and
    hands back bfloat16 gradients."""
    calls = []
    for name, plain in (("K2", tcorr.correlation_cost_plain),
                        ("K3", tcorr.correlation_grad_cl_plain),
                        ("K4", tcorr.correlation_grad_cr_plain)):
        monkeypatch.setattr(kcorr, f"{name}_BF16",
                            lambda *a, name=name, plain=plain: calls.append(name) or plain(*a))
        monkeypatch.setattr(kcorr, name, lambda *a, name=name: calls.append(name + " f32"))
    cl, cr, g = _bf16_draws(1, SHAPE, SHAPE, SHAPE[:3] + (81,))
    tcl, tcr = _nchw(cl).requires_grad_(True), _nchw(cr).requires_grad_(True)
    out = kcorr.Correlation.apply(tcl, tcr, 8, 2)
    assert out.dtype == torch.bfloat16
    out.backward(_nchw(g))
    assert calls == ["K2", "K3", "K4"]
    assert tcl.grad.dtype == tcr.grad.dtype == torch.bfloat16
    torch.testing.assert_close(tcl.grad, tcorr.correlation_grad_cl_plain(_nchw(g), tcr, 8, 2),
                               rtol=0, atol=0)
