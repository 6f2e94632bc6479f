"""The fused head at feature widths and depths outside the serving
configuration's F = 256 and D = 56: widths that are not a multiple of 4
(F = 6), past 256 (F = 260, 512), and a depth past 128 (D = 160). On the
card these run the slice-walking tensor-core kernels (`csrc/k_slices.cuh`)
and the depth-general chunk merge; on the CPU `head_projection_integral`
and its VJP take the plain versions, held here to the JAX head's
non-Pallas branch (`head_projection_integral` with impl "xla" and its
custom VJP `_hp_bwd`). The forward is compared at float64; the VJP at
float32, since `_hp_bwd` forms the cotangent of the logits in float32
whatever its inputs, to the tolerance of `tests/test_torch_train.py`'s
`test_fused_head_backward_matches_jax`. Inputs come from numpy seeds;
JAX's kernel is (F, J*D), the port's weight (J*D, F), so dW is compared
transposed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.ops import fused_head as jfused
from hand_integral_pose_estimation_tpu_torch.ops import fused_head

B, H, W, J = 2, 4, 4, 3
# the forward at float64 on both sides: the same closed forms, sums in
# another order
TOL = 1e-12
# the VJP at float32: sums over J*D channels or B*H*W rows in another
# order, 1e-5 of the largest entry plus 1e-4 relative
GRAD_ATOL_SCALE, GRAD_RTOL = 1e-5, 1e-4


def _inputs(F, D, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, H, W, F))
    kernel = rng.normal(size=(F, J * D)) * 4.0 / np.sqrt(F)
    bias = rng.normal(size=(J * D,))
    cot = rng.normal(size=(B, J, 3))
    return feats, kernel, bias, cot


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("D", [5, 160])
@pytest.mark.parametrize("F", [6, 260, 512])
def test_forward_matches_jax(F, D):
    feats, kernel, bias, _ = _inputs(F, D, seed=F + D)
    want = jfused._hp_fwd_dispatch(jnp.asarray(feats), jnp.asarray(kernel),
                                   jnp.asarray(bias), J, D, "xla", False)
    args = (torch.from_numpy(feats), torch.from_numpy(kernel.T.copy()),
            torch.from_numpy(bias), J, D)
    got = fused_head.head_projection_integral_reference(*args)
    for g, w, name in zip(got, want, ("coords", "m", "s")):
        assert g.dtype == torch.float64
        _close(g.numpy(), w, name)
    torch.testing.assert_close(fused_head.head_projection_integral(*args),
                               got[0], rtol=0, atol=0)


@pytest.mark.parametrize("D", [5, 160])
@pytest.mark.parametrize("F", [6, 260, 512])
def test_vjp_matches_jax(F, D):
    feats, kernel, bias, cot = (a.astype(np.float32)
                                for a in _inputs(F, D, seed=2 * F + D))
    _, vjp = jax.vjp(lambda f, w, b: jfused.head_projection_integral(
        f, w, b, J, D, "xla", False), jnp.asarray(feats), jnp.asarray(kernel),
        jnp.asarray(bias))
    want = [np.asarray(v) for v in vjp(jnp.asarray(cot))]
    args = [torch.from_numpy(a).requires_grad_()
            for a in (feats, kernel.T.copy(), bias)]
    got = torch.autograd.grad(fused_head.head_projection_integral(
        *args, J, D), args, torch.from_numpy(cot))
    for g, w, name in zip(got, (want[0], want[1].T, want[2]),
                          ("dfeat", "dW", "db")):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * np.abs(w).max(),
                                   err_msg=name)
