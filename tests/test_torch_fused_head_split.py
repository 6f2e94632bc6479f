"""The arithmetic of the fused head's tensor-core kernels (kernels 3 and 4
on bf16 features), emulated in float32 on the CPU and held against the JAX
package.

The kernels multiply bf16 operands on the tensor cores with float32
accumulation. A float32 operand is first split into bf16 parts
(`fused_head.bf16_split`, as `csrc/bf16x3_mma.cuh` splits in shared
memory), and the products of the parts are summed:
  logits  f . W_hi + f . W_mid + f . W_lo     (the bf16 features are exact)
  dfeat   g_hi . W_hi + g_hi . W_mid + g_lo . W_hi   (two parts of g and W)
  dW      g_hi^T f + g_mid^T f + g_lo^T f             (three parts of g)
A product of two bf16 values is exact in float32, so a float32 matmul of
the parts (converted back to float32) computes what the tensor cores do,
up to the order of the float32 sums. Inputs come from numpy seeds; the
JAX side is `head_projection_integral`'s XLA branch and its `_hp_bwd`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.ops import fused_head as jfused
from hand_integral_pose_estimation_tpu_torch.ops import fused_head, integral

B, H, W, J, F = 2, 8, 8, 3, 40
# coords and dW to 1e-5 of their largest entry: the three-part products
# carry float32's 24 bits, so only the order of float32 sums differs.
# dfeat to 5e-5: its two-part products keep ~16 bits of g and W (6e-6 of
# the largest entry measured at the serving shape).
COORD_SCALE = DW_SCALE = 1e-5
DFEAT_SCALE = 5e-5
# logits spread like a trained head's (std ~4), so that a rounding of the
# weight shows in the coords
LOGIT_STD = 4.0


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, H, W, F)).astype(np.float32)
    feats = torch.from_numpy(feats).to(torch.bfloat16).float().numpy()
    w = (rng.normal(size=(J * D, F)) * LOGIT_STD / np.sqrt(F)).astype(
        np.float32)
    bias = rng.normal(size=(J * D,)).astype(np.float32)
    cot = rng.normal(size=(B, J, 3)).astype(np.float32)
    return feats, w, bias, cot


def _emulated_logits(feats, w, bias, parts):
    f = torch.from_numpy(feats).reshape(B, H * W, F)
    x = sum(torch.matmul(f, p.float().t())
            for p in fused_head.bf16_split(torch.from_numpy(w), parts))
    return x + torch.from_numpy(bias)


def _emulated_forward(feats, w, bias, D, parts=3):
    x = _emulated_logits(feats, w, bias, parts)
    return integral.softmax_integral_reference(x.reshape(B, H, W, J * D), J, D)


def _emulated_backward(feats, w, bias, m, s, coords, cot, D):
    """dfeat, dW, db from the three-part logits, as kernel 4 forms them."""
    x = _emulated_logits(feats, w, bias, 3)
    mvec, T, A, Bc = integral.channel_constants(
        torch.from_numpy(m), torch.from_numpy(s), torch.from_numpy(coords),
        torch.from_numpy(cot), H, W, D)
    hw = torch.arange(H * W)
    col = (hw % W).float()[None, :, None]
    row = (hw // W).float()[None, :, None]
    g = (torch.exp(x - mvec[:, None, :])
         * (T[:, None, :] + A[:, None, :] * col + Bc[:, None, :] * row))
    g2 = [p.float() for p in fused_head.bf16_split(g, 2)]
    w2 = [p.float() for p in fused_head.bf16_split(torch.from_numpy(w), 2)]
    dfeat = (torch.matmul(g2[0], w2[0]) + torch.matmul(g2[0], w2[1])
             + torch.matmul(g2[1], w2[0]))
    f = torch.from_numpy(feats).reshape(B, H * W, F)
    dW = sum(torch.einsum("bsc,bsf->cf", p.float(), f)
             for p in fused_head.bf16_split(g, 3))
    return dfeat.reshape(B, H, W, F), dW, g.sum(dim=(0, 1))


def _jax_forward(feats, w, bias, D):
    return jfused._hp_fwd_dispatch(jnp.asarray(feats), jnp.asarray(w.T),
                                   jnp.asarray(bias), J, D, "xla", False)


def _excess(got, want, scale):
    """How far the largest difference is past `scale` of the largest
    entry (<= 0: within the tolerance)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() - scale * np.abs(want).max())


@pytest.mark.parametrize("values", ["wide", "signs_and_zeros"])
def test_bf16_split_sums_back_to_float32(values):
    """Three bf16 parts add back to the float32 value bitwise; two keep
    16 bits; one is plain bf16 rounding (8 bits)."""
    rng = np.random.default_rng(7)
    if values == "wide":
        x = (rng.uniform(1, 2, 20000) * 2.0 ** rng.integers(-100, 100, 20000)
             * rng.choice([-1, 1], 20000))
    else:
        x = np.concatenate([rng.normal(size=5000) * 1e-3, [0.0, -0.0],
                            -np.abs(rng.normal(size=5000)),
                            np.float32(1 + 2.0 ** -23) * np.ones(3)])
    x = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = fused_head.bf16_split(x, 3)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.float() + mid.float()) + lo.float()
    nonzero = x != 0   # -0.0 splits into parts that add up to +0.0
    assert torch.equal(total[nonzero].view(torch.int32),
                       x[nonzero].view(torch.int32))
    assert bool((total[~nonzero] == 0).all())
    two = sum(p.float() for p in fused_head.bf16_split(x, 2))
    rel = ((two - x).abs() / x.abs().clamp_min(1e-38)).max()
    assert float(rel) <= 2.0 ** -16
    assert torch.equal(fused_head.bf16_split(x, 1)[0], x.to(torch.bfloat16))


@pytest.mark.parametrize("D", [4, 40])
def test_emulated_forward_matches_jax(D):
    feats, w, bias, _ = _inputs(D, seed=D)
    coords, m, s = _emulated_forward(feats, w, bias, D)
    want = _jax_forward(feats, w, bias, D)
    assert _excess(coords, want[0], COORD_SCALE) <= 0
    np.testing.assert_allclose(m.numpy(), np.asarray(want[1]), rtol=0,
                               atol=COORD_SCALE * float(np.abs(want[1]).max()))
    np.testing.assert_allclose(s.numpy(), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("D", [4, 40])
def test_emulated_backward_matches_jax(D):
    feats, w, bias, cot = _inputs(D, seed=10 + D)
    coords, m, s = (np.array(a) for a in _jax_forward(feats, w, bias, D))
    res = (jnp.asarray(feats), jnp.asarray(w.T), jnp.asarray(bias),
           jnp.asarray(m), jnp.asarray(s), jnp.asarray(coords))
    want = jfused._hp_bwd(J, D, "xla", False, res, jnp.asarray(cot))
    dfeat, dW, db = _emulated_backward(feats, w, bias, m, s, coords, cot, D)
    assert _excess(dfeat, want[0], DFEAT_SCALE) <= 0
    assert _excess(dW, np.asarray(want[1]).T, DW_SCALE) <= 0
    assert _excess(db, want[2], DW_SCALE) <= 0


@pytest.mark.parametrize("D", [4, 40])
def test_one_part_weight_misses_the_tolerance(D):
    """Rounding the weight once to bf16 (the shortcut the split replaces)
    moves the coords far past the tolerance the kernels are held to."""
    feats, w, bias, _ = _inputs(D, seed=D)
    want = _jax_forward(feats, w, bias, D)
    one = _emulated_forward(feats, w, bias, D, parts=1)[0]
    three = _emulated_forward(feats, w, bias, D, parts=3)[0]
    tol = COORD_SCALE * float(np.abs(np.asarray(want[0])).max())
    assert _excess(three, want[0], COORD_SCALE) <= 0
    assert float(np.abs(one.numpy() - np.asarray(want[0])).max()) > 10 * tol
