"""The arithmetic of the fused head's tensor-core kernels (kernels 3 and 4,
on bf16 and on float32 features), emulated in float32 on the CPU and held
against the JAX package; and which route each feature width takes.

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
from hand_integral_pose_estimation_tpu_torch.ops import (
    fused_head,
    integral,
    kernels,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)

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


# ---- float32 features (compute_dtype="float32"): kernel 4's tensor-core
# route splits the features into three bf16 parts as well and keeps the
# part pairs of `fused_head.F32_PART_PAIRS`:
#   logits  f_hi . W_hi + (sum over the other pairs (i, j) of f_i . W_j)
#           (6 products, the (hi, hi) pair's and the rest in two sums)
#   dW      sum over pairs (i, j) of g_i^T f_j                (6 products)
#   dfeat   g_hi . W_hi + g_hi . W_mid + g_lo . W_hi          (as for bf16)
# and stores dfeat in float32. The dropped pairs weigh 2^-24 of a product
# and less, so the same tolerances hold as for the bf16 route.


def _inputs32(D, seed):
    """Features as they come from a float32 model: not rounded to bf16."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, H, W, F)).astype(np.float32)
    w = (rng.normal(size=(J * D, F)) * LOGIT_STD / np.sqrt(F)).astype(
        np.float32)
    bias = rng.normal(size=(J * D,)).astype(np.float32)
    cot = rng.normal(size=(B, J, 3)).astype(np.float32)
    return feats, w, bias, cot


def _pair_products(a, b, spec, pairs=fused_head.F32_PART_PAIRS):
    """sum over the part pairs (i, j) of a_i . b_j (float32 products of
    bf16-exact parts); `spec` the einsum of one product."""
    ap = [p.float() for p in fused_head.bf16_split(a, 3)]
    bp = [p.float() for p in fused_head.bf16_split(b, 3)]
    return sum(torch.einsum(spec, ap[i], bp[j]) for i, j in pairs)


def _emulated_logits32(feats, w, bias):
    f = torch.from_numpy(feats).reshape(B, H * W, F)
    wt = torch.from_numpy(w)
    pairs = fused_head.F32_PART_PAIRS
    return (_pair_products(f, wt, "bsf,cf->bsc", pairs[:1])
            + _pair_products(f, wt, "bsf,cf->bsc", pairs[1:])
            + torch.from_numpy(bias))


def _emulated_backward32(feats, w, bias, m, s, coords, cot, D,
                         features=None):
    """dfeat, dW, db of the float32-feature route. `features` replaces
    the features by another version of them (the bf16 shortcut)."""
    if features is not None:
        feats = features
    x = _emulated_logits32(feats, w, bias)
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
    dW = _pair_products(g, f, "bsc,bsf->cf")
    return dfeat.reshape(B, H, W, F), dW, g.sum(dim=(0, 1))


def test_f32_part_pairs_are_the_pairs_down_to_2_to_the_16():
    """The six pairs are exactly those whose parts' orders (hi 0, mid 8,
    lo 16 bits down) add up to at most 16 bits, hi x hi first."""
    want = {(i, j) for i in range(3) for j in range(3) if i + j <= 2}
    assert set(fused_head.F32_PART_PAIRS) == want
    assert len(fused_head.F32_PART_PAIRS) == 6
    assert fused_head.F32_PART_PAIRS[0] == (0, 0)


@pytest.mark.parametrize("D", [4, 40])
def test_emulated_f32_forward_matches_jax(D):
    """The logits the float32 route recomputes, from unrounded float32
    features, decode to the JAX forward's coords."""
    feats, w, bias, _ = _inputs32(D, seed=20 + D)
    x = _emulated_logits32(feats, w, bias)
    coords, m, s = integral.softmax_integral_reference(
        x.reshape(B, H, W, J * D), J, D)
    want = _jax_forward(feats, w, bias, D)
    assert _excess(coords, want[0], COORD_SCALE) <= 0
    np.testing.assert_allclose(m.numpy(), np.asarray(want[1]), rtol=0,
                               atol=COORD_SCALE * float(np.abs(want[1]).max()))
    np.testing.assert_allclose(s.numpy(), np.asarray(want[2]), rtol=1e-5)


def _jax_backward32(feats, w, bias, cot, D):
    coords, m, s = (np.array(a) for a in _jax_forward(feats, w, bias, D))
    res = (jnp.asarray(feats), jnp.asarray(w.T), jnp.asarray(bias),
           jnp.asarray(m), jnp.asarray(s), jnp.asarray(coords))
    return (coords, m, s), jfused._hp_bwd(J, D, "xla", False, res,
                                          jnp.asarray(cot))


@pytest.mark.parametrize("D", [4, 40])
def test_emulated_f32_backward_matches_jax(D):
    feats, w, bias, cot = _inputs32(D, seed=30 + D)
    (coords, m, s), want = _jax_backward32(feats, w, bias, cot, D)
    dfeat, dW, db = _emulated_backward32(feats, w, bias, m, s, coords, cot, D)
    assert dfeat.dtype == torch.float32
    assert _excess(dfeat, want[0], DFEAT_SCALE) <= 0
    assert _excess(dW, np.asarray(want[1]).T, DW_SCALE) <= 0
    assert _excess(db, want[2], DW_SCALE) <= 0


@pytest.mark.parametrize("D", [4, 40])
def test_bf16_feature_shortcut_misses_the_f32_tolerance(D):
    """The bf16 route's arithmetic on float32 features (the features
    rounded once to bf16) moves dW far past the tolerance the float32
    route is held to."""
    feats, w, bias, cot = _inputs32(D, seed=30 + D)
    (coords, m, s), want = _jax_backward32(feats, w, bias, cot, D)
    rounded = torch.from_numpy(feats).to(torch.bfloat16).float().numpy()
    _, dW, _ = _emulated_backward32(feats, w, bias, m, s, coords, cot, D,
                                    features=rounded)
    want_dW = np.asarray(want[1]).T
    tol = DW_SCALE * float(np.abs(want_dW).max())
    assert float(np.abs(dW.numpy() - want_dW).max()) > 10 * tol


# ---- kernel 3 on float32 features (`csrc/head_projection_integral_mma.cu`,
# `hp_fwd_f32_kernel`): the features and the weight split into three parts,
# the six pairs multiplied 16 features (a k-step) at a time with float32
# accumulation, the (hi, hi) pair into one accumulator and the five smaller
# pairs into another, added once the k-steps are done; then bias, and an
# online soft-argmax state per (image, chunk of tiles of 32 positions,
# channel), the two warpgroups taking alternate tiles and merged in order,
# the chunks merged in order, then each joint's channels.
K_STEP = 16
TILE32 = 32


def _kstep_logits32(feats, w, bias):
    """(B, HW, C) logits as the kernel's two accumulators form them."""
    f = [p.float() for p in
         fused_head.bf16_split(torch.from_numpy(feats).reshape(B, H * W, F),
                               3)]
    wp = [p.float() for p in fused_head.bf16_split(torch.from_numpy(w), 3)]
    x = torch.zeros(B, H * W, w.shape[0])
    xs = torch.zeros_like(x)
    for k0 in range(0, F, K_STEP):
        ks = slice(k0, k0 + K_STEP)
        for q, (i, j) in enumerate(fused_head.F32_PART_PAIRS):
            prod = torch.einsum("bsf,cf->bsc", f[i][..., ks], wp[j][:, ks])
            if q == 0:
                x = x + prod
            else:
                xs = xs + prod
    return (x + xs) + torch.from_numpy(bias)


def _online_states(logits, chunks):
    """Per-(image, chunk, channel) states (m, s, sum e col, sum e row) of
    (B, HW, C) float32 logits over tiles of 32 positions, each warpgroup's
    tiles folded in order and the two merged."""
    hw = torch.arange(H * W)
    col, row = (hw % W).float(), (hw // W).float()
    tiles = -(-H * W // TILE32)
    per = -(-tiles // chunks)

    def fold(st, t):
        v = logits[:, t * TILE32:(t + 1) * TILE32]
        c = col[t * TILE32:(t + 1) * TILE32, None]
        r = row[t * TILE32:(t + 1) * TILE32, None]
        m = torch.maximum(st[0], v.amax(dim=1))
        e = torch.exp(v - m[:, None])
        scale = torch.exp(st[0] - m)
        return (m, st[1] * scale + e.sum(1), st[2] * scale + (e * c).sum(1),
                st[3] * scale + (e * r).sum(1))

    def merge(a, b):
        m = torch.maximum(a[0], b[0])
        ca, cb = torch.exp(a[0] - m), torch.exp(b[0] - m)
        return (m, *(x * ca + y * cb for x, y in zip(a[1:], b[1:])))

    empty = (torch.full(logits.shape[::2], -torch.inf),
             *(torch.zeros(logits.shape[::2]) for _ in range(3)))
    out = []
    for q in range(chunks):
        groups = []
        for g in range(2):
            st = empty
            for t in range(q * per + g, min(tiles, (q + 1) * per), 2):
                st = fold(st, t)
            groups.append(st)
        out.append(merge(*groups))
    return out


def _merged_decode(states, D):
    """The chunk merge: each channel's chunks in order, then the joint's
    channels with their depth slots; coords, m, s as the kernel writes
    them."""
    st = states[0]
    for nxt in states[1:]:
        m = torch.maximum(st[0], nxt[0])
        ca, cb = torch.exp(st[0] - m), torch.exp(nxt[0] - m)
        st = (m, *(x * ca + y * cb for x, y in zip(st[1:], nxt[1:])))
    m, s, sx, sy = (t.reshape(B, J, D) for t in st)
    mj = m.amax(dim=2)
    scale = torch.exp(m - mj[..., None])
    sz = s * torch.arange(D, dtype=torch.float32)
    sj, sxj, syj, szj = ((t * scale).sum(2) for t in (s, sx, sy, sz))
    coords = torch.stack([sxj / sj / W - 0.5, syj / sj / H - 0.5,
                          szj / sj / D - 0.5], dim=-1)
    return coords, mj, sj


@pytest.mark.parametrize("D", [4, 40])
def test_emulated_f32_forward_kernel_plan_matches_jax(D):
    """3f's plan on unrounded float32 features (k-step accumulators, tiles
    of 32 positions, one and two chunks an image) decodes to the JAX
    forward's coords, m and s."""
    feats, w, bias, _ = _inputs32(D, seed=40 + D)
    want = _jax_forward(feats, w, bias, D)
    logits = _kstep_logits32(feats, w, bias)
    for chunks in (1, 2):
        coords, m, s = _merged_decode(_online_states(logits, chunks), D)
        assert _excess(coords, want[0], COORD_SCALE) <= 0
        np.testing.assert_allclose(
            m.numpy(), np.asarray(want[1]), rtol=0,
            atol=COORD_SCALE * float(np.abs(want[1]).max()))
        np.testing.assert_allclose(s.numpy(), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("D", [4, 40])
def test_f32_hi_pair_alone_misses_the_tolerance(D):
    """The (hi, hi) pair alone (the features and the weight each rounded
    once to bf16) moves the coords far past the tolerance the float32
    route is held to: the five smaller pairs carry it."""
    feats, w, bias, _ = _inputs32(D, seed=40 + D)
    want = _jax_forward(feats, w, bias, D)
    f = torch.from_numpy(feats).reshape(B, H * W, F)
    hi = (_pair_products(f, torch.from_numpy(w), "bsf,cf->bsc",
                         fused_head.F32_PART_PAIRS[:1])
          + torch.from_numpy(bias))
    coords = integral.softmax_integral_reference(
        hi.reshape(B, H, W, -1), J, D)[0]
    tol = COORD_SCALE * float(np.abs(np.asarray(want[0])).max())
    assert float(np.abs(coords.numpy() - np.asarray(want[0])).max()) > 10 * tol


# feature widths and the routes: every width, at every depth, takes its
# dtype's tensor-core entry point in both directions (the kernels that keep
# a block's weight planes at the whole F up to 256 features, the ones that
# walk F in slices of 64 past that); no width is refused and none gives way
# to another route or to the plain version
F32_ROUTES = [(f, "HEAD_PROJECTION_INTEGRAL_FWD_F32")
              for f in (4, 36, 40, 64, 128, 192, 252, 256,
                        1, 6, 38, 254, 258, 260, 512)]


@pytest.mark.parametrize("num_feats,entry", F32_ROUTES)
def test_f32_forward_route_by_width(num_feats, entry):
    route = fused_head.forward_route(torch.float32)
    assert route is getattr(kernels, entry)
    assert route in kernels.KERNELS
    assert route.symbol == "hipe_" + entry.lower()
    # the chunks' tiles: 32 positions on the resident kernels, 64 on the
    # slice-walking ones
    assert fused_head._chunk_tile(torch.float32, num_feats) == (
        32 if num_feats <= 256 else 64)
    # both directions take the width at any depth
    feats = torch.zeros(1, 2, 2, num_feats)
    weight = torch.zeros(3, num_feats)
    for depth in (1, 56, 128, 160):
        fused_head._check_feats(feats, weight, depth)


def test_bf16_forward_route_by_width():
    for f in (4, 40, 256, 1, 7, 38, 258, 260, 512, 2048):
        assert (fused_head.forward_route(torch.bfloat16)
                is kernels.HEAD_PROJECTION_INTEGRAL_FWD)
        assert fused_head._chunk_tile(torch.bfloat16, f) == 64
        fused_head._check_feats(torch.zeros(1, 2, 2, f, dtype=torch.bfloat16),
                                torch.zeros(3, f), 160)
    with pytest.raises(ValueError, match="depth 0"):
        fused_head._check_feats(torch.zeros(1, 2, 2, 8), torch.zeros(3, 8), 0)
    # each route has an entry point of its own, counted apart, and no
    # CUDA-core route is left
    symbols = [k.symbol for k in kernels.KERNELS]
    assert len(set(symbols)) == len(symbols)
    assert not any("cuda_cores" in s for s in symbols)
    assert "hp_fwd_f32_kernel" in kernels.F32_MMA_KERNELS


# kernel 4 past 256 features (the ring kernels, csrc/k_slices.cuh): each
# 64-wide slice's three-part logits in a sum of their own, each of the two
# warpgroups' halves of K added slice by slice, the halves added
# warpgroup 0 + 1; the products along N = F in passes of 512 features
def _emulated_ring_backward(feats, w, bias, m, s, coords, cot, D):
    """dfeat, dW, db in the ring kernels' order of sums: the logits as
    above; dfeat's channel blocks of 64 and dW's tiles of 64 positions
    added in order, each a float32 sum of bf16 part products."""
    b_, h_, w_, f_ = feats.shape
    slices = -(-f_ // 64)
    pad = slices * 64 - f_
    f = torch.nn.functional.pad(torch.from_numpy(feats), (0, pad))
    f = f.reshape(b_, h_ * w_, slices * 64)
    wt = torch.nn.functional.pad(torch.from_numpy(w), (0, pad))
    parts = [p.float() for p in fused_head.bf16_split(wt, 3)]

    def slice_logits(k):
        cols = slice(64 * k, 64 * k + 64)
        return sum(torch.matmul(f[..., cols], p[:, cols].t()) for p in parts)

    half = (slices + 1) // 2
    halves = [torch.zeros(b_, h_ * w_, wt.shape[0]) for _ in range(2)]
    for k in range(slices):
        halves[k >= half] = halves[k >= half] + slice_logits(k)
    x = halves[0] + halves[1] + torch.from_numpy(bias)
    mvec, T, A, Bc = integral.channel_constants(
        torch.from_numpy(m), torch.from_numpy(s), torch.from_numpy(coords),
        torch.from_numpy(cot), h_, w_, D)
    hw = torch.arange(h_ * w_)
    col = (hw % w_).float()[None, :, None]
    row = (hw // w_).float()[None, :, None]
    g = (torch.exp(x - mvec[:, None, :])
         * (T[:, None, :] + A[:, None, :] * col + Bc[:, None, :] * row))
    g2 = [p.float() for p in fused_head.bf16_split(g, 2)]
    g3 = [p.float() for p in fused_head.bf16_split(g, 3)]
    dfeat = torch.zeros_like(f)
    for c0 in range(0, wt.shape[0], 64):
        ch = slice(c0, c0 + 64)
        dfeat = dfeat + (torch.matmul(g2[0][..., ch], parts[0][ch])
                         + torch.matmul(g2[0][..., ch], parts[1][ch])
                         + torch.matmul(g2[1][..., ch], parts[0][ch]))
    dW = torch.zeros_like(wt)
    for bi in range(b_):
        for p0 in range(0, h_ * w_, 64):
            rows = slice(p0, p0 + 64)
            dW = dW + sum(p[bi, rows].t() @ f[bi, rows] for p in g3)
    return (dfeat[..., :f_].reshape(feats.shape), dW[:, :f_],
            g.sum(dim=(0, 1)))


@pytest.mark.parametrize("num_feats", [260, 512, 513])
def test_emulated_ring_backward_matches_jax(num_feats):
    """The ring kernels' plan of sums, emulated at widths with one pass
    (260: 3 + 2 slices, 512: 4 + 4) and two (513), within the tolerances
    the other kernels are held to against the JAX backward."""
    D, hw = 4, (9, 7)
    rng = np.random.default_rng(num_feats)
    feats = torch.from_numpy(rng.normal(size=(2, *hw, num_feats)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    w = (rng.normal(size=(J * D, num_feats)) * LOGIT_STD
         / np.sqrt(num_feats)).astype(np.float32)
    bias = rng.normal(size=(J * D,)).astype(np.float32)
    cot = rng.normal(size=(2, J, 3)).astype(np.float32)
    coords, m, s = (np.array(a) for a in jfused._hp_fwd_dispatch(
        jnp.asarray(feats), jnp.asarray(w.T), jnp.asarray(bias), J, D,
        "xla", False))
    res = (jnp.asarray(feats), jnp.asarray(w.T), jnp.asarray(bias),
           jnp.asarray(m), jnp.asarray(s), jnp.asarray(coords))
    want = jfused._hp_bwd(J, D, "xla", False, res, jnp.asarray(cot))
    dfeat, dW, db = _emulated_ring_backward(feats, w, bias, m, s, coords,
                                            cot, D)
    assert _excess(dfeat, want[0], DFEAT_SCALE) <= 0
    assert _excess(dW, np.asarray(want[1]).T, DW_SCALE) <= 0
    assert _excess(db, want[2], DW_SCALE) <= 0


@pytest.mark.parametrize("num_feats", [256, 260, 512, 1024])
@pytest.mark.parametrize("batch", [32, 4])
def test_backward_grid_plan_counts_every_dimension(monkeypatch, num_feats,
                                                   batch):
    """Kernel 4's dW grid (`fused_head.dweight_grid`) at the serving
    shape on 132 SMs: (channel blocks, images x chunks, passes) as the C
    launcher starts it, one pass up to 512 features and one per 512 past
    that; the chunks planned over that whole grid (no other count takes
    fewer waves x (tiles per chunk + 1)), no chunk empty, and the waves
    nearly full: the work of one chunk an image over the SMs' time of the
    planned waves at least 0.85."""
    monkeypatch.setattr(kernels, "sm_count", lambda index: 132)
    C, sms = 21 * 56, 132
    for dtype in (torch.bfloat16, torch.float32):
        feats = torch.empty(batch, 56, 56, num_feats, dtype=dtype)
        blocks, rows, passes = fused_head.dweight_grid(feats, C)
        assert blocks == 19
        assert passes == fused_head.backward_passes(num_feats) == (
            1 if num_feats <= 512 else -(-num_feats // 512))
        assert rows % batch == 0
        chunks = rows // batch
        tiles = -(-56 * 56 // fused_head._chunk_tile(dtype, num_feats))
        per_chunk = -(-tiles // chunks)
        assert (chunks - 1) * per_chunk < tiles

        def cost(c):
            return (-(-blocks * batch * passes * c // sms)
                    * (-(-tiles // c) + 1))

        assert cost(chunks) == min(cost(c) for c in range(1, tiles + 1))
        waves = -(-blocks * rows * passes // sms)
        busy = (blocks * batch * passes * (tiles + 1)
                / (sms * waves * (per_chunk + 1)))
        assert busy >= 0.85, (dtype, chunks, busy)


@pytest.mark.parametrize("num_feats", [260, 512])
@pytest.mark.parametrize("batch", [1, 4, 32])
def test_forward_grid_plan_cuts_rounds(monkeypatch, num_feats, batch):
    """Kernel 3's grid past 256 features at the serving shape on 132 SMs,
    as its launcher cuts it (`launch_fwd_ring`): an image's tiles of 64
    positions in rounds of four (bf16 features) or two (float32 ones),
    each chunk but the last ceil(rounds / chunks) rounds, none empty; the
    count the one that least waves x (tiles per chunk + 1) take; and the
    waves busy: the work of one chunk an image over the SMs' time of the
    planned waves at least 0.9 at batch 32 and 0.7 at batch 1 and 4
    (rounds of four tiles cut an image more coarsely than the backward's
    single tiles)."""
    monkeypatch.setattr(kernels, "sm_count", lambda index: 132)
    C, sms, tiles, blocks = 21 * 56, 132, -(-56 * 56 // 64), 19
    for dtype, round_tiles in ((torch.bfloat16, 4), (torch.float32, 2)):
        assert fused_head.forward_round_tiles(dtype, num_feats) == round_tiles
        assert fused_head.forward_round_tiles(dtype, 256) == 1
        assert fused_head._chunk_tile(dtype, num_feats) == 64
        feats = torch.empty(batch, 56, 56, num_feats, dtype=dtype)
        chunks = fused_head._mma_chunks(feats, C, round_tiles=round_tiles)
        rounds = -(-tiles // round_tiles)
        per = -(-rounds // chunks)  # the launcher's rounds per chunk
        assert 1 <= chunks <= rounds and (chunks - 1) * per < rounds

        def cost(c):
            return (-(-batch * blocks * c // sms)
                    * (round_tiles * -(-rounds // c) + 1))

        assert cost(chunks) == min(cost(c) for c in range(1, rounds + 1))
        waves = -(-batch * chunks * blocks // sms)
        busy = (blocks * batch * (round_tiles * rounds + 1)
                / (sms * waves * (round_tiles * per + 1)))
        assert busy >= (0.9 if batch == 32 else 0.7), (dtype, chunks, busy)
