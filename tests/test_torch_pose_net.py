"""The port's pose net against the JAX package on the CPU at float32, with
the same random weights carried across by the weights bridge
(interop.pose_state_dict_from_jax), and the bridge's round trip through the
JAX package's `convert_pose_snapshot`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand_integral_pose_estimation_tpu.interop import convert_pose_snapshot
from hand_integral_pose_estimation_tpu.models.pose_net import (
    get_pose_net as jax_pose_net,
)
from hand_integral_pose_estimation_tpu.ops.fused_head import (
    head_projection_integral as jax_head_projection_integral,
)
from hand_integral_pose_estimation_tpu.ops.integral import (
    softmax_integral as jax_softmax_integral,
)
from hand_integral_pose_estimation_tpu_torch.config import ModelConfig
from hand_integral_pose_estimation_tpu_torch.interop import (
    pose_state_dict_from_jax,
)
from hand_integral_pose_estimation_tpu_torch.models import get_pose_net
from hand_integral_pose_estimation_tpu_torch.ops import (
    head_projection_integral,
)
import torch_threads  # noqa: F401  (caps torch's threads per xdist worker)


def small_config(resnet_type: int) -> ModelConfig:
    return ModelConfig(resnet_type=resnet_type, input_shape=(64, 64),
                       output_shape=(16, 16), depth_dim=8,
                       compute_dtype="float32")


def randomized_jax_variables(cfg: ModelConfig, seed: int,
                             final_scale: float = 0.01):
    """JAX ResPoseNet variables with random weights AND random BatchNorm
    statistics, drawn as tests/test_torch_interop.py:_randomize draws the
    torch ones: conv kernels and biases N(0, 0.05), BN scale U(0.5, 1.5),
    bias N(0, 0.1), running mean N(0, 0.1), running var U(0.5, 1.5)."""
    net = jax_pose_net(cfg)
    # every leaf is drawn anew: the init's shapes are all that is needed
    variables = jax.eval_shape(
        lambda x: net.init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, *cfg.input_shape, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("mean",) or (name == "bias" and len(path) > 2
                                   and path[-2].key == "BatchNorm_0"):
            v = rng.normal(0.0, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.05, shape)
        return v.astype(np.float32)

    out = {col: jax.tree_util.tree_map_with_path(draw, variables[col])
           for col in ("params", "batch_stats")}
    # these weights give logits of std ~400 at unit-scale input, a one-hot
    # softmax; a smaller projection keeps the decode a soft average
    final = out["params"]["head"]["final"]
    final["kernel"] = final["kernel"] * np.float32(final_scale)
    final["bias"] = final["bias"] * np.float32(final_scale)
    return net, out


def port_model(cfg, variables):
    model = get_pose_net(cfg)
    model.load_state_dict(pose_state_dict_from_jax(variables))
    return model.eval()


@pytest.mark.parametrize("resnet_type", [18, 50])
def test_pose_net_matches_jax(resnet_type):
    """Features, heatmap and decoded coords (both head arms) of the same
    weights. Logits are held to rtol 2e-3 / atol 2e-2 as
    test_pose_snapshot_oracle holds the converted torch net; coords, which
    average over the whole volume, to 1e-4."""
    cfg = small_config(resnet_type)
    J, D = cfg.num_joints, cfg.depth_dim
    net, variables = randomized_jax_variables(cfg, seed=resnet_type)
    model = port_model(cfg, variables)
    x = np.random.default_rng(7).normal(size=(2, 64, 64, 3)).astype(
        np.float32)

    jfeats = net.apply(variables, jnp.asarray(x), train=False,
                       return_features=True)
    jhm = net.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        feats = model(torch.from_numpy(x), return_features=True)
        hm = model(torch.from_numpy(x))
        coords_unfused = model.decode(hm)
        coords_fused = head_projection_integral(
            feats, *model.final_projection(), J, D)
    assert feats.shape == (2, 16, 16, 256) and feats.is_contiguous()
    assert hm.shape == (2, 16, 16, J * D) and hm.is_contiguous()
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(hm.numpy(), np.asarray(jhm),
                               rtol=2e-3, atol=2e-2)

    Wp, bp = net.final_projection(variables["params"])
    want_fused = jax_head_projection_integral(jfeats, Wp, bp, J, D, "xla")
    want_unfused = jax_softmax_integral(jhm, J, D, impl="xla")
    np.testing.assert_allclose(coords_fused.numpy(), np.asarray(want_fused),
                               atol=1e-4)
    np.testing.assert_allclose(coords_unfused.numpy(),
                               np.asarray(want_unfused), atol=1e-4)


@pytest.mark.parametrize("resnet_type", [18, 50])
def test_weights_bridge_round_trip(resnet_type):
    """JAX variables -> port state_dict -> load into the port's model ->
    its state_dict() -> the JAX package's convert_pose_snapshot gives back
    exactly the original variables."""
    cfg = small_config(resnet_type)
    _, variables = randomized_jax_variables(cfg, seed=3)
    model = port_model(cfg, variables)
    back = convert_pose_snapshot(model.state_dict(), resnet_type=resnet_type)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_model_layout_and_names():
    """Parameter names are the reference's, the forward keeps the NHWC
    memory layout end to end (channels_last convs, contiguous NHWC out), and
    compute_dtype bfloat16 runs the conv stack in bf16 over float32
    params."""
    cfg = ModelConfig(resnet_type=18, input_shape=(64, 64),
                      output_shape=(16, 16), depth_dim=4, num_joints=3)
    model = get_pose_net(cfg, generator=torch.Generator().manual_seed(0))
    names = set(model.state_dict())
    for key in ("backbone.conv1.weight", "backbone.bn1.running_var",
                "backbone.layer2.0.downsample.0.weight",
                "backbone.layer2.0.downsample.1.bias",
                "head.deconv_layers.0.weight", "head.deconv_layers.7.weight",
                "head.final_layer.weight", "head.final_layer.bias"):
        assert key in names, key
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        out = model.eval()(torch.rand(2, 64, 64, 3) * 255)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 16, 12)
    assert out.is_contiguous()
    w, b = model.final_projection()
    assert w.shape == (12, 256) and b.shape == (12,)
