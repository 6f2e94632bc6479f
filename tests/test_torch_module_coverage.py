"""The port covers the JAX package: every module of
`hand_integral_pose_estimation_tpu/` has a counterpart at the same relative
path in `hand_integral_pose_estimation_tpu_torch/`, or stands in
`NOT_PORTED` with the reason it needs none."""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "hand_integral_pose_estimation_tpu")
PORT_PKG = os.path.join(ROOT, "hand_integral_pose_estimation_tpu_torch")

#: JAX modules with no port module of the same path, and why
NOT_PORTED = {
    "interop/torch_weights.py": (
        "the bridge from torch weights into flax variables: the port loads "
        "reference .pth files natively (interop/snapshot.py: pose "
        "snapshots and imagenet_init_backbone; detect/load.py: the "
        "detector), and interop/jax_params.py bridges the other way"),
}


def _modules(pkg: str) -> set[str]:
    out = set()
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out.update(os.path.relpath(os.path.join(root, f), pkg)
                   for f in files if f.endswith(".py"))
    return out


def test_every_jax_module_has_a_port_counterpart():
    missing = sorted(_modules(JAX_PKG) - _modules(PORT_PKG)
                     - NOT_PORTED.keys())
    assert not missing, f"JAX modules with no port counterpart: {missing}"


@pytest.mark.parametrize("module", sorted(NOT_PORTED))
def test_not_ported_entries_are_real(module):
    """Each exception names a JAX module that the port really lacks, with
    a reason."""
    assert os.path.exists(os.path.join(JAX_PKG, module))
    assert not os.path.exists(os.path.join(PORT_PKG, module))
    assert len(NOT_PORTED[module].split()) >= 5


def test_utils_exports_match_jax():
    """`utils` exports the JAX package's runner utilities by name."""
    import ast

    def names(pkg):
        with open(os.path.join(pkg, "utils", "__init__.py")) as f:
            tree = ast.parse(f.read())
        return {a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom) for a in node.names}

    assert names(JAX_PKG) == names(PORT_PKG) == {
        "color_logger", "Timer", "MetricsWriter", "hand_traces_3d",
        "plot_hand"}
