"""Hand-skeleton visualisation.

A copy of hand_integral_pose_estimation_tpu/utils/visualize.py over the
port's `config.FreiHandJoints`: the reference's `plot_hand`
(data/FreiHand/FreiHand.py:53-84, matplotlib) and the plotly 3D traces
(main/plot.py:18-60). Colours follow FreiHand_config.py:6-55. The module
imports no plotting library: `plot_hand` draws on the axis it is given and
`hand_traces_3d` returns plain dicts.
"""

from __future__ import annotations

import numpy as np

from hand_integral_pose_estimation_tpu_torch.config import FreiHandJoints

# per-joint colours (FreiHand_config.py:6-27, RGB after the BGR flip)
JOINT_COLORS = np.array([
    [0.4, 0.4, 0.4], [0.0, 0.0, 0.4], [0.0, 0.0, 0.6], [0.0, 0.0, 0.8],
    [0.0, 0.0, 1.0], [0.0, 0.4, 0.4], [0.0, 0.6, 0.6], [0.0, 0.8, 0.8],
    [0.0, 1.0, 1.0], [0.2, 0.4, 0.0], [0.3, 0.6, 0.0], [0.4, 0.8, 0.0],
    [0.5, 1.0, 0.0], [0.4, 0.2, 0.0], [0.6, 0.3, 0.0], [0.8, 0.4, 0.0],
    [1.0, 0.5, 0.0], [0.4, 0.0, 0.4], [0.6, 0.0, 0.6], [0.8, 0.0, 0.7],
    [1.0, 0.0, 1.0],
])


def plot_hand(axis, coords_hw: np.ndarray, vis=None, color_fixed=None,
              linewidth: str = "1", order: str = "hw", draw_kp: bool = True):
    """Draw the 21-joint skeleton on a matplotlib axis
    (FreiHand.py:53-84 semantics: `order='hw'` plots (row, col) input;
    `order='uv'` plots (x, y))."""
    if order == "uv":
        coords_hw = coords_hw[:, ::-1]
    if vis is None:
        vis = np.ones(coords_hw.shape[0], bool)

    for a, b in FreiHandJoints.bones:
        if not (vis[a] and vis[b]):
            continue
        seg = np.stack([coords_hw[a], coords_hw[b]])
        color = JOINT_COLORS[b] if color_fixed is None else color_fixed
        axis.plot(seg[:, 1], seg[:, 0], color=color, linewidth=linewidth)

    if draw_kp:
        for i in range(coords_hw.shape[0]):
            if vis[i]:
                axis.plot(coords_hw[i, 1], coords_hw[i, 0], "o",
                          color=JOINT_COLORS[i])


def hand_traces_3d(joints: np.ndarray, name: str = "hand"):
    """Plotly 3D skeleton traces (main/plot.py:18-60): a list of dicts
    (`go.Scatter3d(**trace)` builds them where plotly is installed), one
    line trace per bone and one marker trace of the joints."""
    traces = []
    for a, b in FreiHandJoints.bones:
        traces.append({
            "type": "scatter3d",
            "mode": "lines",
            "x": [float(joints[a, 0]), float(joints[b, 0])],
            "y": [float(joints[a, 1]), float(joints[b, 1])],
            "z": [float(joints[a, 2]), float(joints[b, 2])],
            "name": f"{name}:{a}-{b}",
        })
    traces.append({
        "type": "scatter3d",
        "mode": "markers",
        "x": joints[:, 0].tolist(),
        "y": joints[:, 1].tolist(),
        "z": joints[:, 2].tolist(),
        "name": f"{name}:joints",
    })
    return traces
