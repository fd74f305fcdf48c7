"""Point-cloud scatter (port of ``opensetgaitrecognition_pcaa_tpu/utils/plotting.py:13-43``).

Numpy only: it draws into the 3-D Axes the caller passes, with the JAX
package's colours (each point by its normalized x, y, z), point size,
fixed limits, box aspect and title, and imports no plotting library.
"""

from __future__ import annotations

import numpy as np


def plot_pointcloud(
    ax,
    point_cloud,
    title: str = "Title",
    show_axis: bool = True,
    aspect: str = "equal",
    point_dimension: int = 8,
) -> None:
    """Scatter a ``(n_points, >= 3)`` cloud on ``ax``, an Axes made with
    ``fig.add_subplot(..., projection="3d")``; a tensor is read through
    ``np.asarray`` (on the CPU)."""
    pc = np.asarray(point_cloud)
    xs, ys, zs = pc[:, 0], pc[:, 1], pc[:, 2]

    def _norm(v):
        v0 = v - v.min()
        rng = v0.max()
        return v0 / rng if rng > 0 else np.zeros_like(v0)

    cols = np.stack([_norm(xs), _norm(ys), _norm(zs)], axis=1)
    ax.scatter(xs, ys, zs, c=cols, s=point_dimension)
    ax.set_xlim3d(-20, 20)
    ax.set_ylim3d(-10, 10)
    ax.set_zlim3d(-10, 10)
    if aspect == "equal":
        ax.set_box_aspect((np.ptp(xs), np.ptp(zs), np.ptp(ys)))
    if not show_axis:
        ax.set_axis_off()
    ax.set_title(title)
