"""The port's ``utils/plotting.py::plot_pointcloud`` against the JAX
package's: a recording Axes receives the same calls with equal arguments
from both, for an ordinary cloud, a degenerate one (every point equal),
hidden axes and no equal aspect. The port imports no plotting library."""

import numpy as np
import pytest

from opensetgaitrecognition_pcaa_tpu.utils.plotting import plot_pointcloud as jax_plot_pointcloud

from opensetgaitrecognition_pcaa_tpu_torch.utils import plot_pointcloud


class RecordingAxes:
    """Records each method call as (name, args, kwargs)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, args, kwargs))
        return record


def _assert_equal(a, b):
    if isinstance(b, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _assert_equal(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


CLOUDS = {
    "normal": lambda: np.random.default_rng(0).normal(size=(50, 4)) * 5,
    "degenerate": lambda: np.zeros((5, 3)),
    "f32 one point": lambda: np.ones((1, 4), np.float32),
}
OPTIONS = {
    "defaults": {},
    "hidden axes": dict(title="t", show_axis=False),
    "no aspect": dict(aspect="none", point_dimension=3),
}


@pytest.mark.parametrize("options", sorted(OPTIONS))
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_same_calls_as_jax(cloud, options):
    pc = CLOUDS[cloud]()
    got, want = RecordingAxes(), RecordingAxes()
    plot_pointcloud(got, pc, **OPTIONS[options])
    jax_plot_pointcloud(want, pc, **OPTIONS[options])
    assert [c[0] for c in got.calls] == [c[0] for c in want.calls]
    _assert_equal(got.calls, want.calls)
    colours = got.calls[0][2]["c"]
    assert np.isfinite(colours).all() and colours.min() >= 0 and colours.max() <= 1


def test_draws_with_matplotlib(tmp_path):
    """Into a real 3-D Axes, as the JAX package's test draws."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1, projection="3d")
    plot_pointcloud(ax, np.random.default_rng(0).normal(size=(50, 4)), title="t")
    fig.savefig(tmp_path / "pc.png")
    plt.close(fig)
    assert (tmp_path / "pc.png").stat().st_size > 0
