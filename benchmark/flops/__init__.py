"""Model FLOPs by family: ``benchmark/flops/<family>.py`` gives a family's
``step_flops(dims, batch, n_classes)`` (one training step) and, where it is
evaluated, ``crop_flops(dims, n_classes)`` (one crop's eval forward); the
MFU metrics find it by the cell's ``family``. Here: the lookup, and the
arithmetic of the layers that families share.

Each product of ``(m, k) @ (k, n)`` is ``2mkn`` forward, the same again for
the weight gradient, and the same again for the input gradient where the
input needs one.
"""

from __future__ import annotations

import importlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def family(name: str):
    """The module ``benchmark/flops/<name>.py``; an error that names the
    missing file where there is none."""
    path = os.path.join(HERE, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no FLOP count of family {name!r}: {path} is missing")
    return importlib.import_module(f"{__name__}.{name}")


def pointnet_widths(dims):
    d = dims["POINTNET_OUT_DIM"]
    widths = (d // 2, d // 2, d, d)
    return list(zip((dims["NFEATURES"],) + widths[:-1], widths))


def tcn_widths(dims):
    f = dims["DTC_FILTERS"]
    return list(zip((dims["POINTNET_OUT_DIM"],) + tuple(f[:-1]), f))


def decoder_widths(dims, n_in):
    s = dims["NSTEPS"] * dims["NMAX"] * dims["NFEATURES"]
    w = (s // 16, s // 8, s // 4, s // 2, s)
    return list(zip((n_in,) + w[:-1], w))


def dense_flops(rows, layers, first_input_grad=True):
    """Forward, weight gradient and input gradient of a stack of dense
    layers over ``rows`` rows."""
    fwd = [2 * rows * a * b for a, b in layers]
    return 3 * sum(fwd) - (0 if first_input_grad else fwd[0])


def backbone_step_flops(dims, batch):
    """The PointNet over every point (its first layer's input gradient
    excepted) and the TCN over every frame, forward and backward."""
    t, n = dims["NSTEPS"], dims["NMAX"]
    flops = dense_flops(batch * t * n, pointnet_widths(dims), first_input_grad=False)
    return flops + dense_flops(batch * t, [(3 * a, b) for a, b in tcn_widths(dims)])
