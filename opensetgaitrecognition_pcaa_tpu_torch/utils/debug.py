"""Debug helpers: NaN checking.

Port of ``opensetgaitrecognition_pcaa_tpu/utils/debug.py``.
"""

from __future__ import annotations

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Globally enable or disable autograd's anomaly detection
    (``torch.autograd.set_detect_anomaly``), the counterpart of JAX's
    ``jax_debug_nans``.

    It differs from it: JAX checks the output of every jitted computation
    and re-runs the culprit op by op to raise at the primitive that made
    the NaN, forward or backward. Anomaly detection checks the backward
    only: a backward function that returns a NaN raises, with the stack of
    the forward call that recorded it; a NaN made in a forward pass, or
    under ``torch.no_grad``, passes unseen until a gradient meets it. It
    records a stack for every autograd node, so it is costly: use it while
    debugging a diverging run, not in production training.
    """
    torch.autograd.set_detect_anomaly(enable)
