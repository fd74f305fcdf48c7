"""Utilities; the JAX package's ``profiling`` and ``debug`` are TPU tools
with no counterpart here."""

from opensetgaitrecognition_pcaa_tpu_torch.utils.plotting import plot_pointcloud  # noqa: F401
