"""Utilities: plotting, profiling (the program's spans and counters,
``profiling.span``, ``count`` and ``recording``, and ``profiling.trace``)
and debugging (``debug.enable_nan_checks``)."""

from opensetgaitrecognition_pcaa_tpu_torch.utils.plotting import plot_pointcloud  # noqa: F401
