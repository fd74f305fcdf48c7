"""Utilities: plotting, profiling (``profiling.trace``, ``StepTimer``) and
debugging (``debug.enable_nan_checks``)."""

from opensetgaitrecognition_pcaa_tpu_torch.utils.plotting import plot_pointcloud  # noqa: F401
