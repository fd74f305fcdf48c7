"""The port's command-line drivers, run as ``python -m
opensetgaitrecognition_pcaa_tpu_torch.scripts.<name>``."""
