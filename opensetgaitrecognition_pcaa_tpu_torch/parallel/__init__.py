"""Parallelism: ``mesh.py`` places one run's data and tensor parallelism
over ranks of ``torch.distributed``; ``grid.py`` trains the runs of a grid
cell, each a solo state, on one device or a list of them."""

from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    state_shardings,
)
