"""Run-level parallelism: ``grid.py`` trains the runs of a grid cell in
lockstep on one device. Data and tensor parallelism (the JAX package's
``parallel/mesh.py``) are not ported yet: ROADMAP.md Queue 1 item 11b."""
