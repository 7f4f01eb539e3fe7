"""Sharded execution: the mesh and the ring sweeps (``parallel/``)."""
