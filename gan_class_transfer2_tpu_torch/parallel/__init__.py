"""Parallelism: the process group (``multihost``), the rank grid with its
data, tensor and multi-slice parallelism and ZeRO-1 (``mesh``, with the
tensor-parallel conv's collectives in ``tensor``), spatial sharding
(``spatial``, ``spatial_unet``, ``spatial_train``), pipeline parallelism in
one process over local devices (``pipeline``) and the planner that picks
among them (``planner``)."""
