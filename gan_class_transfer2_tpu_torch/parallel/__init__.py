"""Parallelism over processes: the process group (``multihost``), the
rank grid with its data, tensor and multi-slice parallelism and ZeRO-1
(``mesh``, with the tensor-parallel conv's collectives in ``tensor``), and
spatial sharding (``spatial``, ``spatial_unet``, ``spatial_train``)."""
