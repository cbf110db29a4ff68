"""Multi-process data parallelism: the process group (``multihost``) and the
data-parallel mesh, its ZeRO-1 optimizer sharding and its parallel steps
(``mesh``)."""
