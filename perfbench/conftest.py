"""The benchmark's tests: the fault kinds of traffic added after
``faults.py``, which ``tests/test_perfbench_faults.py`` reads for every
cell when it is collected.

``cyclegan_train`` runs ``gan_train``'s step (``train/gan.py``) and takes
its faults, which its module plants itself for ``calibrate.py``
(``calibrate_many``) and ``tests/test_perfbench_cyclegan.py`` plants; the
faults of ``faults.py`` refuse any kind they do not name, so this file lists
none for it. A ``faults.py`` that names the kind makes this file
unnecessary."""

from perfbench import faults

faults.KINDS.setdefault("cyclegan_train", ())
