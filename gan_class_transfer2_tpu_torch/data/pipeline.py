"""Host side of the input pipeline — counterpart of
gan_class_transfer2_tpu/data/pipeline.py, holding only ``EpochIndexStream``
(pipeline.py:80-138), copied: it is pure numpy, and the port imports nothing
of the JAX package. File decoding (PIL or the native loader) is not ported
yet."""

from __future__ import annotations

import numpy as np


class EpochIndexStream:
    """Shuffle-WITHOUT-replacement epoch index stream (the reference's
    shuffle(1000).repeat() over a permuted file list, train.py:318 — every
    element seen once per epoch). Deterministic given (seed, position) and
    restorable: ``state_dict()``/``set_state()`` capture the exact stream
    position for checkpoint/resume. The same ``(n, batch_size, seed)`` gives
    the JAX class's indices."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        if n <= 0:
            # an empty source would make next_indices spin forever
            raise ValueError(f"dataset is empty (n={n})")
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0
        self._offset = 0
        self._position = 0  # batches produced over the stream lifetime
        self._order_epoch = -1
        self._order = None

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_epoch != epoch:
            self._order = np.random.default_rng((self.seed, epoch)).permutation(self.n)
            self._order_epoch = epoch
        return self._order

    def next_indices(self) -> np.ndarray:
        idx = np.empty((self.batch_size,), np.int64)
        got = 0
        while got < self.batch_size:
            order = self._epoch_order(self._epoch)
            take = order[self._offset: self._offset + self.batch_size - got]
            idx[got: got + len(take)] = take
            got += len(take)
            self._offset += len(take)
            if self._offset >= self.n:
                self._epoch += 1
                self._offset = 0
        self._position += 1
        return idx

    @property
    def position(self) -> int:
        return self._position

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "offset": self._offset, "position": self._position}

    def set_state(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._offset = int(state["offset"])
        self._position = int(state["position"])
