"""Data for the port's training workloads.

``SyntheticTokens`` is a copy of ``tf_operator_tpu/train/data.py``'s class
(the port imports nothing of the JAX package), so the same seed gives the
same batches in both packages. ``TokenFileDataset``, the native loader and
the device prefetch stage are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np


class SyntheticTokens:
    """Infinite deterministic stream of token batches [batch, seq+1]
    (train_step splits input/target internally)."""

    def __init__(self, batch: int, seq: int, vocab_size: int, seed: int = 0):
        self.batch = batch
        self.seq = seq
        self.vocab_size = vocab_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self._rng.integers(
            0, self.vocab_size, size=(self.batch, self.seq + 1), dtype=np.int32
        )
