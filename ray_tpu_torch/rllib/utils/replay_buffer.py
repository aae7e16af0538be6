"""Uniform transition replay buffer (a numpy ring on the host),
counterpart of the JAX package's `rllib/utils/replay_buffer.py` (parity:
the reference's `rllib/utils/replay_buffers/`, cut to the uniform
transition sampling DQN and SAC need).

Storage stays in host memory; only a sampled minibatch crosses to the
card. Sampling draws from `np.random.default_rng(seed)`, so for the same
seed and the same adds it returns the JAX package's samples bit for bit.
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._store: dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add_batch(self, batch: dict):
        n = len(next(iter(batch.values())))
        if not self._store:
            for k, v in batch.items():
                self._store[k] = np.empty((self.capacity, *v.shape[1:]),
                                          v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> dict:
        idx = self._rng.integers(0, self._size, batch_size)
        return {k: v[idx] for k, v in self._store.items()}
