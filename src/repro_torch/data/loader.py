"""Sharded, prefetching batch loader (straggler-tolerant input pipeline;
a copy of the reference's, pure numpy, so both packages draw the same
batches from the same seed and a checkpoint's loader state resumes in
either).

Production posture: the loader owns a background prefetch thread (host-side
overlap with device steps), deterministic shuffling keyed by (seed, epoch),
per-host sharding by ``process_index`` for multi-host launches, and a
``state_dict`` so checkpoint/restore resumes mid-epoch without replaying.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class ShardedBatcher:
    def __init__(
        self,
        arrays,                    # tuple of np arrays with equal leading dim
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        n = arrays[0].shape[0]
        assert all(a.shape[0] == n for a in arrays)
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0
        self.step_in_epoch = 0
        self._consumed: Optional[dict] = None

    # -- checkpointable state -------------------------------------------------
    def state_dict(self) -> dict:
        # the prefetch worker advances (epoch, step_in_epoch) up to
        # ``prefetch`` batches AHEAD of the training loop — checkpointing
        # that cursor would skip batches on resume.  The iterator therefore
        # tags every batch with its post-consumption cursor and records it
        # when the batch is actually handed to the caller; state_dict
        # returns that CONSUMED position.
        if self._consumed is not None:
            return dict(self._consumed)
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch,
                "seed": self.seed}

    def load_state_dict(self, st: dict) -> None:
        self.epoch = st["epoch"]
        self.step_in_epoch = st["step_in_epoch"]
        self.seed = st["seed"]
        self._consumed = None

    # -- iteration -------------------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = self.arrays[0].shape[0]
        if not self.shuffle:
            order = np.arange(n)
        else:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        return order[self.process_index :: self.process_count]

    def _batches(self) -> Iterator[tuple]:
        # yields (consumed_state, batch): the state a checkpoint must
        # record once this batch has been handed to the training loop
        while True:
            order = self._epoch_order(self.epoch)
            nb = len(order) // self.batch_size
            while self.step_in_epoch < nb:
                i = self.step_in_epoch
                idx = order[i * self.batch_size : (i + 1) * self.batch_size]
                self.step_in_epoch += 1
                state = {"epoch": self.epoch,
                         "step_in_epoch": self.step_in_epoch,
                         "seed": self.seed}
                yield state, tuple(a[idx] for a in self.arrays)
            self.epoch += 1
            self.step_in_epoch = 0

    def __iter__(self):
        if self.prefetch <= 0:
            for state, b in self._batches():
                self._consumed = state
                yield b
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            for item in self._batches():
                if stop.is_set():
                    return
                q.put(item)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                state, b = q.get()
                self._consumed = state
                yield b
        finally:
            stop.set()
