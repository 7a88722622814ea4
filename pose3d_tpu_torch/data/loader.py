"""Batched loader: threads prefetch fixed-shape numpy batches. Port of
`pose3d_tpu/data/loader.py DataLoader`.

  * thread-pool sample fetch (PIL releases the GIL for decode and resize);
  * per-process data sharding: process `process_index` of `process_count`
    owns the strided slice of the global index stream (default 0 of 1);
  * every batch is a dict of stacked numpy arrays with a 'valid' mask; the
    tail batch is padded to full batch_size by repeating its last sample;
  * deterministic per-(seed, epoch, index) RNG for augmentations.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Any, Iterator

import numpy as np


def _pad_to(batch_list: list[dict], batch_size: int) -> tuple[list[dict], np.ndarray]:
    valid = np.zeros(batch_size, bool)
    valid[: len(batch_list)] = True
    while len(batch_list) < batch_size:
        batch_list.append(batch_list[-1])
    return batch_list, valid


def _stack(samples: list[dict], valid: np.ndarray) -> dict[str, Any]:
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    out["valid"] = valid
    return out


class DataLoader:
    """Iterable over epochs of batches.

    Args:
      dataset: object with __len__ and get(idx, rng) -> dict of numpy arrays.
      batch_size: per-process batch size.
      shuffle: reshuffle indices every epoch.
      drop_last: drop the ragged tail instead of padding it.
      num_workers: prefetch threads (0 = synchronous).
      seed: base seed for shuffling + per-sample augmentation RNG.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, num_workers: int = 4, seed: int = 46,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def close(self) -> None:
        """Nothing to free (`ShmDataLoader` stops its workers here)."""

    def cache_stats(self) -> dict | None:
        """The dataset's decode cache's stats (`DecodeCache.stats`), or None
        where it has none."""
        cache = getattr(self.dataset, "cache", None)
        return None if cache is None else cache.stats()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx[self.process_index :: self.process_count]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, Any]]:
        indices = self._indices()
        bs = self.batch_size
        starts = [s for s in range(0, len(indices), bs)
                  if not (self.drop_last and len(indices) - s < bs)]

        def fetch(i: int) -> dict:
            rng = np.random.default_rng((self.seed, self.epoch, int(i)))
            return self.dataset.get(int(i), rng)

        if self.num_workers <= 0:
            for start in starts:
                samples, valid = _pad_to([fetch(i) for i in indices[start:start + bs]], bs)
                yield _stack(samples, valid)
            return

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # keep up to 2 batches in flight beyond the one being consumed
            ahead = 2
            pending = [[pool.submit(fetch, i) for i in indices[s:s + bs]]
                       for s in starts[: ahead + 1]]
            for k in range(len(starts)):
                futs = pending.pop(0)
                if k + ahead + 1 < len(starts):
                    s = starts[k + ahead + 1]
                    pending.append([pool.submit(fetch, i) for i in indices[s:s + bs]])
                samples, valid = _pad_to([f.result() for f in futs], bs)
                yield _stack(samples, valid)
