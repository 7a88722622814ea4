"""Datasets for tests/test_torch_host_data.py that `ShmDataLoader`'s
spawned workers unpickle. This module imports numpy and the standard
library only, so that a worker which unpickles them imports nothing more
than the dataset it wraps."""

import os
import sys
import time

import numpy as np


class BrokenDataset:
    """Samples 0-3 are zeros; from index 4 on `get` raises."""

    def __len__(self):
        return 8

    def get(self, idx, rng):
        if idx >= 4:
            raise ValueError("boom at sample %d" % idx)
        return {"x": np.zeros(2, np.float32)}


class DyingDataset(BrokenDataset):
    """From index 4 on, the process exits at once, as a killed one does."""

    def get(self, idx, rng):
        if idx >= 4:
            os._exit(3)
        return super().get(idx, rng)


class Holds(BrokenDataset):
    """BrokenDataset's samples; `text` is pickled with it."""

    def __init__(self, text):
        self.text = text


class SlowExcept:
    """`dataset`'s samples, each but those of `fast` taking `seconds` more,
    so that the tasks of a batch of other samples are still in flight when
    a consumer stops after one batch of `fast` ones."""

    def __init__(self, dataset, fast, seconds):
        self.dataset, self.fast, self.seconds = dataset, set(fast), seconds

    def __len__(self):
        return len(self.dataset)

    def get(self, idx, rng):
        if idx not in self.fast:
            time.sleep(self.seconds)
        return self.dataset.get(idx, rng)


class ModulesProbe:
    """`dataset`'s samples, each with 'torch' and 'jax': whether the
    process that built it had imported those packages."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def get(self, idx, rng):
        sample = dict(self.dataset.get(idx, rng))
        sample["torch"] = np.array("torch" in sys.modules)
        sample["jax"] = np.array("jax" in sys.modules)
        return sample
