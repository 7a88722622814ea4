"""Shared-memory process-worker loader. Port of
`pose3d_tpu/data/shm_loader.py` (`batch_spec`, `_spec_layout`,
`_worker_main`, `ShmDataLoader`).

The thread `DataLoader` shares the GIL between its workers and the train
loop; the augmentations hold it. This loader moves sample production into
processes, without pickling samples through a pipe:

  * spawn-context worker processes (never forked: the parent may hold a
    CUDA context) each build whole stacked batches;
  * each batch is written straight into a preallocated `SharedMemory` slot;
    only a (seq, slot, n_valid) message crosses the result queue (with the
    worker's decode-cache stats, which `cache_stats()` sums);
  * the parent hands slots out from a free list, so at most `slots` batches
    are in flight and the memory is bounded; results are put back in
    sequence order;
  * the batches are the thread loader's: the same per-(seed, epoch) shuffle,
    per-process stride and per-(seed, epoch, index) sample RNG, the tail
    padded by repeating its last sample, or dropped.

The workers import the data layer only (numpy, PIL, pandas): the dataset is
pickled in the parent (it must hold no tensor, generator or bank; a
`DecodeCache` pickles empty) and the parent's main module, which for a CLI
imports torch and the models, is not run again in them, unless the dataset
is an instance of a class defined there. Spawn reads the main module from
the process-wide `sys.modules`, so the workers are started on the main
thread: entering the loader (`with`) there starts them, as the CLIs do
before a trainer's `Prefetcher` iterates it on a thread of its own.
A loader first started on another thread leaves `__main__` alone, and its
workers run the main module again.

The slots live in /dev/shm. A container often mounts it at 64 MB, where
creating a segment succeeds and the first write past the mount's size kills
the worker with SIGBUS; so the slots' bytes are checked against the free
space of /dev/shm before any worker starts, and a slot set that does not fit
is refused with both numbers. Nothing falls back to the thread loader.
Close the loader (a context manager, or `close()`) so that no segment
outlives the run.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import pickle
import queue
import sys
import threading
import traceback
import types
from multiprocessing import shared_memory
from typing import Any, Iterator

import numpy as np

from pose3d_tpu_torch.data.loader import DataLoader

SHM_PREFIX = "pose3d"
SHM_DIR = "/dev/shm"


def batch_spec(sample: dict[str, np.ndarray], batch_size: int) -> list[tuple[str, tuple, str]]:
    """(key, stacked shape, dtype str) of every array of a batch, then the
    'valid' mask, in a fixed order that the parent and the workers share."""
    spec = []
    for k in sorted(sample):
        arr = np.asarray(sample[k])
        spec.append((k, (batch_size, *arr.shape), arr.dtype.str))
    spec.append(("valid", (batch_size,), np.dtype(bool).str))
    return spec


def _spec_layout(spec) -> tuple[list[tuple[str, tuple, str, int]], int]:
    """Each key's byte offset (64-byte aligned) and the slot's size."""
    layout, off = [], 0
    for k, shape, dt in spec:
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        layout.append((k, shape, dt, off))
        off += (nbytes + 63) & ~63
    return layout, max(off, 1)


def _slot_views(buf, layout) -> dict[str, np.ndarray]:
    return {k: np.ndarray(shape, dtype=dt, buffer=buf, offset=off)
            for k, shape, dt, off in layout}


def _worker_main(dataset_bytes: bytes, spec, shm_names: list[str], task_q, result_q) -> None:
    """A worker's loop: take (seq, slot, seed, epoch, indices), write the
    stacked batch into the slot, answer (seq, slot, n_valid) and, where the
    dataset has a decode cache, the worker's pid and the cache's stats; None
    ends it. A failure answers ("error", traceback)."""
    try:
        dataset = pickle.loads(dataset_bytes)
        cache = getattr(dataset, "cache", None)
        layout, _ = _spec_layout(spec)
        # a spawned child shares the parent's resource tracker: attaching
        # registers the names again (a set), and the parent's unlink
        # unregisters them
        shms = [shared_memory.SharedMemory(name=n) for n in shm_names]
        views = [_slot_views(shm.buf, layout) for shm in shms]
    except Exception:
        result_q.put(("error", traceback.format_exc()))
        return
    try:
        while True:
            task = task_q.get()
            if task is None:
                break
            seq, slot, seed, epoch, indices = task
            try:
                out = views[slot]
                n, bs = len(indices), out["valid"].shape[0]
                for j, idx in enumerate(indices):
                    sample = dataset.get(int(idx), np.random.default_rng((seed, epoch, int(idx))))
                    for k, v in sample.items():
                        out[k][j] = v
                for j in range(n, bs):  # the tail padded with its last sample
                    for k in out:
                        if k != "valid":
                            out[k][j] = out[k][n - 1]
                out["valid"][:] = False
                out["valid"][:n] = True
                result_q.put(("ok", seq, slot, n, os.getpid(),
                              None if cache is None else cache.stats()))
            except Exception:
                result_q.put(("error", traceback.format_exc()))
    finally:
        del views
        for shm in shms:
            shm.close()


def _hides_main(dataset) -> bool:
    """Whether workers may start under a blank `__main__`: only on the main
    thread (`sys.modules` is the process's), and only where the dataset's
    class is not defined in the main module, which a worker must then
    import to unpickle it."""
    return (threading.current_thread() is threading.main_thread()
            and type(dataset).__module__ != "__main__")


@contextlib.contextmanager
def _main_module_hidden(hide: bool):
    """While workers start: a blank `__main__`, so that spawn does not run
    the parent's main module again in each of them."""
    main = sys.modules.get("__main__")
    if hide:
        sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        if hide:
            sys.modules["__main__"] = main


def shm_free_bytes() -> tuple[int, int]:
    """(free, total) bytes of the /dev/shm mount."""
    st = os.statvfs(SHM_DIR)
    return st.f_bavail * st.f_frsize, st.f_blocks * st.f_frsize


class ShmDataLoader(DataLoader):
    """The thread `DataLoader`'s batches from shared-memory process workers.

    Its constructor's, plus:
      slots: batch buffers in flight (default num_workers + 2).
      copy: True (the default): each batch yielded is a private copy. False:
        a zero-copy view of the slot, which is recycled once the next batch
        is asked for: a consumer copies it before that (the trainers'
        `Prefetcher` pins or copies each batch before it asks for the next).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, num_workers: int = 4, seed: int = 46,
                 process_index: int = 0, process_count: int = 1,
                 slots: int | None = None, copy: bool = True):
        super().__init__(dataset, batch_size, shuffle=shuffle, drop_last=drop_last,
                         num_workers=max(1, num_workers), seed=seed,
                         process_index=process_index, process_count=process_count)
        self.copy = copy
        self.slots = slots if slots is not None else self.num_workers + 2
        self.names: list[str] = []
        self._worker_stats: dict[int, dict] = {}
        self._started = False
        self._closed = False
        self._outstanding = 0  # tasks sent and not yet answered

    # -- the workers ----------------------------------------------------------
    def _start(self) -> None:
        """Check the slots against /dev/shm, create them and start the
        workers (idempotent; entering the loader calls it, and so does the
        first iteration of a loader not started yet)."""
        if self._started:
            return
        probe = self.dataset.get(0, np.random.default_rng(0))
        self._spec = batch_spec(probe, self.batch_size)
        self._layout, slot_bytes = _spec_layout(self._spec)
        free, total = shm_free_bytes()
        if self.slots * slot_bytes > free:
            raise RuntimeError(
                f"--loader shm: {self.slots} slots of {slot_bytes} bytes (batch "
                f"{self.batch_size}) need {self.slots * slot_bytes} bytes of {SHM_DIR}, "
                f"which has {free} bytes free of {total}: lower --batch_size or --workers, "
                f"or give {SHM_DIR} more room (docker: --shm-size)")
        uniq = f"{SHM_PREFIX}_{os.getpid()}_{id(self):x}"
        self._shms = []
        try:
            for i in range(self.slots):
                self._shms.append(shared_memory.SharedMemory(create=True, size=slot_bytes,
                                                             name=f"{uniq}_{i}"))
        except BaseException:
            self._release()
            raise
        self.names = [shm.name for shm in self._shms]
        self._views = [_slot_views(shm.buf, self._layout) for shm in self._shms]
        ctx = mp.get_context("spawn")
        self._task_q, self._result_q = ctx.Queue(), ctx.Queue()
        dataset_bytes = pickle.dumps(self.dataset)
        self._procs = [ctx.Process(target=_worker_main, daemon=True,
                                   args=(dataset_bytes, self._spec, self.names,
                                         self._task_q, self._result_q))
                       for _ in range(self.num_workers)]
        self._started = True
        with _main_module_hidden(_hides_main(self.dataset)):
            for p in self._procs:
                p.start()

    def _release(self) -> None:
        self._views = None
        for shm in self._shms:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        self._shms = []

    def close(self) -> None:
        """Stop the workers and unlink the slots (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            for _ in self._procs:
                self._task_q.put(None)
            for p in self._procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            self._release()

    def __enter__(self):
        try:
            self._start()
        except BaseException:
            self.close()
            raise
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def cache_stats(self) -> dict | None:
        """The workers' decode caches (`DecodeCache.stats`) summed, as each
        last reported them; None where the dataset has no cache."""
        if not hasattr(self.dataset, "cache"):
            return None
        total = {"items": 0, "mb": 0.0, "hits": 0, "misses": 0}
        for stats in self._worker_stats.values():
            for k in total:
                total[k] += stats[k]
        return total

    # -- iteration ------------------------------------------------------------
    def _fail(self, message: str) -> None:
        self.close()
        raise RuntimeError(f"ShmDataLoader worker failed:\n{message}")

    def _message(self):
        """The next worker message. A worker that died without a word
        (killed, or out of memory) fails the iteration instead of hanging
        it."""
        while True:
            try:
                msg = self._result_q.get(timeout=1.0)
            except queue.Empty:
                for p in self._procs:
                    if not p.is_alive():
                        self._fail(f"worker {p.pid} exited with code {p.exitcode}")
                continue
            self._outstanding -= 1
            if msg[0] == "error":
                self._fail(msg[1])
            return msg

    def _drain_stale(self) -> None:
        """Wait out the tasks an abandoned iteration left in flight: they may
        still write into slots this iteration is about to reuse."""
        while self._outstanding > 0:
            self._message()

    def __iter__(self) -> Iterator[dict[str, Any]]:
        if self._closed:
            raise RuntimeError("loader is closed")
        self._start()
        self._drain_stale()
        indices = self._indices()
        bs = self.batch_size
        starts = [s for s in range(0, len(indices), bs)
                  if not (self.drop_last and len(indices) - s < bs)]
        free = list(range(self.slots))
        next_task = 0
        done: dict[int, tuple[int, int]] = {}  # seq -> (slot, n_valid)
        retire: list[int] = []  # the slot handed out zero-copy, until the next batch

        def submit() -> None:
            nonlocal next_task
            while free and next_task < len(starts):
                slot = free.pop()
                chunk = indices[starts[next_task]:starts[next_task] + bs]
                self._task_q.put((next_task, slot, self.seed, self.epoch,
                                  np.asarray(chunk, np.int64)))
                self._outstanding += 1
                next_task += 1

        submit()
        for seq in range(len(starts)):
            while seq not in done:
                _, s, slot, n, pid, stats = self._message()
                if stats is not None:
                    self._worker_stats[pid] = stats
                done[s] = (slot, n)
            slot, _ = done.pop(seq)
            views = self._views[slot]
            if self.copy:
                batch = {k: v.copy() for k, v in views.items()}
                free.append(slot)
            else:
                if retire:
                    free.append(retire.pop())
                batch = dict(views)
                retire.append(slot)
            submit()
            yield batch
        free.extend(retire)
