"""Byte-capped LRU cache of decoded images, so that epochs after the first
skip the image decode. Port of `pose3d_tpu/data/decode_cache.py`
(`DecodeCache`, `_NoCache`, `make`), its semantics unchanged.

The datasets decode every source image every epoch. A cache of decoded
pixels is exact: decoding is deterministic, and every PIL operation the
datasets apply afterwards (crop, resize, rotate, transpose, filter, paste
into a new image) returns a new image, so a cached image is handed out
shared, without a copy. A dataset that pastes into an image copies it
first (`ShapeNet` copies its background).

  * the key is `mode:path` ('*' for the file's own mode); an entry holds
    the fully loaded PIL image (`.load()` forces the decode at insert,
    outside the lock);
  * LRU eviction to a byte budget counted as w * h * bands, so a dataset
    larger than the budget degrades to its hot items (a MultiView model's
    renders, reused every epoch) while cold images churn; an image larger
    than the whole budget is served uncached;
  * thread-safe: the thread `DataLoader` calls `dataset.get` concurrently;
  * it pickles empty (its budget only): each `ShmDataLoader` process worker
    builds its own cache;
  * `stats()` gives its items, megabytes, hits and misses.

Off by default (`decode_cache_mb=0` on the datasets, `--cache_decoded_mb`
on the CLIs): `make(0)` is `_NoCache`, a plain decode.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from PIL import Image


def _nbytes(im: Image.Image) -> int:
    return im.size[0] * im.size[1] * len(im.getbands())


class DecodeCache:
    """LRU `mode:path` -> decoded PIL image, capped at `capacity_mb` MiB."""

    def __init__(self, capacity_mb: float):
        self.capacity_mb = float(capacity_mb)
        self._cap = int(capacity_mb * (1 << 20))
        self._lock = threading.Lock()
        self._items: OrderedDict[str, Image.Image] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def open_rgb(self, path: str) -> Image.Image:
        """`Image.open(path).convert('RGB')` through the cache."""
        return self._open(path, "RGB")

    def open_raw(self, path: str) -> Image.Image:
        """`Image.open(path)` in the file's own mode (an RGBA render)
        through the cache; the mode is part of the key, so both views of a
        file can be held."""
        return self._open(path, None)

    def _open(self, path: str, mode: str | None) -> Image.Image:
        key = f"{mode or '*'}:{path}"
        with self._lock:
            im = self._items.get(key)
            if im is not None:
                self._items.move_to_end(key)
                self.hits += 1
                return im
            self.misses += 1
        im = Image.open(path)
        if mode is not None and im.mode != mode:
            im = im.convert(mode)
        im.load()  # the decode, outside the lock
        n = _nbytes(im)
        if n > self._cap:
            return im  # larger than the whole budget: served uncached
        with self._lock:
            if key not in self._items:
                self._items[key] = im
                self._bytes += n
                while self._bytes > self._cap and len(self._items) > 1:
                    _, old = self._items.popitem(last=False)
                    self._bytes -= _nbytes(old)
            else:
                self._items.move_to_end(key)
            return self._items[key]

    def stats(self) -> dict:
        with self._lock:
            return {"items": len(self._items), "mb": self._bytes / (1 << 20),
                    "hits": self.hits, "misses": self.misses}

    # a process worker gets an empty cache of the same budget: decoded
    # images never cross the pickle
    def __getstate__(self):
        return {"capacity_mb": self.capacity_mb}

    def __setstate__(self, state):
        self.__init__(state["capacity_mb"])


class _NoCache:
    """The plain decode, when caching is off (the default)."""

    def open_rgb(self, path: str) -> Image.Image:
        return Image.open(path).convert("RGB")

    def open_raw(self, path: str) -> Image.Image:
        return Image.open(path)

    def stats(self) -> dict:
        return {"items": 0, "mb": 0.0, "hits": 0, "misses": 0}


def make(capacity_mb: float):
    """A `DecodeCache` of `capacity_mb` MiB, or `_NoCache` at 0."""
    return DecodeCache(capacity_mb) if capacity_mb and capacity_mb > 0 else _NoCache()
