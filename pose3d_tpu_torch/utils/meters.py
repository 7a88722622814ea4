"""Running meters. Port of `pose3d_tpu/utils/meters.py`."""

from __future__ import annotations


class AverageValueMeter:
    """Weighted running average, semantics of the reference meter."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.avg = self.avg * (self.count / (self.count + n)) + val * (n / (self.count + n))
        self.count += n
