"""The u8 image wire. Port of `pose3d_tpu/ops/augment.py dewire`.

Loaders may ship images across the host-to-device copy as uint8 (a quarter
of the bytes of float32); the step turns them back into the host's float
[0, 1] pixels. The on-device photometric augmentation of that module
(`device_augment`, `--device_augment`) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch


def dewire(im: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 / 255 (as `data.transforms.to_float_array`);
    float tensors pass through untouched, so a step takes both wires."""
    if im.dtype == torch.uint8:
        return im.to(torch.float32) / 255.0
    return im
