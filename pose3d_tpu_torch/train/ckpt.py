"""Checkpointing with torch.save. Port of `pose3d_tpu/train/ckpt.py`.

One file per role under the run's `ckpt/` directory: `checkpoint.pth` (the
last epoch's train state: model, optimizer, schedule, dropout generator,
step), `best.pth` (the same, at the best validation accuracy), and the
image encoder alone (`checkpoint_img_encoder.pth`, `best_img_encoder.pth`),
as the reference keeps them. `EPOCH` holds the last saved epoch, so
`--resume` continues from it. Each file is written to a temporary name and
renamed into place, so a reader never sees half a checkpoint. A
checkpoint's "model" entry is the model's state_dict, so the testing CLI's
`--model` reads the teacher from `checkpoint.pth` or `best.pth`.
"""

from __future__ import annotations

import os
from typing import Any

import torch


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pth")

    def save(self, name: str, obj: Any) -> None:
        tmp = self.path(name) + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, self.path(name))

    def restore(self, name: str) -> Any:
        """The saved object, its tensors on the CPU."""
        return torch.load(self.path(name), map_location="cpu", weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def save_epoch(self, epoch: int, obj: Any, is_best: bool = False) -> None:
        self.save("checkpoint", obj)
        tmp = os.path.join(self.directory, "EPOCH.tmp")
        with open(tmp, "w") as f:
            f.write(str(epoch))
        os.replace(tmp, os.path.join(self.directory, "EPOCH"))
        if is_best:
            self.save("best", obj)

    def latest_epoch(self) -> int | None:
        p = os.path.join(self.directory, "EPOCH")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())
