"""Checkpointing with torch.save. Port of `pose3d_tpu/train/ckpt.py`.

One file per role under the run's `ckpt/` directory: `checkpoint.pth` (the
last epoch's train state: model, optimizer, schedule, dropout generator,
step), `best.pth` (the same, at the best validation accuracy), and the
image encoder alone (`checkpoint_img_encoder.pth`, `best_img_encoder.pth`),
as the reference keeps them. `EPOCH` holds the last saved epoch, so
`--resume` continues from it, and `BEST` the best validation accuracy so
far, so that a resumed run replaces `best.pth` only with a better state
(the JAX package restarts its best at 0 on a resume). Each file is
written to a temporary name and renamed into place, so a reader never
sees half a checkpoint. A checkpoint's "model" entry is the model's
state_dict, so the testing CLI's `--model` reads the teacher from
`checkpoint.pth` or `best.pth`.
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

    def _write(self, name: str, text: str) -> None:
        tmp = os.path.join(self.directory, f"{name}.tmp")
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(self.directory, name))

    def _read(self, name: str) -> str | None:
        p = os.path.join(self.directory, name)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return f.read().strip()

    def save_epoch(self, epoch: int, obj: Any, best_acc: float, is_best: bool = False) -> None:
        """The epoch's state as `checkpoint.pth` (and `best.pth` if
        `is_best`), then `best_acc`, the best accuracy so far, and the
        epoch."""
        self.save("checkpoint", obj)
        if is_best:
            self.save("best", obj)
        self._write("BEST", repr(float(best_acc)))
        self._write("EPOCH", str(epoch))

    def latest_epoch(self) -> int | None:
        text = self._read("EPOCH")
        return None if text is None else int(text)

    def best_acc(self) -> float:
        """The best validation accuracy saved so far (0 before any)."""
        text = self._read("BEST")
        return 0.0 if text is None else float(text)
