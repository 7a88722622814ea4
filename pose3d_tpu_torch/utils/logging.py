"""Logging. Port of `pose3d_tpu/utils/logging.py`: the reference's
append-only text logs (training_log.txt), a JSONL metrics stream, and the
loss and accuracy curves, written as CSV and, where matplotlib is
installed, as .eps figures (the card's machine has no matplotlib).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class TxtLogger:
    """Append-only text log, comparable with the reference's artifacts."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, text: str) -> None:
        with open(self.path, "a") as f:
            f.write(text)

    def line(self, text: str) -> None:
        self.write(text + "\n")


class MetricsWriter:
    """JSONL metrics stream: one record per event with a wall-clock stamp."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def plot_curves(path: str, losses: np.ndarray, accuracies: np.ndarray, epoch: int) -> None:
    """(epochs, 2) train/val losses and accuracies up to `epoch` ->
    curves_losses.csv and curves_accuracies.csv, and fig_losses.eps and
    fig_accuracies.eps where matplotlib is installed."""
    np.savetxt(os.path.join(path, "curves_losses.csv"), losses[: epoch + 1],
               delimiter=",", header="train_loss,val_loss", comments="")
    np.savetxt(os.path.join(path, "curves_accuracies.csv"), accuracies[: epoch + 1],
               delimiter=",", header="train_acc,val_acc", comments="")
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    for name, arr, ylab in (("fig_losses.eps", losses, "loss"),
                            ("fig_accuracies.eps", accuracies, "accuracy")):
        fig = plt.figure()
        plt.grid()
        xs = np.arange(1, epoch + 2)
        plt.plot(xs, arr[: epoch + 1, 0], "b+-", xs, arr[: epoch + 1, 1], "r+-")
        plt.legend((f"train_{ylab}", f"val_{ylab}"), loc="upper right", fontsize="xx-small")
        plt.xlabel("epoch")
        plt.ylabel(ylab)
        fig.savefig(os.path.join(path, name))
        plt.close(fig)
