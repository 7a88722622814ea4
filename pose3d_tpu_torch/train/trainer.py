"""The teacher's epoch loop: loader, train step, evaluation, checkpoints and
logs. Port of `pose3d_tpu/train/trainer.py` (`_device_batch`,
`_DeferredMeters`, `_Base._eval`, `TeacherTrainer.fit`).

Host batches reach the card off the consumer thread: a feeder thread pins
each batch and starts its host-to-device copies (`non_blocking`) on a side
stream, two batches ahead; the train loop's stream waits on the copy's
event only when it takes the batch. Per-step metrics stay on the device
until a flush (at the print cadence and at the end of an epoch), so the
loop does not wait for the card after every step.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from pose3d_tpu_torch.train import steps as steps_lib
from pose3d_tpu_torch.train.ckpt import Checkpointer
from pose3d_tpu_torch.train.evaluate import CategoryEvalResult, evaluate_categories
from pose3d_tpu_torch.train.state import TrainState
from pose3d_tpu_torch.utils.logging import MetricsWriter, TxtLogger, plot_curves
from pose3d_tpu_torch.utils.meters import AverageValueMeter


class Prefetcher:
    """Iterates (device batch, host valid mask) over a loader's host
    batches. The device batch holds `keys` and, only when some row is
    padded, 'valid' (JAX attaches it the same way, so full batches keep the
    mask-free path). Exceptions of the loader re-raise in the consumer."""

    _DONE = object()

    DEPTH = 2  # batches placed ahead of the consumer

    def __init__(self, loader: Iterable[dict], keys: Sequence[str], device: torch.device):
        self.keys, self.device = tuple(keys), device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=self.DEPTH)
        self._err: BaseException | None = None

        def run():
            try:
                if self._stream is not None:
                    torch.cuda.set_device(device)
                for batch in loader:
                    self._q.put(self._place(batch))
            except BaseException as e:  # re-raised in __next__
                self._err = e
            finally:
                self._q.put(Prefetcher._DONE)

        self._thread = threading.Thread(target=run, daemon=True, name="pose3d-torch-prefetch")
        self._thread.start()

    def _place(self, batch: dict):
        valid = np.asarray(batch["valid"], bool)
        host = {k: batch[k] for k in self.keys if k in batch}
        if not valid.all():
            host["valid"] = valid
        if self._stream is None:
            return {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in host.items()}, valid, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, valid, event

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is Prefetcher._DONE:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        out, valid, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in out.values():  # the allocator must not reuse them early
                t.record_stream(stream)
        return out, valid


class DeferredMeters:
    """Per-step device metrics without a sync per step: push() keeps the
    device scalars; flush() brings them to the host in one copy and feeds
    the meters in order, so the running averages are those of an eager
    loop. flush() waits for every queued step: call it before reading a
    wall clock."""

    def __init__(self, loss_m: AverageValueMeter, acc_m: AverageValueMeter):
        self.loss_m, self.acc_m = loss_m, acc_m
        self._pending: list = []

    def push(self, metrics: dict, n: int) -> None:
        self._pending.append((metrics, n))

    def flush(self) -> None:
        if not self._pending:
            return
        values = torch.stack([torch.stack([m["loss"], m["acc_rot"]])
                              for m, _ in self._pending]).cpu().numpy()
        for (_, n), (lo, ac) in zip(self._pending, values):
            self.loss_m.update(float(lo), n)
            self.acc_m.update(float(ac), n)
        self._pending.clear()


class TeacherTrainer:
    """Contrastive PointCloud teacher training (the reference's training.py
    recipe): per epoch a train sweep, the validation loss and contrastive
    loss on `eval_loader`, the per-category Acc@pi/6 on `cat_eval_loader`
    (the reference computes them on another set; `eval_loader` when None),
    the checkpoints (whole train state, and the image encoder alone), one
    log line, one metrics record and the curves."""

    def __init__(self, state: TrainState, train_loader, eval_loader,
                 category_names: list[str], result_path: str, bin_size: int = 15,
                 print_freq: int = 50, cat_eval_loader=None, use_fused_nce: bool = False):
        self.state = state
        self.device = next(state.model.parameters()).device
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.cat_eval_loader = cat_eval_loader or eval_loader
        self.category_names = category_names
        self.print_freq = print_freq
        self.result_path = result_path
        os.makedirs(result_path, exist_ok=True)
        self.log = TxtLogger(os.path.join(result_path, "training_log.txt"))
        self.metrics = MetricsWriter(os.path.join(result_path, "metrics.jsonl"))
        self.ckpt = Checkpointer(os.path.join(result_path, "ckpt"))
        self.train_step = steps_lib.make_teacher_train_step(bin_size,
                                                            use_fused_nce=use_fused_nce)
        self.eval_step = steps_lib.make_eval_step(state.model, "teacher", bin_size)

    def _eval(self, loader) -> CategoryEvalResult:
        # cat_id indexes the producing dataset's sorted categories
        names = getattr(getattr(loader, "dataset", None), "category_names",
                        self.category_names)
        return evaluate_categories(self.eval_step, loader, names, self.device)

    def fit(self, epochs: int, start_epoch: int = 0) -> float:
        best_acc = 0.0
        losses = np.zeros((epochs, 2))
        accuracies = np.zeros((epochs, 2))
        for epoch in range(start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            train_loss, train_acc = AverageValueMeter(), AverageValueMeter()
            meters = DeferredMeters(train_loss, train_acc)
            data_time, batch_time = AverageValueMeter(), AverageValueMeter()
            t0 = end = time.time()
            batches = Prefetcher(self.train_loader, ("im", "shape", "label"), self.device)
            for i, (db, valid) in enumerate(batches):
                data_time.update(time.time() - end)
                meters.push(self.train_step(self.state, db), int(valid.sum()))
                # the enqueue cadence, not a synced step time
                batch_time.update(time.time() - end)
                end = time.time()
                if (i + 1) % self.print_freq == 0:
                    meters.flush()
                    print(f"\tEpoch {epoch:3d} --- Iter [{i + 1}/{len(self.train_loader)}] "
                          f"Train loss: {train_loss.avg:.2f} || "
                          f"Train accuracy: {train_acc.avg:.2f}")
                    print(f"\tData loading time: {data_time.val:.2f} ({data_time.avg:.2f})"
                          f"-- Batch time: {batch_time.val:.2f} ({batch_time.avg:.2f})\n")
            meters.flush()
            train_seconds = time.time() - t0

            result = self._eval(self.eval_loader)
            if self.cat_eval_loader is not self.eval_loader:
                eval_acc = self._eval(self.cat_eval_loader).mean_acc
            else:
                eval_acc = result.mean_acc
            is_best = eval_acc > best_acc
            best_acc = max(best_acc, eval_acc)
            losses[epoch] = [train_loss.avg, result.val_loss]
            accuracies[epoch] = [train_acc.avg, eval_acc]

            # the whole train state, and the image encoder alone
            self.ckpt.save_epoch(epoch, self.state.state_dict(), is_best=is_best)
            img_encoder = {"model": self.state.model.img_encoder.state_dict()}
            self.ckpt.save("checkpoint_img_encoder", img_encoder)
            if is_best:
                self.ckpt.save("best_img_encoder", img_encoder)

            self.log.line(
                "Epoch: %03d || train_loss %.2f -- val_loss %.2f || train_acc %.2f -- "
                "val_acc %.2f -- val_contrastive_loss %.2f \n" %
                (epoch, train_loss.avg, result.val_loss, train_acc.avg, eval_acc,
                 result.val_nce_loss))
            self.metrics.write({"kind": "teacher_epoch", "epoch": epoch,
                                "train_loss": train_loss.avg, "train_acc": train_acc.avg,
                                "val_loss": result.val_loss, "val_acc": eval_acc,
                                "val_nce": result.val_nce_loss,
                                "epoch_seconds": time.time() - t0,
                                "train_seconds": train_seconds,
                                "train_samples": train_loss.count,
                                "per_category_acc": result.per_category_acc})
            plot_curves(self.result_path, losses, accuracies, epoch)
        return best_acc
