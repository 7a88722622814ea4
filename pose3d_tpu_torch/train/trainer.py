"""The epoch loops: loader, train step, evaluation, checkpoints and logs.
Port of `pose3d_tpu/train/trainer.py` (`_device_batch`, `_DeferredMeters`,
`_Base._eval`, `TeacherTrainer.fit`, `SupervisedTrainer.fit`, and
`KDTrainer.fit_crd` and `.fit_stage2` with their `_student_loop`, and
`KDTrainer.fit_stage1` with its memory bank).

Host batches reach the card off the consumer thread: a feeder thread pins
each batch and starts its host-to-device copies (`non_blocking`) on a side
stream, two batches ahead; the train loop's stream waits on the copy's
event only when it takes the batch. Per-step metrics stay on the device
until a flush (at the print cadence and at the end of an epoch), so the
loop does not wait for the card after every step.

The on-device data options (JAX's `_jit_step` binding, `_shape_batch_keys`
and `_view_keys`): a trainer given `shape_bank` (a `ShapeBank` or
`RenderBank` on its device) binds it into its train step, and its loader's
batches carry the bank's scalar keys in place of 'shape'; with
`device_augment` the views arrive as raw uint8 pixels, and with
`device_views` (KD) one raw view a sample and 'rot_sign'. Evaluation runs
on host shapes, as JAX's trainers evaluate.

`profile_dir` (JAX's `_maybe_profile`, the CLIs' `--profile_dir`): a
`torch.profiler` trace of steps [5, 15) of the first epoch a trainer runs,
CPU activity and, on the card, CUDA activity (`StepProfiler`).
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from pose3d_tpu_torch.losses.memory_bank import MemoryBank, init_memory_bank
from pose3d_tpu_torch.ops.shape_bank import RenderBank, ShapeBank
from pose3d_tpu_torch.train import steps as steps_lib
from pose3d_tpu_torch.train.ckpt import Checkpointer
from pose3d_tpu_torch.train.evaluate import CategoryEvalResult, evaluate_categories, host_array
from pose3d_tpu_torch.train.state import TrainState
from pose3d_tpu_torch.utils.logging import MetricsWriter, TxtLogger, plot_curves
from pose3d_tpu_torch.utils.meters import AverageValueMeter


class Prefetcher:
    """Iterates (device batch, host valid mask) over a loader's host
    batches. The device batch holds `keys` and, only when some row is
    padded, 'valid' (JAX attaches it the same way, so full batches keep the
    mask-free path); uint8 images stay uint8 on the wire, and u32 seeds
    travel as int64 (`evaluate.host_array`). Exceptions of the loader
    re-raise in the consumer.

    Each batch is copied out of the loader's arrays before the next is
    asked for: on the card into pinned memory, on the CPU into tensors of
    its own (and the valid mask into an array of its own), so a loader may
    hand out buffers it recycles once the next batch is asked for (the
    zero-copy `ShmDataLoader`)."""

    _DONE = object()

    DEPTH = 2  # batches placed ahead of the consumer

    def __init__(self, loader: Iterable[dict], keys: Sequence[str], device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
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
        valid = np.array(batch["valid"], bool)
        host = {k: host_array(batch[k]) for k in self.keys if k in batch}
        if not valid.all():
            host["valid"] = valid
        if self._stream is None:
            return {k: torch.tensor(v, device=self.device)
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


class StepProfiler:
    """JAX's `_maybe_profile`: with `profile_dir`, one `torch.profiler`
    trace of steps [FIRST, END) of the first epoch that reaches step FIRST
    (CPU activity, and CUDA activity on a CUDA device), each step inside a
    "step i" annotation. It starts before step FIRST and stops before step
    END, or at the end of an epoch shorter than END; the trace is written
    to `<profile_dir>/<name>_steps<FIRST>-<last>.pt.trace.json` and its
    path printed. Without `profile_dir` nothing is recorded or written."""

    FIRST, END = 5, 15

    def __init__(self, profile_dir: str | None, name: str, device: torch.device):
        self.profile_dir, self.name, self.device = profile_dir, name, device
        self.done = profile_dir is None
        self._prof = None
        self._last = -1

    def step(self, i: int):
        """The context to run step i in."""
        if self.done:
            return contextlib.nullcontext()
        if i == self.END:
            self.stop()
            return contextlib.nullcontext()
        if i == self.FIRST and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        if self._prof is None:
            return contextlib.nullcontext()
        self._last = i
        return torch.profiler.record_function(f"step {i}")

    def stop(self) -> None:
        """End the trace (if one is running), write it and print its path."""
        if self.done or self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        self.done = True
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir,
                            f"{self.name}_steps{self.FIRST}-{self._last}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"profiler trace written to {path}")


def shape_batch_keys(shape_bank: ShapeBank | RenderBank | None) -> tuple[str, ...]:
    """The loader keys that carry a sample's shape: 'shape', or the bank's
    scalar reference keys (they differ between the two banks)."""
    return ("shape",) if shape_bank is None else shape_bank.batch_keys


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
    """Contrastive teacher training, PointCloud or MultiView (the
    reference's training.py recipe): per epoch a train sweep, the
    validation loss and contrastive loss on `eval_loader`, the
    per-category Acc@pi/6 on `cat_eval_loader` (the reference computes
    them on another set; `eval_loader` when None),
    the checkpoints (whole train state, and the image encoder alone), one
    log line, one metrics record and the curves. `nce_variant` and
    `nce_weighting` select the contrastive term (`make_teacher_train_step`);
    `device_augment` and `shape_bank` are the step's."""

    def __init__(self, state: TrainState, train_loader, eval_loader,
                 category_names: list[str], result_path: str, bin_size: int = 15,
                 print_freq: int = 50, cat_eval_loader=None, use_fused_nce: bool = False,
                 nce_variant: str = "info", nce_weighting: str = "linear",
                 device_augment: bool = False, shape_bank=None,
                 profile_dir: str | None = None):
        self.state = state
        self.device = next(state.model.parameters()).device
        self.profiler = StepProfiler(profile_dir, "teacher", self.device)
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
        self.keys = ("im", *shape_batch_keys(shape_bank), "label")
        self.train_step = steps_lib.make_teacher_train_step(
            bin_size, use_fused_nce=use_fused_nce, nce_variant=nce_variant,
            nce_weighting=nce_weighting, device_augment=device_augment, shape_bank=shape_bank)
        self.eval_step = steps_lib.make_eval_step(state.model, "teacher", bin_size)

    def _eval(self, loader) -> CategoryEvalResult:
        # cat_id indexes the producing dataset's sorted categories
        names = getattr(getattr(loader, "dataset", None), "category_names",
                        self.category_names)
        return evaluate_categories(self.eval_step, loader, names, self.device)

    def fit(self, epochs: int, start_epoch: int = 0) -> float:
        best_acc = self.ckpt.best_acc() if start_epoch > 0 else 0.0
        losses = np.zeros((epochs, 2))
        accuracies = np.zeros((epochs, 2))
        for epoch in range(start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            train_loss, train_acc = AverageValueMeter(), AverageValueMeter()
            meters = DeferredMeters(train_loss, train_acc)
            data_time, batch_time = AverageValueMeter(), AverageValueMeter()
            t0 = end = time.time()
            batches = Prefetcher(self.train_loader, self.keys, self.device)
            try:  # the trace ends however the loop does
                for i, (db, valid) in enumerate(batches):
                    data_time.update(time.time() - end)
                    with self.profiler.step(i):
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
            finally:
                self.profiler.stop()
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
            self.ckpt.save_epoch(epoch, self.state.state_dict(), best_acc, is_best=is_best)
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


class SupervisedTrainer:
    """Plain 4-term pose-loss training (the reference's training.py
    `train_vanilla`): the RGB-only `BaselineEstimator` baseline (`kind`
    "student", `--shape None`) or a `PoseEstimatorVanilla` ("vanilla"),
    by `make_vanilla_train_step`. Per epoch a train sweep, the per-category
    evaluation on `eval_loader`, the whole train state as the checkpoint
    (its "model" entry is what the testing CLI's `--model` reads), one log
    line, one metrics record and the curves. `shape_bank`: the vanilla
    teacher's shapes from a device-resident bank."""

    def __init__(self, state: TrainState, train_loader, eval_loader,
                 category_names: list[str], result_path: str, kind: str = "student",
                 bin_size: int = 15, print_freq: int = 50, shape_bank=None,
                 profile_dir: str | None = None):
        self.state = state
        self.device = next(state.model.parameters()).device
        self.profiler = StepProfiler(profile_dir, kind, self.device)
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.category_names = category_names
        self.print_freq = print_freq
        self.result_path = result_path
        os.makedirs(result_path, exist_ok=True)
        self.log = TxtLogger(os.path.join(result_path, "training_log.txt"))
        self.metrics = MetricsWriter(os.path.join(result_path, "metrics.jsonl"))
        self.ckpt = Checkpointer(os.path.join(result_path, "ckpt"))
        has_shape = kind != "student"
        self.keys = (("im", *shape_batch_keys(shape_bank), "label") if has_shape
                     else ("im", "label"))
        self.train_step = steps_lib.make_vanilla_train_step(has_shape, bin_size,
                                                            shape_bank=shape_bank)
        self.eval_step = steps_lib.make_eval_step(state.model, kind, bin_size)

    def fit(self, epochs: int, start_epoch: int = 0) -> float:
        best_acc = self.ckpt.best_acc() if start_epoch > 0 else 0.0
        losses = np.zeros((epochs, 2))
        accuracies = np.zeros((epochs, 2))
        for epoch in range(start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            loss_m, acc_m = AverageValueMeter(), AverageValueMeter()
            meters = DeferredMeters(loss_m, acc_m)
            t0 = time.time()
            batches = Prefetcher(self.train_loader, self.keys, self.device)
            try:  # the trace ends however the loop does
                for i, (db, valid) in enumerate(batches):
                    with self.profiler.step(i):
                        meters.push(self.train_step(self.state, db), int(valid.sum()))
                    if (i + 1) % self.print_freq == 0:
                        meters.flush()
                        print(f"\tEpoch {epoch:3d} --- Iter [{i + 1}/{len(self.train_loader)}] "
                              f"Train loss: {loss_m.avg:.2f} || Train accuracy: {acc_m.avg:.2f}")
            finally:
                self.profiler.stop()
            meters.flush()
            train_seconds = time.time() - t0

            names = getattr(getattr(self.eval_loader, "dataset", None), "category_names",
                            self.category_names)
            result = evaluate_categories(self.eval_step, self.eval_loader, names, self.device)
            is_best = result.mean_acc > best_acc
            best_acc = max(best_acc, result.mean_acc)
            losses[epoch] = [loss_m.avg, result.val_loss]
            accuracies[epoch] = [acc_m.avg, result.mean_acc]
            self.ckpt.save_epoch(epoch, self.state.state_dict(), best_acc, is_best=is_best)
            self.log.line(
                "Epoch: %03d || train_loss %.2f -- val_loss %.2f || train_acc %.2f -- "
                "val_acc %.2f \n" %
                (epoch, loss_m.avg, result.val_loss, acc_m.avg, result.mean_acc))
            self.metrics.write({"kind": "supervised_epoch", "epoch": epoch,
                                "train_loss": loss_m.avg, "train_acc": acc_m.avg,
                                "val_loss": result.val_loss, "val_acc": result.mean_acc,
                                "val_med": result.mean_med,
                                "epoch_seconds": time.time() - t0,
                                "train_seconds": train_seconds,
                                "train_samples": loss_m.count,
                                "train_samples_per_s": loss_m.count / max(train_seconds, 1e-9)})
            plot_curves(self.result_path, losses, accuracies, epoch)
        return best_acc


class KDTrainer:
    """The KD regimes of the reference's trainingKD.py:
      * `fit_crd` (--crd, and its loss variants --contrast and --vid):
        per epoch a train sweep of `make_kd_crd_step` against the frozen
        `teacher`, the student's per-category evaluation on
        `eval_loader`, the checkpoints (the student's whole train state:
        its "model" entry is the reference-layout state_dict the testing
        CLI's `--model` loads), one log line and one metrics record with
        the sustained train samples/s;
      * `fit_stage2` (--stage 2): the same loop through `make_stage2_step`
        against the frozen vanilla `teacher` of stage 1;
      * `fit_stage1` (--stage 1): the vanilla teacher (`teacher_state`) and
        the student trained together by `make_stage1_step`, optionally
        with the memory bank; per epoch the teacher's per-category
        evaluation, a checkpoint of both train states (and of the bank),
        the log line and the metrics record.
    With `int8_teacher` (--int8_teacher, --crd's regimes and --stage 2) the
    steps run the frozen teacher's conv trunks int8, and `teacher` is
    {"model": the teacher, "q8": its quantized tree}. `shape_bank` (every
    regime), `device_augment` (--crd's) and `device_views` (--crd's and
    --stage 2) are the steps' options."""

    def __init__(self, state: TrainState, teacher, train_loader, eval_loader,
                 category_names: list[str], result_path: str, bin_size: int = 15,
                 temperature: float = 1.0, teacher_state: TrainState | None = None,
                 tau: float = 0.5, use_fused_nce: bool = False, nce_variant: str = "info",
                 nce_weighting: str = "linear", int8_teacher: bool = False,
                 device_augment: bool = False, device_views: bool = False, shape_bank=None,
                 profile_dir: str | None = None):
        self.state = state
        self.device_augment, self.device_views = device_augment, device_views
        self.shape_bank = shape_bank
        self.teacher = teacher
        self.teacher_state = teacher_state
        self.int8_teacher = int8_teacher
        self.bin_size, self.temperature, self.tau = bin_size, temperature, tau
        self.use_fused_nce = use_fused_nce
        self.nce_variant, self.nce_weighting = nce_variant, nce_weighting
        self.device = next(state.model.parameters()).device
        self.profiler = StepProfiler(profile_dir, "kd", self.device)
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.category_names = category_names
        self.result_path = result_path
        os.makedirs(result_path, exist_ok=True)
        self.log = TxtLogger(os.path.join(result_path, "training_log.txt"))
        self.metrics = MetricsWriter(os.path.join(result_path, "metrics.jsonl"))
        self.ckpt = Checkpointer(os.path.join(result_path, "ckpt"))
        self.eval_step = steps_lib.make_eval_step(state.model, "student", bin_size)

    def _view_keys(self) -> tuple[str, ...]:
        """A three-view batch's keys: the views (or the one raw view and its
        'rot_sign' with `device_views`), their labels and the shape keys."""
        shape_keys = shape_batch_keys(self.shape_bank)
        if self.device_views:
            return ("im", *shape_keys, "label", "label_flip", "label_rot", "rot_sign")
        return ("im", *shape_keys, "label", "im_flip", "label_flip", "im_rot", "label_rot")

    def fit_crd(self, epochs: int, start_epoch: int = 0, loss_variant: str = "crd") -> float:
        """JAX's fit_crd with its `_student_loop`; `loss_variant` "crd",
        "contrast" or "vid" (`make_kd_crd_step`), also the metrics' kind."""
        step = steps_lib.make_kd_crd_step(self.bin_size, self.temperature, loss_variant,
                                          self.int8_teacher, device_augment=self.device_augment,
                                          device_views=self.device_views,
                                          shape_bank=self.shape_bank)
        return self._fit(loss_variant, epochs, start_epoch, self._view_keys(),
                         lambda db: step(self.state, self.teacher, db), self.eval_step,
                         self.state.state_dict)

    def fit_stage2(self, epochs: int, start_epoch: int = 0) -> float:
        """JAX's fit_stage2: `fit_crd`'s loop through `make_stage2_step`."""
        step = steps_lib.make_stage2_step(self.bin_size, self.temperature, self.int8_teacher,
                                          device_views=self.device_views,
                                          shape_bank=self.shape_bank)
        return self._fit("stage2", epochs, start_epoch, self._view_keys(),
                         lambda db: step(self.state, self.teacher, db), self.eval_step,
                         self.state.state_dict)

    def fit_stage1(self, epochs: int, start_epoch: int = 0, use_memory_bank: bool = False,
                   memory_bank_size: int = 4096) -> float:
        """JAX's fit_stage1. From start_epoch > 0 both train states are
        restored from `checkpoint.pth` first, and with `use_memory_bank`
        the bank too (its queue, ptr and filled ride in the checkpoint); a
        checkpoint without one restarts the queue empty, with a warning in
        the log, as JAX's."""
        if self.teacher_state is None:
            raise ValueError("stage 1 trains the teacher too: pass teacher_state")
        bank = (init_memory_bank(memory_bank_size, 200, self.device)
                if use_memory_bank else None)
        if start_epoch > 0 and self.ckpt.exists("checkpoint"):
            restored = self.ckpt.restore("checkpoint")
            self.teacher_state.load_state_dict(restored["teacher"])
            self.state.load_state_dict(restored["student"])
            if use_memory_bank and "bank" in restored:
                bank = MemoryBank(*(restored["bank"][k].to(self.device)
                                    for k in MemoryBank._fields))
            elif use_memory_bank:
                self.log.line("WARNING: resuming stage 1 without a saved memory bank — "
                              "the negative queue restarts cold\n")
        step = steps_lib.make_stage1_step(self.bin_size, self.tau,
                                          use_fused_nce=self.use_fused_nce,
                                          use_memory_bank=use_memory_bank,
                                          nce_variant=self.nce_variant,
                                          nce_weighting=self.nce_weighting,
                                          shape_bank=self.shape_bank)

        def run_step(db):
            nonlocal bank
            if not use_memory_bank:
                return step(self.teacher_state, self.state, db)
            metrics, bank = step(self.teacher_state, self.state, db, bank=bank)
            return metrics

        def checkpoint():
            tree = {"teacher": self.teacher_state.state_dict(),
                    "student": self.state.state_dict()}
            if use_memory_bank:
                tree["bank"] = bank._asdict()
            return tree

        eval_step = steps_lib.make_eval_step(self.teacher_state.model, "vanilla",
                                             self.bin_size)
        return self._fit("stage1", epochs, start_epoch,
                         ("im", *shape_batch_keys(self.shape_bank), "label"), run_step,
                         eval_step, checkpoint)

    def _fit(self, kind: str, epochs: int, start_epoch: int, keys, run_step, eval_step,
             checkpoint) -> float:
        """The regimes' epoch loop: a train sweep of `run_step` over the
        device batches of `keys`, the per-category evaluation by
        `eval_step`, the save of `checkpoint()`, one log line and one
        metrics record with the sustained train samples/s."""
        best_acc = self.ckpt.best_acc() if start_epoch > 0 else 0.0
        self.profiler.name = kind
        for epoch in range(start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            loss_m, acc_m = AverageValueMeter(), AverageValueMeter()
            meters = DeferredMeters(loss_m, acc_m)
            t0 = time.time()
            try:  # the trace ends however the loop does
                for i, (db, valid) in enumerate(Prefetcher(self.train_loader, keys, self.device)):
                    with self.profiler.step(i):
                        meters.push(run_step(db), int(valid.sum()))
            finally:
                self.profiler.stop()
            # the flush waits for the last step, so train_seconds holds the
            # device's time: the sustained samples/s is train_samples over it
            meters.flush()
            train_seconds = time.time() - t0

            names = getattr(getattr(self.eval_loader, "dataset", None), "category_names",
                            self.category_names)
            result = evaluate_categories(eval_step, self.eval_loader, names, self.device)
            is_best = result.mean_acc > best_acc
            best_acc = max(best_acc, result.mean_acc)
            self.ckpt.save_epoch(epoch, checkpoint(), best_acc, is_best=is_best)

            self.log.line(
                "Student Epoch: %03d || train_loss %.2f || train_acc %.2f -- "
                "val_acc %.2f -- val_med %.2f \n" %
                (epoch + 1, loss_m.avg, acc_m.avg, result.mean_acc, result.mean_med))
            self.metrics.write({"kind": f"{kind}_epoch", "epoch": epoch,
                                "train_loss": loss_m.avg, "train_acc": acc_m.avg,
                                "val_acc": result.mean_acc, "val_med": result.mean_med,
                                "epoch_seconds": time.time() - t0,
                                "train_seconds": train_seconds,
                                "train_samples": loss_m.count,
                                "train_samples_per_s": loss_m.count / max(train_seconds, 1e-9)})
        return best_acc
