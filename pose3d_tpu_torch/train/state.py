"""Train state and optimizer. Port of `pose3d_tpu/train/state.py`.

Optimizer parity with the reference recipes, as in JAX:
  * torch.optim.Adam(lr, weight_decay=5e-4): the L2 penalty is added to the
    gradient BEFORE the Adam moments (JAX's `torch_style_adam`: optax
    add_decayed_weights, then scale_by_adam), not decoupled AdamW;
  * MultiStepLR(gamma=0.1) with its milestones counted in OPTIMIZER steps
    (`decrease * steps_per_epoch`) and stepped after every update, as JAX's
    `multistep_lr` (optax piecewise_constant_schedule over the update
    count): update u (from 0) runs at base_lr * 0.1 ** (milestones <= u).

`TrainState` carries what JAX's carries, as PyTorch objects: the model
(parameters and BatchNorm statistics), the optimizer and its schedule, the
step count, and the generator that draws the NCE's dropout masks, on the
model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn


def torch_style_adam(params, lr: float, weight_decay: float = 5e-4) -> torch.optim.Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) with the L2 penalty added to the
    gradient: torch's own Adam."""
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


def multistep_lr(optimizer: torch.optim.Optimizer,
                 milestones_steps: Sequence[int]) -> torch.optim.lr_scheduler.MultiStepLR:
    """The learning rate times 0.1 from each milestone on, in optimizer
    steps; call its step() after every optimizer step."""
    return torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[int(m) for m in milestones_steps], gamma=0.1)


@dataclass
class TrainState:
    """One model's training state."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "generator": self.generator.get_state(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore in place (strict for the model)."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"].cpu())
        self.step = int(state["step"])


def create_train_state(model: nn.Module, lr: float, milestones_steps: Sequence[int],
                       seed: int) -> TrainState:
    """Wrap a model (initialised, on its device) with the recipe's Adam
    (weight decay 5e-4), its step schedule and a dropout generator seeded
    `seed` on the model's device."""
    device = next(model.parameters()).device
    optimizer = torch_style_adam(model.parameters(), lr)
    return TrainState(model=model, optimizer=optimizer,
                      scheduler=multistep_lr(optimizer, milestones_steps),
                      generator=torch.Generator(device=device).manual_seed(seed))
