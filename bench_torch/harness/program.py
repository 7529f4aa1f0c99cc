"""The system under test, built from a configuration file: the port's
model (``models.registry.build_model``) with the seeded weights, and
around it the entries the traffic drives -- the serving callable of
``cli.make_forward`` and the train step of ``train.step`` with the Trainer's loss and
optimizer rules (``train.loop.loss_for`` / ``optimizer_for``).

The seeded weights take the place of ``cli._restore_model``'s checkpoint
or initial draw; the forward wrapped is the one ``cli._make_forward``
builds (``model(x).float()`` without gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def model_config(cfg: dict):
    from ultrasound_modeling_tpu_torch.config import ModelConfig
    return ModelConfig(**_tuples(cfg["model"]))


def train_config(cfg: dict):
    from ultrasound_modeling_tpu_torch.config import TrainConfig
    return TrainConfig(**_tuples(cfg["train"]))


def build_model(cfg: dict, weights, device: torch.device) -> torch.nn.Module:
    """The family's model on ``device`` with ``weights``, TF32 off as the
    program's entry points set it."""
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.models.registry import build_model as bm

    full_f32_matmuls()
    model = bm(model_config(cfg)).to(device)
    model.load_state_dict(weights, strict=True)
    return model


def serving_forward(model: torch.nn.Module, device: torch.device
                    ) -> Callable:
    """``cli.make_forward`` over the eval model: float32 numpy frames in,
    float32 numpy probabilities out, the copies to and from the card
    inside."""
    from ultrasound_modeling_tpu_torch import cli

    model.eval()

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return model(x).float()

    return cli.make_forward(forward, device)


@dataclasses.dataclass
class Trainer:
    """The train step's objects, as ``train.loop.Trainer`` wires them."""
    model: torch.nn.Module
    state: object
    step: Callable
    schedule: Callable[[int], float]
    dataset: object
    iteration: int = 0

    def run_step(self, batch: int):
        """One pass of ``Trainer.train_epoch``'s loop body, without its
        logging: the next batch of the cursor, the step at the current
        learning rate.  Returns the loss (on the device)."""
        x, y, _ = self.dataset.next_train(batch)
        loss, _ = self.step(self.state, x, y, self.schedule(self.iteration))
        self.iteration += 1
        return loss


def trainer(cfg: dict, weights, data: Tuple[torch.Tensor, torch.Tensor],
            gens: Tuple[torch.Generator, torch.Generator],
            device: torch.device) -> Trainer:
    from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
    from ultrasound_modeling_tpu_torch.train import optim
    from ultrasound_modeling_tpu_torch.train.loop import loss_for, optimizer_for
    from ultrasound_modeling_tpu_torch.train.step import (
        TrainState, make_train_step)

    mcfg, tcfg = model_config(cfg), train_config(cfg)
    model = build_model(cfg, weights, device).train()
    state = TrainState(model, optimizer_for(mcfg.name, tcfg)(model), 0, *gens)
    step = make_train_step(model, loss_for(tcfg), num_classes=mcfg.num_classes,
                           augment=cfg["data"]["augment"],
                           flip=cfg["data"]["aug_flip"],
                           l2_scale=tcfg.l2_regularization)
    x, y = (t.cpu() for t in data)
    dataset = Dataset(x, y, x[:1], y[:1], mcfg.num_classes, device)
    schedule = optim.piecewise_constant(tcfg.learning_rate, tcfg.lr_boundaries,
                                        tcfg.lr_values)
    return Trainer(model, state, step, schedule, dataset)
