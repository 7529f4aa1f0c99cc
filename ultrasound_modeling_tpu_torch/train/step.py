"""Train and eval steps (PyTorch port of ``train/step.py``).

The JAX package compiles one XLA program per step; here the step runs
eagerly, in the same order: augment -> label2vec -> forward in train mode
(the BatchNorms take batch statistics and update their running statistics
in place as the forward passes them; dropout and drop path draw from the
state's generator) -> loss (+ the L2 kernel penalty) -> backward ->
the optimizer (the Trainer's: global-norm clip or none, Adam or the
dual-rate Adam) -> ``p -= lr * update``.  A CUDA
graph of the step is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ultrasound_modeling_tpu_torch.data import augment as aug_mod
from ultrasound_modeling_tpu_torch.data import labels as labels_mod
from ultrasound_modeling_tpu_torch.models.common import set_dropout_generator
from ultrasound_modeling_tpu_torch.models.swin import set_drop_path_generator
from ultrasound_modeling_tpu_torch.train import losses as losses_mod
from ultrasound_modeling_tpu_torch.train import metrics as metrics_mod
from ultrasound_modeling_tpu_torch.train.optim import Adam
from ultrasound_modeling_tpu_torch.utils.checkpoint import (
    from_flax, random_flax_variables)
from ultrasound_modeling_tpu_torch.utils.tracing import span


@dataclasses.dataclass
class TrainState:
    """The model (params and BatchNorm running statistics), the optimizer
    state, the step count, the augmentation generator and the generator
    the model's stochastic layers draw from in train mode (the Swin's
    ``DropPath``, the U-Nets' ``Dropout``; set on them here)."""

    model: torch.nn.Module
    opt: Adam
    step: int
    gen: torch.Generator
    drop_gen: Optional[torch.Generator] = None

    def __post_init__(self):
        set_drop_path_generator(self.model, self.drop_gen)
        set_dropout_generator(self.model, self.drop_gen)

    @classmethod
    def create(cls, model: torch.nn.Module, seed: int, device,
               optimizer: Callable[[torch.nn.Module], Adam] = (
                   lambda m: Adam(m.parameters()))) -> "TrainState":
        """Seeded initial weights (``random_flax_variables``: He-normal
        kernels, through the weight bridge) on ``device`` and
        ``optimizer(model)`` over them (the Trainer's per-family rule; Adam
        clipped at 1.0 by default); both generators live on the same
        device, so augmentation, stochastic depth and dropout never leave
        it (the second seeded ``seed + 1``, a stream apart from the
        augmentation's)."""
        model.load_state_dict(
            from_flax(random_flax_variables(model, seed), model.family),
            strict=True)
        model.to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        drop_gen = torch.Generator(device=device).manual_seed(seed + 1)
        return cls(model, optimizer(model), 0, gen, drop_gen)


def make_train_step(model: torch.nn.Module, loss_fn: Callable,
                    num_classes: int = 3, augment: bool = True,
                    flip: bool = False, l2_scale: float = 0.0):
    """``(state, x, y_scalar, lr) -> (loss, probs)``, updating ``state`` in
    place; ``y_scalar`` is the raw label image ``[B, H, W]``.  A non-zero
    ``l2_scale`` adds ``losses.l2_regularization`` of the model's kernels
    to the loss (the ViT's 1e-5).  Under a profiler each step is the span
    ``train.step`` (``utils.tracing``) of four: ``train.augment``
    (augmentation and ``label2vec``), ``train.forward`` (the forward, the
    loss and the penalty), ``train.backward`` (``zero_grad`` and
    ``backward``) and ``train.optim`` (the clip and the update)."""
    kernels = losses_mod.l2_kernels(model) if l2_scale else []

    def step_fn(state: TrainState, x: torch.Tensor, y_scalar: torch.Tensor,
                lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("train.step"):
            model.train()
            with span("train.augment"):
                if augment:
                    x, y_scalar = aug_mod.augment_batch(x, y_scalar,
                                                        state.gen, flip)
                y = labels_mod.label2vec(y_scalar, num_classes)
            with span("train.forward"):
                probs = model(x).float()
                loss = loss_fn(y, probs)
                if l2_scale:
                    loss = loss + losses_mod.l2_regularization(kernels,
                                                               l2_scale)
            with span("train.backward"):
                state.opt.zero_grad()
                loss.backward()
            with span("train.optim"):
                state.opt.step(lr)
            state.step += 1
            return loss.detach(), probs.detach()

    return step_fn


def make_eval_step(model: torch.nn.Module, loss_fn: Callable,
                   num_classes: int = 3):
    """``(state, metric_state, x, y_scalar) -> (metric_state, loss, probs)``."""

    @torch.no_grad()
    def step_fn(state: TrainState, mstate, x, y_scalar):
        model.eval()
        y = labels_mod.label2vec(y_scalar, num_classes)
        probs = model(x).float()
        loss = loss_fn(y, probs)
        return metrics_mod.update(mstate, y, probs, loss), loss, probs

    return step_fn


def make_forward(model: torch.nn.Module):
    """Inference forward: ``(state, x) -> probs``."""

    @torch.no_grad()
    def fwd(state: TrainState, x):
        model.eval()
        return model(x).float()

    return fwd
