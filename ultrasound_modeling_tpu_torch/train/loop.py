"""Trainer (PyTorch port of ``train/loop.py``), with the reference
drivers' semantics:

* an epoch walks the dataset cursor to its terminator
  (``MainNumpy.py:41-66``);
* eval every ``eval_every_epochs`` epochs;
* the piecewise-constant learning rate times the plateau scale, which the
  F1 plateau decay divides by 5 (``TBI_ResNest.py:391,407-412``);
* training stops once the learning rate falls below ``lr_floor``;
* a loss equal to the previous epoch's is flagged ``loss_stagnant``
  (``MainNumpy.py:76-79``);
* scalars go through ``utils/logging.MetricLogger``, the port's copy of
  the JAX package's;
* with a ``utils.checkpoint.Checkpointer``, a save after every epoch that
  crosses a multiple of ``checkpoint_every_steps`` and one at the end of
  ``fit`` (the JAX condition, at epoch grain); :meth:`Trainer.restore`
  takes the run up where it stopped.  The checkpoint also holds the
  plateau scale and the last evaluation's F1, which the JAX one does not
  (a JAX resume restarts the plateau rule): here N/2 + N/2 epochs with a
  restore between them equal N.

The JAX Trainer's per-loss and per-family rules (``loss_for``,
``optimizer_for``): the smoothing reaches ``cce_smooth`` as
``label_smoothing=`` and ``factor_scaled`` as ``smoothing=``, only when it
differs from 0.1; ``class_factor`` overrides the factor family's
constants; ``class_balanced`` trains without clipping; the MobileUNet
trains with the dual-rate Adam.  The loss adds the L2 kernel penalty where
the config sets one (the ViT).

Left out (ROADMAP Queue 1): decoupled weight decay and the bf16 Adam first
moment (a config asking for either raises), meshes (data, tensor and
pipeline parallel), ``scan_epochs``, out-of-core datasets, image panels.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, Optional

import torch

from ultrasound_modeling_tpu_torch.config import Config, TrainConfig
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from ultrasound_modeling_tpu_torch.models.registry import build_model
from ultrasound_modeling_tpu_torch.train import losses, metrics, optim
from ultrasound_modeling_tpu_torch.train import step as step_mod
from ultrasound_modeling_tpu_torch.utils.checkpoint import Checkpointer
from ultrasound_modeling_tpu_torch.utils.logging import MetricLogger


def loss_for(tc: TrainConfig) -> Callable:
    """``tc.loss`` with the configured smoothing (only where it is not the
    losses' own 0.1, under each loss's keyword) and class factors (the
    factor family's)."""
    fn = losses.get_loss(tc.loss)
    kw = {}
    if tc.label_smoothing != 0.1 and tc.loss in ("cce_smooth",
                                                 "factor_scaled"):
        key = "label_smoothing" if tc.loss == "cce_smooth" else "smoothing"
        kw[key] = tc.label_smoothing
    if tc.class_factor is not None and tc.loss in ("factor_scaled",
                                                   "pixelcnn", "evaluator"):
        kw["class_factor"] = tuple(tc.class_factor)
    return functools.partial(fn, **kw) if kw else fn


def optimizer_for(model_name: str, tc: TrainConfig
                  ) -> Callable[[torch.nn.Module], optim.Adam]:
    """The optimizer over a model's parameters: the dual-rate Adam (b1 0.5,
    no clipping) for the MobileUNet; else Adam clipped at
    ``tc.clip_global_norm``, unclipped under ``class_balanced`` (the
    standalone ResNeSt U-Net's)."""
    if model_name == "mobileunet":
        return optim.dual_rate_adam
    clip = tc.clip_global_norm if tc.loss != "class_balanced" else None
    return lambda model: optim.Adam(model.parameters(), clip_norm=clip)


class Trainer:
    def __init__(self, cfg: Config, dataset: Dataset, device=DEFAULT_DEVICE,
                 logger: Optional[MetricLogger] = None,
                 checkpointer: Optional[Checkpointer] = None):
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        tc = cfg.train
        if tc.weight_decay or tc.adam_mu_dtype is not None:
            raise NotImplementedError(
                f"weight_decay={tc.weight_decay} / adam_mu_dtype="
                f"{tc.adam_mu_dtype!r} are not ported yet (every family "
                f"trains with 0 / None by default): ROADMAP Queue 1 item 3, "
                f"'Config knobs the port refuses'")
        self.model = build_model(cfg.model)
        self.logger = logger or MetricLogger()
        self.loss_fn = loss_for(tc)
        self.state = step_mod.TrainState.create(
            self.model, tc.seed, self.device,
            optimizer_for(cfg.model.name, tc))
        self.schedule = optim.piecewise_constant(
            tc.learning_rate, tc.lr_boundaries, tc.lr_values)
        self.plateau_scale = 1.0
        self.f1_prev = 0.0          # the last evaluation's F1
        self.checkpointer = checkpointer
        self.train_step = step_mod.make_train_step(
            self.model, self.loss_fn, num_classes=cfg.model.num_classes,
            augment=cfg.data.augment, flip=cfg.data.aug_flip,
            l2_scale=tc.l2_regularization)
        self.eval_step = step_mod.make_eval_step(
            self.model, self.loss_fn, num_classes=cfg.model.num_classes)
        self.iteration = 0
        self.last_epoch: Dict[str, float] = {}

    def checkpoint_state(self) -> Dict[str, Any]:
        """What a checkpoint holds: the model (params and BatchNorm
        statistics), the optimizer's moments and count, the step, both
        generators' states, the plateau scale and the last F1."""
        st = self.state
        return {"model": st.model.state_dict(), "opt": st.opt.state_dict(),
                "step": st.step, "gen": st.gen.get_state(),
                "drop_gen": (None if st.drop_gen is None
                             else st.drop_gen.get_state()),
                "plateau_scale": self.plateau_scale, "f1_prev": self.f1_prev}

    def save(self) -> None:
        self.checkpointer.save(self.checkpoint_state(), self.iteration)

    def restore(self, checkpointer: Checkpointer,
                step: Optional[int] = None) -> None:
        """Take up a run from ``checkpointer``'s checkpoint (the latest by
        default): the state, the iteration, the plateau scale and F1."""
        ck = checkpointer.restore(self.checkpoint_state(), step)
        st = self.state
        st.model.load_state_dict(ck["model"], strict=True)
        st.opt.load_state_dict(ck["opt"])
        st.gen.set_state(ck["gen"])
        if st.drop_gen is not None:
            st.drop_gen.set_state(ck["drop_gen"])
        st.step = self.iteration = ck["step"]
        self.plateau_scale, self.f1_prev = ck["plateau_scale"], ck["f1_prev"]

    def current_lr(self) -> float:
        return self.schedule(self.iteration) * self.plateau_scale

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        tc = self.cfg.train
        t0 = time.perf_counter()
        n_iters = 0
        while True:
            x, y, terminator = self.dataset.next_train(tc.batch_size)
            loss, _ = self.train_step(self.state, x, y, self.current_lr())
            self.iteration += 1
            n_iters += 1
            if self.iteration % tc.log_every == 0:
                self.logger.scalars(self.iteration, {
                    "train_loss": float(loss), "lr": self.current_lr()})
            if terminator:
                break
        last_loss = float(loss)  # waits for the device
        fps = n_iters * tc.batch_size / max(time.perf_counter() - t0, 1e-9)
        self.logger.scalars(self.iteration, {
            "epoch": epoch, "epoch_loss": last_loss, "frames_per_sec": fps})
        self.last_epoch = {"loss": last_loss, "frames_per_sec": fps,
                           "iters": n_iters}
        return self.last_epoch

    def evaluate(self, epoch: int, batch_size: Optional[int] = None
                 ) -> Dict[str, float]:
        bs = batch_size or min(16, self.dataset.num_te)
        mstate = metrics.zeros(self.cfg.model.num_classes, self.device)
        while True:
            x, y, terminator = self.dataset.next_test(bs)
            mstate, _, _ = self.eval_step(self.state, mstate, x, y)
            if terminator:
                break
        summary = metrics.summarize(mstate)
        self.logger.scalars(self.iteration,
                            {f"val_{k}": v for k, v in summary.items()})
        return summary

    def fit(self, epochs: Optional[int] = None) -> Dict[str, float]:
        tc = self.cfg.train
        epochs = epochs or tc.epochs
        prev_loss = None
        summary: Dict[str, float] = {}
        for epoch in range(1, epochs + 1):
            if self.current_lr() < tc.lr_floor:
                break
            stats = self.train_epoch(epoch)
            if prev_loss is not None and prev_loss == stats["loss"]:
                self.logger.scalars(self.iteration, {"loss_stagnant": 1.0})
            prev_loss = stats["loss"]
            if epoch % tc.eval_every_epochs == 0:
                summary = self.evaluate(epoch)
                if summary["f1"] < self.f1_prev:
                    self.plateau_scale *= tc.plateau_decay
                self.f1_prev = summary["f1"]
            if (self.checkpointer is not None and self.iteration
                    % tc.checkpoint_every_steps < stats["iters"]):
                self.save()
        if self.checkpointer is not None:
            self.save()
        return summary
