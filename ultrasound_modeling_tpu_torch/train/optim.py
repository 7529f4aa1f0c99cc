"""Optimizer and learning-rate schedule (PyTorch port of
``train/optim.py``), with optax's semantics:

* ``piecewise_constant``: Keras ``PiecewiseConstantDecay``;
* ``clip_by_global_norm``: optax's — every gradient is scaled by
  ``max_norm / g_norm`` only when ``g_norm > max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and always scales);
* ``Adam``: optax ``scale_by_adam`` (b1 0.9 by default, b2 0.999, eps
  1e-8, eps_root 0, bias correction) giving the update *direction*,
  after an optional global-norm clip; the runtime learning rate is
  applied outside, ``p <- p - lr * u``, as the JAX train step does
  (``train/step.py:114-116``), so the plateau decay can change it between
  steps;
* ``dual_rate_adam``: the MobileUNet's ``make_dual_rate_direction``, two
  Adam groups with b1 0.5 and no clipping, the encoder's direction scaled
  by 0.1 (the runtime lr is the decoder's rate).

Left out: decoupled weight decay, the bf16 first moment.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch


def piecewise_constant(base: float, boundaries: Sequence[int],
                       values: Sequence[float]) -> Callable[[int], float]:
    """``base * values[i]`` for steps in ``(boundaries[i-1], boundaries[i]]``."""
    def schedule(step: int) -> float:
        return base * values[sum(step > b for b in boundaries)]
    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / g_norm`` unless ``g_norm <
    max_norm`` (optax's select, decided on the device: no host sync);
    returns g_norm (float32, on the grads' device)."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(g_norm < max_norm, 1.0,
                                           max_norm / g_norm))
    return g_norm


class Adam:
    """optax ``chain(clip_by_global_norm, scale_by_adam)`` (no clip when
    ``clip_norm`` is None) over a list of float32 parameters, then ``p -=
    lr * update``.  ``scales``, one per parameter, multiply each update
    after Adam (optax's ``scale`` in a ``multi_transform`` group).  State:
    ``mu``, ``nu`` (float32, like the params) and the step ``count``.
    Every stage runs over all parameters at once (``torch._foreach_*``: a
    few launches per step rather than a dozen per parameter)."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 clip_norm: Optional[float] = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 scales: Optional[Sequence[float]] = None):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        # the indices of the parameters of each scale other than 1
        self.scaled: Dict[float, List[int]] = {}
        for i, s in enumerate(scales or ()):
            if s != 1.0:
                self.scaled.setdefault(float(s), []).append(i)

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [p.grad for p in self.params]
        if self.clip_norm is not None:
            clip_by_global_norm(grads, self.clip_norm)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_lerp_(self.mu, grads, 1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        for s, idx in self.scaled.items():
            torch._foreach_mul_([mu_hat[i] for i in idx], s)
        torch._foreach_add_(self.params, mu_hat, alpha=-lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, object]:
        """The optimizer state (optax's ``ScaleByAdamState``): both moments
        and the step count."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a :meth:`state_dict` into this optimizer's moments."""
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            for m, t in zip(mine, theirs, strict=True):
                m.copy_(t)
        self.count = int(state["count"])


def dual_rate_adam(model: torch.nn.Module, encoder_ratio: float = 0.1,
                   b1: float = 0.5, encoder_prefix: str = "encoder") -> Adam:
    """The MobileUNet's dual-rate direction (``make_dual_rate_direction``):
    Adam with ``b1`` and no clipping; the parameters under a top-level
    module whose name starts with ``encoder_prefix`` move at
    ``encoder_ratio`` times the runtime lr (the decoder's rate)."""
    names = [n for n, _ in model.named_parameters()]
    return Adam(model.parameters(), clip_norm=None, b1=b1,
                scales=[encoder_ratio
                        if n.split(".")[0].startswith(encoder_prefix) else 1.0
                        for n in names])
