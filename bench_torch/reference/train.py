"""Plain reference of the train step the original drivers run
(``DataAugs.py:82-102``, ``MainNumpy.py``, ``VisionTransformer.py:235-245``),
under the configuration's own train settings (:func:`train_settings`):

augmentation of each sample (with r, t ~ U{0..100000}: brain erosion by
``t % 7 + 2`` pixels if ``r % 3``, ``r % 3`` rectangle cutouts, a shift of
up to (30, 12) pixels with zero fill if ``t % 2``, N(0, 1) / 5000 noise if
``t % 3``), the soft labels' class map (thresholds 0.95 / 1.05), the
forward in train mode, categorical cross-entropy with the configuration's
label smoothing on probabilities clipped to [1e-7, 1 - 1e-7] summed over
pixels and divided by the batch, plus ``l2_regularization`` times the sum
of squares of the model's ``l2_weights()`` (Keras's kernel regularizer),
backward, a global-norm clip at ``clip_global_norm`` (none at 0 or null)
and Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction), ``p -= lr *
update``.

A setting this step has no plain version of is refused by name
(``NotImplementedError``), never passed over: another loss, class
factors, decoupled weight decay, a bf16 first moment, the flip or no
augmentation, and a model trained by another optimizer
(:data:`OTHER_OPTIMIZERS`, by ``model.name``, the key the program's
optimizer is chosen by).

The augmentation draws its parameters from a ``torch.Generator`` on the
batch's device in the order the program draws them, so that the same seed
gives the same augmented batch on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

MAX_ERODE = 8

# models whose original trains with an optimizer other than this Adam
OTHER_OPTIMIZERS = {"mobileunet": "a dual-rate Adam (b1 0.5, no clip)"}


@dataclasses.dataclass(frozen=True)
class Settings:
    """The train settings the reference step follows."""
    label_smoothing: float
    clip_global_norm: Optional[float]       # None: no clip
    l2_regularization: float


def train_settings(cfg: dict) -> Settings:
    """``cfg``'s train settings, refusing by name each one the reference
    has no plain version of."""
    name = cfg["model"]["name"]
    if name in OTHER_OPTIMIZERS:
        raise NotImplementedError(
            f"model.name = {name!r} trains with {OTHER_OPTIMIZERS[name]}: "
            f"the reference step has no plain version of it")
    tc, data = cfg["train"], cfg.get("data", {})
    refused = {"train.loss": tc["loss"] != "cce_smooth",
               "train.class_factor": tc.get("class_factor") is not None,
               "train.weight_decay": bool(tc.get("weight_decay", 0.0)),
               "train.adam_mu_dtype": tc.get("adam_mu_dtype") is not None,
               "data.aug_flip": bool(data.get("aug_flip", False)),
               "data.augment": not data.get("augment", True)}
    for key, bad in refused.items():
        if bad:
            section, name = key.split(".")
            value = (tc if section == "train" else data)[name]
            raise NotImplementedError(
                f"{key} = {value!r}: the reference step has no plain version "
                f"of it")
    clip = tc["clip_global_norm"]
    return Settings(float(tc["label_smoothing"]),
                    float(clip) if clip else None,
                    float(tc["l2_regularization"]))


def _ps(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape(-1, *([1] * (ndim - 1)))


def augment(images: torch.Tensor, labels: torch.Tensor,
            gen: torch.Generator):
    b, h, w = labels.shape
    dev = labels.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (b,), generator=gen, device=dev)

    def pick(on, new, old):
        return (torch.where(_ps(on, 4), new[0], old[0]),
                torch.where(_ps(on, 3), new[1], old[1]))

    r, t = randint(0, 100001), randint(0, 100001)
    img, lab = images, labels
    # erosion: grow the outside (label < 0.1) by 3x3 max-pools
    erode = r % 3 != 0
    iters = torch.where(erode, t % 7 + 2, 0)
    outside = (lab < 0.1).float()[:, None]
    for i in range(MAX_ERODE):
        grown = F.max_pool2d(outside, 3, stride=1, padding=1)
        outside = torch.where(i < _ps(iters, 4), grown, outside)
    e_lab = torch.where(outside[:, 0] < 0.5, lab, 0.0)
    e_img = torch.where((e_lab != 0.0)[..., None], img, 0.0)
    img, lab = pick(erode, (e_img, e_lab), (img, lab))
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    for i in range(2):
        rc, cc, ra, ca = (_ps(v, 3) for v in (
            randint(0, h + 1), randint(0, w + 1), randint(20, 41),
            randint(10, 21)))
        inside = ((rows > rc - ra) & (rows < rc + ra)
                  & (cols > cc - ca) & (cols < cc + ca))
        cut = (torch.where(inside[..., None], 0.0, img),
               torch.where(inside, 0.0, lab))
        img, lab = pick(i < r % 3, cut, (img, lab))
    dr, dc = randint(0, 31), randint(0, 13)
    sign = torch.where(randint(0, 2) == 1, 1, -1)
    sr, sc = sign * dr, sign * dc
    src_r = torch.arange(h, device=dev)[None, :] + sr[:, None]
    src_c = torch.arange(w, device=dev)[None, :] + sc[:, None]
    valid = (((src_r >= 0) & (src_r < h))[:, :, None]
             & ((src_c >= 0) & (src_c < w))[:, None, :])
    bi = torch.arange(b, device=dev)[:, None, None]
    ri = src_r.clamp(0, h - 1)[:, :, None]
    ci = src_c.clamp(0, w - 1)[:, None, :]
    shifted = (torch.where(valid[..., None], img[bi, ri, ci], 0.0),
               torch.where(valid, lab[bi, ri, ci], 0.0))
    img, lab = pick(t % 2 == 1, shifted, (img, lab))
    noise = torch.randn(images.shape, generator=gen, device=dev,
                        dtype=images.dtype)
    img = torch.where(_ps(t % 3 != 0, 4), img + noise / 5000.0, img)
    return img, lab


def class_map(label: torch.Tensor) -> torch.Tensor:
    """Soft labels around {0, 1, 2} -> ``[..., 3]`` class weights."""
    c2 = torch.clamp(torch.where(label >= 1.05, label - 1.0, 0.0), max=1.0)
    c1 = torch.where(label > 0.95, 1.0 - c2, 0.0)
    c0 = torch.where(label <= 0.95, 1.0, 0.0)
    return torch.stack([c0, c1, c2], dim=-1)


def cce_smooth(y: torch.Tensor, probs: torch.Tensor,
               smoothing: float = 0.1) -> torch.Tensor:
    c = y.shape[-1]
    ys = y * (1.0 - smoothing) + smoothing / c
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    return -(ys * torch.log(p)).sum() / y.shape[0]


class Adam:
    """Global-norm clip (none where ``clip`` is None), then Adam with bias
    correction, leaf by leaf."""

    def __init__(self, params: List[torch.Tensor], clip: Optional[float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.clip = params, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """Applies one update; returns the gradients after the clip."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if self.clip is not None and norm >= self.clip:
            grads = [g * (self.clip / norm) for g in grads]
        self.count += 1
        b1, b2, n = self.b1, self.b2, self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).add_(g * g, alpha=1.0 - b2)
            p.sub_(lr * (m / (1.0 - b1 ** n))
                   / (torch.sqrt(v / (1.0 - b2 ** n)) + self.eps))
        return grads


def follow(model: torch.nn.Module, batches, lrs, seed_gens, nx,
           settings: Settings) -> Dict[str, object]:
    """Run the reference step under ``settings`` over ``batches`` (``(x,
    soft labels)``) at learning rates ``lrs`` from ``model``'s current
    weights.  ``seed_gens = (augmentation generator, stochastic-depth
    generator)``; the latter reaches the model only where it has
    ``set_generator``.
    Returns each step's loss, each leaf's gradient norm at the first step
    (after the clip, as Adam receives it) and each leaf's change in norm
    over all the steps, keyed by parameter name."""
    aug_gen, drop_gen = seed_gens
    model.train()
    if hasattr(model, "set_generator"):
        model.set_generator(drop_gen)
    l2 = settings.l2_regularization
    if l2 and not hasattr(model, "l2_weights"):
        raise NotImplementedError(
            f"train.l2_regularization = {l2!r}: {type(model).__name__} names "
            f"no l2_weights()")
    kernels = model.l2_weights() if l2 else []
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = Adam([p.data for p in params], settings.clip_global_norm)
    losses, first_grads = [], None
    with nx.active():
        for (x, y), lr in zip(batches, lrs):
            xa, ya = augment(x, y, aug_gen)
            loss = cce_smooth(class_map(ya), model(xa),
                              settings.label_smoothing)
            if l2:
                loss = loss + l2 * sum((w * w).sum() for w in kernels)
            grads = torch.autograd.grad(loss, params)
            clipped = opt.step(list(grads), lr)
            losses.append(float(loss.detach()))
            if first_grads is None:
                first_grads = {n: float(torch.linalg.vector_norm(g))
                               for n, g in zip(names, clipped)}
    change = {n: float(torch.linalg.vector_norm(p.detach() - s))
              for n, p, s in zip(names, params, start)}
    return {"losses": losses, "grad_norms": first_grads,
            "change_norms": change}
