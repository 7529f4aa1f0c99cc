"""Metrics from accumulated counts (PyTorch port of ``train/metrics.py``).

Keras Precision / Recall on rounded probabilities over all classes and on
the bleed channel alone, an argmax confusion matrix (Dice, IoU, accuracy)
and histogram ROC AUC, accumulated on the device as float32 counts and
summarized once per evaluation.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

AUC_BINS = 200  # histogram resolution (Keras AUC num_thresholds=200)


class MetricState(NamedTuple):
    binary: torch.Tensor      # [4] TP, FP, FN, TN over all classes
    binary_c2: torch.Tensor   # [4] same, bleed channel only
    confusion: torch.Tensor   # [C, C] argmax confusion (rows true, cols pred)
    auc_hist: torch.Tensor    # [2, 2, AUC_BINS] (all | c2, pos | neg)
    loss_sum: torch.Tensor    # scalar
    count: torch.Tensor       # scalar batch count

    def __add__(self, other: "MetricState") -> "MetricState":
        return MetricState(*(a + b for a, b in zip(self, other)))


def zeros(num_classes: int = 3, device="cpu") -> MetricState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return MetricState(z(4), z(4), z(num_classes, num_classes),
                       z(2, 2, AUC_BINS), z(), z())


def _binary_counts(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    t = (torch.round(y_true) > 0.5).reshape(-1)
    p = (torch.round(y_pred) > 0.5).reshape(-1)
    return torch.stack([(t & p).sum(), (~t & p).sum(), (t & ~p).sum(),
                        (~t & ~p).sum()]).float()


def confusion_matrix(y_true: torch.Tensor, probs: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    idx = (y_true.argmax(-1) * num_classes + probs.argmax(-1)).reshape(-1)
    return torch.bincount(idx, minlength=num_classes ** 2).float().reshape(
        num_classes, num_classes)


def _auc_hists(y_true: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    t = (torch.round(y_true) > 0.5).reshape(-1)
    p = torch.clamp(probs.reshape(-1), 0.0, 1.0)
    idx = torch.clamp((p * AUC_BINS).long(), max=AUC_BINS - 1)
    return torch.stack([torch.bincount(idx[t], minlength=AUC_BINS),
                        torch.bincount(idx[~t], minlength=AUC_BINS)]).float()


def update(state: MetricState, y_true: torch.Tensor, probs: torch.Tensor,
           loss: torch.Tensor) -> MetricState:
    c = state.confusion.shape[0]
    return state + MetricState(
        binary=_binary_counts(y_true, probs),
        binary_c2=_binary_counts(y_true[..., -1], probs[..., -1]),
        confusion=confusion_matrix(y_true, probs, c),
        auc_hist=torch.stack([_auc_hists(y_true, probs),
                              _auc_hists(y_true[..., -1], probs[..., -1])]),
        loss_sum=torch.as_tensor(loss, dtype=torch.float32),
        count=torch.ones((), dtype=torch.float32, device=probs.device))


def _roc_auc(hists: torch.Tensor) -> torch.Tensor:
    """Trapezoidal ROC AUC from (pos, neg) prediction histograms."""
    zero = hists.new_zeros(1)
    tp = torch.cat([hists[0].flip(0).cumsum(0).flip(0), zero])
    fp = torch.cat([hists[1].flip(0).cumsum(0).flip(0), zero])
    tpr = tp / torch.clamp(tp[0], min=1.0)
    fpr = fp / torch.clamp(fp[0], min=1.0)
    return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) * 0.5).sum()


def _prf(counts: torch.Tensor) -> Dict[str, torch.Tensor]:
    tp, fp, fn, _ = counts
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(tp + fn, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return {"precision": precision, "recall": recall, "f1": f1}


def summarize(state: MetricState) -> Dict[str, float]:
    """The scalar metric set of an accumulated state, as Python floats."""
    out = {}
    for key, counts in (("", state.binary), ("c2_", state.binary_c2)):
        for name, val in _prf(counts).items():
            out[key + name] = val
    cm = state.confusion
    tp = torch.diagonal(cm)
    support_true, support_pred = cm.sum(1), cm.sum(0)
    union = support_true + support_pred - tp
    iou = tp / torch.clamp(union, min=1.0)
    dice = 2 * tp / torch.clamp(support_true + support_pred, min=1.0)
    # Keras MeanIoU averages over the classes present (nonzero union)
    present = (union > 0).float()
    n_present = torch.clamp(present.sum(), min=1.0)
    out["mean_iou"] = (iou * present).sum() / n_present
    out["mean_dice"] = (dice * present).sum() / n_present
    for c in range(cm.shape[0]):
        out[f"dice_c{c}"] = dice[c]
        out[f"iou_c{c}"] = iou[c]
    out["accuracy"] = tp.sum() / torch.clamp(cm.sum(), min=1.0)
    out["auc"] = _roc_auc(state.auc_hist[0])
    out["c2_auc"] = _roc_auc(state.auc_hist[1])
    out["loss"] = state.loss_sum / torch.clamp(state.count, min=1.0)
    return {k: float(v) for k, v in out.items()}
