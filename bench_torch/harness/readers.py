"""Arithmetic shared by the metric readers under ``metrics/``: each reader
file names its metric and calls one of these on the run's context.  A
reader returns None where its run has nothing for it to read."""

from __future__ import annotations

from typing import Callable, Optional

from . import work


def frames_per_s(ctx, kind: str) -> Optional[float]:
    o = ctx.outcome
    if o.kind != kind or o.window_s <= 0 or o.frames <= 0:
        return None
    return o.frames / o.window_s


def device_frames_per_s(ctx) -> Optional[float]:
    """Frames over the device's busy time in the stretch traced on the
    device alone."""
    o = ctx.outcome
    if o.card_frames <= 0 or o.card_busy_s <= 0:
        return None
    return o.card_frames / o.card_busy_s


def mfu(ctx, kind: str, passes: int) -> Optional[float]:
    """Share (%) of the card's peak that the configuration's products take
    at the window's frame rate: ``passes`` x ``flops_per_frame`` (3 for a
    train step: the forward and twice its products backward)."""
    fps = frames_per_s(ctx, kind)
    if fps is None:
        return None
    peak = (work.PEAK_BF16 if ctx.config["model"]["compute_dtype"] == "bfloat16"
            else work.PEAK_TF32)
    return 100.0 * passes * ctx.config["flops_per_frame"] * fps / peak


def idle_share(ctx, kind: str) -> Optional[float]:
    tr = ctx.trace
    if tr is None or ctx.outcome.kind != kind:
        return None
    return 100.0 * tr.idle_share


def roofline(ctx, op: str, bound: Callable) -> Optional[float]:
    """Share (%) of its roofline that ``op``'s kernels reached: the sum of
    the calls' bounds (``bound(input_shapes, config)`` seconds, None where
    the shapes are not recorded) over the device time of the kernels
    launched under them."""
    tr = ctx.trace
    if tr is None or not tr.calls.get(op):
        return None
    total_bound = total_dev = 0.0
    for call in tr.calls[op]:
        b = bound(call.input_shapes, ctx)
        if b is None:
            return None
        total_bound += b
        total_dev += call.device_s
    return 100.0 * total_bound / total_dev if total_dev > 0 else None

