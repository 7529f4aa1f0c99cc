"""The work of the port's kernels, computed from shapes, and the card's
published peaks.

The product counters are those of ``chip_smoke.py`` (``mm``, ``attn``,
``block_ops``, ``window_ops``, ``window_bwd_ops``), with one change: a
product is held to the published tensor-core peak of its operand type
(989 TFLOP/s bf16; 495 TFLOP/s TF32 for a float32 product, the highest
rate any implementation of an f32 product reaches), not to a peak derived
from one recipe, so that no recipe can read above 100%.

A kernel's bound is the larger of its products' time at their peaks and
its bytes (each input read once, each output written once) at the HBM
rate; its roofline share is that bound over the device time its kernels
took.  Peaks are NVIDIA's H100 SXM data sheet (dense, 700 W).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12

Work = Tuple[float, float]           # (operations, peak FLOP/s)


def mm(m, n, k, peak) -> Work:
    """An [m, k] x [k, n] product."""
    return (2.0 * m * n * k, peak)


def attn(b, h, s, d, peak=PEAK_TF32, products=2) -> List[Work]:
    """Per-(sequence, head) attention products: the scores and P.V (a
    backward has four more)."""
    one = 2.0 * b * h * s * s * d
    return [(one, peak), ((products - 1) * one, peak)]


def block_ops(b, s, c, heads, mlp) -> List[Work]:
    """K1's products: four bf16 GEMMs and the attention core."""
    m = b * s
    return [mm(m, 3 * c, c, PEAK_BF16), mm(m, c, c, PEAK_BF16),
            mm(m, mlp, c, PEAK_BF16), mm(m, c, mlp, PEAK_BF16),
            *attn(b, heads, s, c // heads, PEAK_BF16)]


def block_bytes(b, s, c, mlp, final_ln: bool) -> float:
    """K1: x and the output bf16, the matrices bf16, LN and biases f32."""
    mats = (3 * c * c + c * c + 2 * c * mlp) * 2
    vecs = (4 * c + 3 * c + c + mlp + c + (2 * c if final_ln else 0)) * 4
    return 2.0 * b * s * c * 2 + mats + vecs


def window_ops(nbw, n, c, heads) -> List[Work]:
    """K4's forward products, all float32."""
    return [mm(nbw * n, 3 * c, c, PEAK_TF32), mm(nbw * n, c, c, PEAK_TF32),
            *attn(nbw, heads, n, c // heads)]


def window_bytes(nbw, n, c, heads, n_add, x_bytes=4) -> float:
    """K4's forward: x in, the output out (x's type), qkv and proj weights
    and biases, the additive matrix ``[n_add, heads, N, N]`` f32."""
    return (2.0 * nbw * n * c * x_bytes + (4 * c * c + 4 * c) * 4
            + n_add * heads * n * n * 4)


def window_bwd_ops(nbw, n, c, heads) -> List[Work]:
    """K4's backward products: the recompute (qkv, scores, P.V), then
    d_proj_w, do, dP, dV, dQ, dK, d_qkv_w, dx."""
    m = nbw * n
    return [mm(m, 3 * c, c, PEAK_TF32), mm(m, c, c, PEAK_TF32),
            mm(m, c, c, PEAK_TF32), mm(m, 3 * c, c, PEAK_TF32),
            mm(m, 3 * c, c, PEAK_TF32),
            *attn(nbw, heads, n, c // heads, products=6)]


def window_bwd_bytes(nbw, n, c, heads, n_add, x_bytes=4) -> float:
    """K4's backward: x, g, the weights, qkv_b and the additive matrix in;
    dx, the four weight and bias gradients and d_addmask out."""
    act = nbw * n * c
    weights = (4 * c * c + 3 * c) * 4
    grads = (4 * c * c + 4 * c) * 4
    add = n_add * heads * n * n * 4
    return act * x_bytes * 2 + act * 4 + weights + grads + 2 * add


def bound_s(ops: Iterable[Work], nbytes: float) -> float:
    """The least time the card could take: products at their peaks or the
    bytes at the HBM rate, whichever is longer."""
    return max(sum(o / p for o, p in ops), nbytes / HBM_BYTES_S)
