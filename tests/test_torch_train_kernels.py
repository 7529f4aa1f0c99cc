"""The port's train-path kernels K2 (group_flat_norm) and K3 (flash_mha):
their plain PyTorch versions and the autograd Functions around them, held
against the JAX package's Pallas kernels in interpret mode and ``jax.vjp``
of them (as tests/test_pallas.py:111-215 and :479-end run them).  On CPU
tensors the wrappers run their plain versions; the CUDA kernels themselves
are checked in tests/test_torch_cuda.py and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.ops import pallas_kernels as pk
from ultrasound_modeling_tpu_torch.ops import kernels as K

BF = torch.bfloat16
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (BF, jnp.bfloat16)}


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return np.asarray(t.detach().float().numpy())


def _bf16_quanta(want, n):
    """n bf16 quanta (2^-8 relative) of max|want|."""
    return n * float(np.abs(want).max()) / 256.0


# ---------------------------------------------------------------------------
# K2: group_flat_norm
# ---------------------------------------------------------------------------

# (rows, F) by group size: the flagship's eight branch widths (F = 9 gsize).
# 3, 10 and 85 run beyond one Pallas row tile (2048 rows for F <= 128, 512
# for F > 384) and not a multiple of it, so the JAX kernel's tail masking is
# exercised; the other five at small row counts, one tile
GFN_SHAPES = {3: (2100, 27), 10: (2100, 90), 85: (600, 765), 7: (300, 63),
              14: (200, 126), 21: (150, 189), 28: (100, 252), 42: (70, 378)}


def _gfn_inputs(gsize, act, seed=0):
    """y, scale, bias, output cotangent (numpy float32).  With the folded
    LeakyReLU the biases are +-(|scale| * sqrt(gsize - 1) + 1) by channel:
    a normalized value never exceeds sqrt(gsize - 1), so no pre-activation
    lies near the kink, where the bf16 rounding of the JAX kernel's variance
    could pick the other (equally right) branch of the derivative."""
    rows, f = GFN_SHAPES[gsize]
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(rows, f)) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.normal(size=(f,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(f,))).astype(np.float32)
    if act:
        sign = np.where(np.arange(f) % 2 == 0, 1.0, -1.0)
        b = (sign * (np.abs(s) * np.sqrt(gsize - 1) + 1)).astype(np.float32)
    g = rng.normal(size=(rows, f)).astype(np.float32)
    return y, s, b, g


@pytest.mark.parametrize("gsize", list(GFN_SHAPES))
@pytest.mark.parametrize("act", [None, "leaky"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k2_plain_and_autograd_match_pallas_interpret(gsize, act, dt):
    """Forward, and the gradients (dy, dscale, dbias) of both the K2
    autograd Function (plain backward on the CPU) and autograd through the
    plain forward, against group_flat_norm(interpret=True) and its jax.vjp.

    Tolerances: f32 outputs and dy within 1e-5 / 1e-4 of max(1, max|want|),
    dscale / dbias within 1e-4 relative (float32 sums in another order).
    bf16: the JAX kernel rounds the squared deviations and the gradient
    terms to bf16 before its MXU group sums, the port sums in float32, so
    outputs are held to 2 bf16 quanta of max|want|, dy to 4, and the
    float32 dscale / dbias to 4e-3 relative."""
    tdt, jdt = DTYPES[dt]
    y, s, b, g = _gfn_inputs(gsize, act)
    yj, gj = jnp.asarray(y, jdt), jnp.asarray(g, jdt)

    def jfn(yy, ss, bb):
        return pk.group_flat_norm(yy, ss, bb, gsize, 1e-3, interpret=True,
                                  act=act, act_alpha=0.3)

    want, vjp = jax.vjp(jfn, yj, jnp.asarray(s), jnp.asarray(b))
    want = np.asarray(want, np.float32)
    wdy, wds, wdb = (np.asarray(a, np.float32) for a in vjp(gj))

    yt = _to_torch(yj.astype(jnp.float32), tdt).requires_grad_()
    st, bt = _to_torch(s, torch.float32).requires_grad_(), _to_torch(
        b, torch.float32).requires_grad_()
    gt = _to_torch(gj.astype(jnp.float32), tdt)
    f32 = dt == "f32"
    for fn in (K.group_flat_norm, K.group_flat_norm_plain):
        out = fn(yt, st, bt, gsize, 1e-3, act=act, act_alpha=0.3)
        assert out.dtype == tdt and out.shape == yt.shape
        tol = 1e-5 * max(1.0, np.abs(want).max()) if f32 else _bf16_quanta(want, 2)
        assert np.abs(_np(out) - want).max() <= tol, fn.__name__
        dy, ds, db = torch.autograd.grad(out, (yt, st, bt), gt)
        tol = 1e-4 * max(1.0, np.abs(wdy).max()) if f32 else _bf16_quanta(wdy, 4)
        assert np.abs(_np(dy) - wdy).max() <= tol, fn.__name__
        for got, w in ((ds, wds), (db, wdb)):
            rel = 1e-4 if f32 else 4e-3
            assert np.abs(_np(got) - w).max() <= rel * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("gsize", list(GFN_SHAPES))
def test_k2_launch_plan(gsize):
    """The CUDA kernels' tile plan (ops/kernels.gfn_plan) at the flagship's
    batch-32 row counts and at this file's: every tile a whole multiple of
    16 bytes, no bigger than its target unless one 16-byte step of rows is,
    at most max_blocks blocks, and every block walking the same number of
    tiles give or take one (the backward's column sums depend on nothing
    else)."""
    _, f = GFN_SHAPES[gsize]
    stage_rows = {27: 163840, 90: 163840, 63: 40960, 189: 40960,
                  126: 10240, 378: 10240, 252: 2560, 765: 2560}
    for rows in (stage_rows[f], GFN_SHAPES[gsize][0], 1, 37):
        for elem in (4, 2):
            step = 16 // np.gcd(f * elem, 16)
            for direction, target in K.GFN_TILE_BYTES.items():
                r, grid = K.gfn_plan(rows, f, elem, direction, 264)
                tiles = -(-rows // r)
                assert r % step == 0 and r * f * elem % 16 == 0
                assert r * f * elem <= max(target, step * f * elem)
                assert grid == min(tiles, 264)
                assert -(-tiles // grid) - tiles // grid <= 1


def test_k2_explicit_backward_matches_autograd_of_forward(rng):
    """group_flat_norm_bwd_plain (the backward kernel's contract) equals
    autograd through group_flat_norm_fwd_plain, with and without the folded
    LeakyReLU, 4-D input (the model's [B, H, W, F] layout)."""
    y = torch.from_numpy(rng.normal(size=(2, 5, 7, 63)).astype(np.float32))
    s = torch.from_numpy((1 + 0.1 * rng.normal(size=(63,))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=(63,))).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(70, 63)).astype(np.float32))
    for alpha in (None, 0.3):
        yy = y.reshape(70, 63).clone().requires_grad_()
        ss, bb = s.clone().requires_grad_(), b.clone().requires_grad_()
        out = K.group_flat_norm_fwd_plain(yy, ss, bb, 7, 1e-3, alpha)
        want = torch.autograd.grad(out, (yy, ss, bb), g)
        got = K.group_flat_norm_bwd_plain(y.reshape(70, 63), g, s, b, 7, 1e-3,
                                          alpha)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


def test_k2_guards_and_layout_copies():
    """F % gsize, an unknown activation and a wrong scale shape raise; a
    non-contiguous input is copied once and counted."""
    y = torch.zeros(8, 30)
    s, b = torch.ones(30), torch.zeros(30)
    with pytest.raises(ValueError):
        K.group_flat_norm(y, s, b, 7, 1e-3)
    with pytest.raises(ValueError):
        K.group_flat_norm(y, s, b, 10, 1e-3, act="gelu")
    with pytest.raises(ValueError):
        K.group_flat_norm_fwd(y, torch.ones(10), b, 10, 1e-3)
    K.reset_launch_counts()
    out = K.group_flat_norm(torch.randn(30, 8).t(), s, b, 10, 1e-3)
    assert out.shape == (8, 30)
    assert K.LAYOUT_COPIES["group_flat_norm"] == 1
    assert all(v == 0 for v in K.LAUNCHES.values())


# ---------------------------------------------------------------------------
# K3: flash_mha
# ---------------------------------------------------------------------------

B, N, C, HEADS, SCALE = 3, 20, 48, 4, 0.5


def _flash_inputs(seed=1):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, N, 3 * C)).astype(np.float32)
    qkv[..., :2 * C] *= 0.5
    g = rng.normal(size=(B, N, C)).astype(np.float32)
    return qkv, g


def _jax_lse(qkv):
    """The Pallas forward's LSE, [G, heads, t*N] -> [B, heads, N]."""
    t = pk._pick_seqs_per_step(B, N, None)
    static = (HEADS, SCALE, t * N, C, t, N, True)
    _, lse = pk._flash_fwd_pallas(static, qkv.reshape(B * N, 3 * C))
    lse = np.asarray(lse).reshape(B // t, HEADS, t, N)
    return np.ascontiguousarray(
        lse.transpose(0, 2, 1, 3).reshape(B, HEADS, N))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_k3_plain_and_autograd_match_pallas_interpret(dt):
    """Context, LSE and dqkv of the plain forward / backward, of the K3
    autograd Function (plain on the CPU) and of autograd through the plain
    forward, against flash_mha(interpret=True), its LSE and jax.vjp.

    Tolerances: f32 within 1e-5 of max(1, max|want|) (LSE and context) and
    1e-4 (dqkv); bf16 context and dqkv within 2 bf16 quanta of max|want|
    (the same casts, float32 sums in another order; the JAX kernel packs
    three sequences into one tile behind a -1e9 mask, which adds exact
    zeros), LSE within 1e-5."""
    tdt, jdt = DTYPES[dt]
    qkv, g = _flash_inputs()
    qj, gj = jnp.asarray(qkv, jdt), jnp.asarray(g, jdt)
    want, vjp = jax.vjp(
        lambda a: pk.flash_mha(a, HEADS, scale=SCALE, interpret=True), qj)
    want = np.asarray(want, np.float32)
    (wdq,) = vjp(gj)
    wdq = np.asarray(wdq, np.float32)
    wlse = _jax_lse(qj)

    f32 = dt == "f32"
    tol_ctx = 1e-5 * max(1.0, np.abs(want).max()) if f32 else _bf16_quanta(want, 2)
    tol_dq = 1e-4 * max(1.0, np.abs(wdq).max()) if f32 else _bf16_quanta(wdq, 2)
    qt = _to_torch(qj.astype(jnp.float32), tdt)
    gt = _to_torch(gj.astype(jnp.float32), tdt)

    ctx, lse = K.flash_attention_fwd(qt.reshape(B * N, 3 * C), N, HEADS, SCALE)
    assert ctx.dtype == tdt and lse.dtype == torch.float32
    assert np.abs(_np(ctx).reshape(want.shape) - want).max() <= tol_ctx
    assert np.abs(_np(lse) - wlse).max() <= 1e-5 * max(1.0, np.abs(wlse).max())
    dq = K.flash_attention_bwd(qt.reshape(B * N, 3 * C),
                               torch.from_numpy(wlse), gt.reshape(B * N, C),
                               N, HEADS, SCALE)
    assert np.abs(_np(dq).reshape(wdq.shape) - wdq).max() <= tol_dq

    for fn in (K.flash_mha, K.flash_mha_plain):
        q = qt.clone().requires_grad_()
        out = fn(q, HEADS, SCALE)
        assert out.dtype == tdt and out.shape == (B, N, C)
        assert np.abs(_np(out) - want).max() <= tol_ctx, fn.__name__
        (dq,) = torch.autograd.grad(out, q, gt)
        assert np.abs(_np(dq) - wdq).max() <= tol_dq, fn.__name__


def test_k3_matches_composed_mha():
    """flash_mha equals the composed attention (ops.attention.mha) on the
    same projections, forward and gradient (test_pallas.py:479-515)."""
    from ultrasound_modeling_tpu_torch.ops.attention import mha

    qkv, g = _flash_inputs(2)
    qa = torch.from_numpy(qkv).requires_grad_()
    qb = torch.from_numpy(qkv).requires_grad_()
    a = K.flash_mha(qa, HEADS, SCALE)
    b = mha(qb[..., :C], qb[..., C:2 * C], qb[..., 2 * C:], HEADS, SCALE)
    torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6)
    gt = torch.from_numpy(g)
    torch.testing.assert_close(torch.autograd.grad(a, qa, gt)[0],
                               torch.autograd.grad(b, qb, gt)[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["heads", "seq", "head_dim", "dtype", "lse",
                                 "rows", "noncontig"])
def test_k3_guards(bad):
    """Raise on C % heads, seq > 160, head dim > 160, a non-float dtype,
    an LSE of the wrong shape (the guards ADVICE.md:4 asks flash_mha for),
    rows that are not whole sequences and a non-contiguous qkv."""
    qkv, heads, seq = torch.zeros(40, 48), 4, 10
    if bad == "heads":
        heads = 5
    elif bad == "seq":
        qkv, seq = torch.zeros(161 * 2, 48), 161
    elif bad == "head_dim":
        qkv, heads = torch.zeros(10, 3 * 322), 2
    elif bad == "dtype":
        qkv = qkv.to(torch.float16)
    elif bad == "rows":
        qkv = torch.zeros(45, 48)
    elif bad == "noncontig":
        qkv = torch.zeros(48, 40).t()
    with pytest.raises((ValueError, TypeError)):
        if bad == "lse":
            K.flash_attention_bwd(qkv, torch.zeros(4, 4, 9), torch.zeros(40, 16),
                                  seq, heads, 0.5)
        else:
            K.flash_attention_fwd(qkv, seq, heads, 0.5)
