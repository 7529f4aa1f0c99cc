"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Without a card every test skips; this file imports no JAX, so the
machine with the card runs it on its own:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu_torch.ops import kernels as K
from ultrasound_modeling_tpu_torch.ops.window_attn import (
    additive_matrix, relative_position_index, shifted_window_mask)

BF = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)


# (M, N, K): a TransUNet qkv slice, a ragged one, M and N one below, at and
# one above the 128 x 128 output tile with K off the k-block (64 bf16, 32
# f32), and the Swin projection (K 96, N 288)
LINEAR_SHAPES = [(160, 1536, 512), (77, 72, 40), (127, 129, 72), (128, 128, 64),
                 (129, 127, 136), (160, 288, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", LINEAR_SHAPES)
@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("res_dtype", [None, torch.float32, BF])
def test_linear_matches_plain(cuda, m, n, k, dtype, res_dtype):
    """Every epilogue option of both GEMMs at the tile edges: ragged M, N
    and K exercise TMA's zero fill and the epilogue's scalar tail."""
    g = torch.Generator().manual_seed(0)
    a = _rand(g, cuda, m, k, dtype=dtype)
    w = _rand(g, cuda, n, k, scale=k ** -0.5, dtype=dtype)
    b = _rand(g, cuda, n)
    r = None if res_dtype is None else _rand(g, cuda, m, n, dtype=res_dtype)
    for out_dtype in (torch.float32, BF):
        for bias, gelu in ((b, True), (None, False)):
            got = K.linear(a, w, bias, gelu=gelu, residual=r, out_dtype=out_dtype)
            want = K.linear_plain(a, w, bias, gelu=gelu, residual=r,
                                  out_dtype=out_dtype)
            tol = 1e-4 if out_dtype == torch.float32 else 2 ** -7
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.cuda
def test_linear_f32_holds_the_f32_contract_at_vit_depth(cuda):
    """wa_linear (3xTF32) at the ViT's longest K (fc2's 2048) against a
    float64 product: within 1e-5 of max|out|, where plain TF32 would miss
    by two orders."""
    g = torch.Generator().manual_seed(11)
    a = _rand(g, cuda, 256, 2048)
    w = _rand(g, cuda, 1280, 2048, scale=2048 ** -0.5)
    b = _rand(g, cuda, 1280)
    got = K.linear(a, w, b)
    want = a.double() @ w.double().t() + b.double()
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(5120, 512), (37, 96)])
def test_layer_norm_matches_plain(cuda, rows, c):
    g = torch.Generator().manual_seed(1)
    w, b = 1 + _rand(g, cuda, c, scale=0.1), _rand(g, cuda, c, scale=0.1)
    for in_dtype in (torch.float32, BF):
        x = _rand(g, cuda, rows, c, dtype=in_dtype)
        for out_dtype in (torch.float32, BF):
            got = K.layer_norm(x, w, b, 1e-6, out_dtype)
            want = K.layer_norm_plain(x, w, b, 1e-6, out_dtype)
            tol = 1e-5 if out_dtype == torch.float32 else 2 ** -7
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,c,heads", [(80, 512, 4), (160, 1280, 8), (20, 96, 3)])
def test_attention_core_matches_plain(cuda, seq, c, heads):
    """Both flavors at the TransUNet shape, the ViT limits (S 160, d 160)
    and a Swin window."""
    g = torch.Generator().manual_seed(2)
    qkv = _rand(g, cuda, 8 * seq, 3 * c)
    scale = (c // heads) ** -0.5
    got = K.attention_core(qkv, seq, heads, scale, pv_bf16=True, out_dtype=BF)
    want = K.attention_core_plain(qkv, seq, heads, scale, pv_bf16=True,
                                  out_dtype=BF)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    mask = _rand(g, cuda, 4, heads, seq, seq)
    got = K.attention_core(qkv, seq, heads, scale, addmask=mask)
    want = K.attention_core_plain(qkv, seq, heads, scale, addmask=mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_window_attention_matches_plain_with_bias_and_mask(cuda):
    g = torch.Generator().manual_seed(3)
    c, heads = 96, 3
    args = (_rand(g, cuda, 64, 20, c), _rand(g, cuda, 3 * c, c, scale=0.1),
            _rand(g, cuda, 3 * c, scale=0.1), _rand(g, cuda, c, c, scale=0.1),
            _rand(g, cuda, c, scale=0.1), heads)
    kw = dict(bias_table=_rand(g, cuda, 63, heads, scale=0.1),
              rel_index=torch.from_numpy(relative_position_index((4, 5))).to(cuda),
              mask=torch.from_numpy(shifted_window_mask(8, 20, (4, 5), 2)).to(cuda))
    K.reset_launch_counts()
    got = K.window_attention(*args, **kw)
    assert K.LAUNCHES["window_attention"] == 1
    assert K.LAUNCHES["wa_linear"] == 2 and K.LAUNCHES["wa_attention_core"] == 1
    torch.testing.assert_close(got, K.window_attention_plain(*args, **kw),
                               rtol=1e-4, atol=1e-4)


def _swin_k4_args(g, dev, nbw=128, dtype=torch.float32):
    """K4 at a Swin stage-1 slice: 4x5 windows, C 96, 3 heads, the bias
    table and the shift mask of a 64x20 grid (64 windows)."""
    c, heads = 96, 3
    args = [_rand(g, dev, nbw, 20, c, dtype=dtype),
            _rand(g, dev, 3 * c, c, scale=0.1), _rand(g, dev, 3 * c, scale=0.1),
            _rand(g, dev, c, c, scale=0.1), _rand(g, dev, c, scale=0.1),
            _rand(g, dev, 63, heads, scale=0.1)]
    rel = torch.from_numpy(relative_position_index((4, 5))).to(dev)
    mask = torch.from_numpy(shifted_window_mask(64, 20, (4, 5), 2)).to(dev)
    return args, heads, rel, mask


@pytest.mark.cuda
def test_window_attention_bf16_input_matches_plain(cuda):
    """A bf16 x with f32 weights: the kernel returns bf16 within 1 bf16
    quantum of max|plain|."""
    args, heads, rel, mask = _swin_k4_args(torch.Generator().manual_seed(4),
                                           cuda, dtype=BF)
    kw = dict(bias_table=args[5], rel_index=rel, mask=mask)
    got = K.window_attention(*args[:5], heads, **kw)
    want = K.window_attention_plain(*args[:5], heads, **kw)
    assert got.dtype == want.dtype == BF
    err = (got.float() - want.float()).abs().max().item()
    assert err <= want.float().abs().max().item() / 256


# the Swin's four stages at full width: (grid, window, C, heads, shifted);
# nW windows of a frame, and nBW = nW x an odd count of frames, so that the
# backward kernel's last slice of windows is a short one
SWIN_STAGES = {"stage1": ((64, 20), (4, 5), 96, 3, True),
               "stage2": ((32, 10), (4, 5), 192, 6, True),
               "stage3": ((16, 5), (4, 5), 384, 12, True),
               "stage4": ((9, 3), (3, 3), 768, 24, False)}
STAGE_FRAMES = {"stage1": 5, "stage2": 7, "stage3": 9, "stage4": 11}


def _swin_stage_args(g, dev, stage, dtype=torch.float32):
    """K4's arguments at a Swin stage: x, the four projections, the bias
    table; its heads, rel_index and the shift mask (None unshifted)."""
    grid, window, c, heads, shifted = SWIN_STAGES[stage]
    n = window[0] * window[1]
    nw = (grid[0] // window[0]) * (grid[1] // window[1])
    nbw = nw * STAGE_FRAMES[stage]
    lin = c ** -0.5
    args = [_rand(g, dev, nbw, n, c, dtype=dtype),
            torch.cat([_rand(g, dev, 2 * c, c, scale=0.3 * lin),
                       _rand(g, dev, c, c, scale=lin)]),
            _rand(g, dev, 3 * c, scale=0.1), _rand(g, dev, c, c, scale=lin),
            _rand(g, dev, c, scale=0.1),
            _rand(g, dev, (2 * window[0] - 1) * (2 * window[1] - 1), heads,
                  scale=0.5)]
    rel = torch.from_numpy(relative_position_index(window)).to(dev)
    mask = (torch.from_numpy(shifted_window_mask(*grid, window, 2)).to(dev)
            if shifted else None)
    return args, heads, rel, mask


def _window_bwd_core_inputs(stage, with_addmask=True, seed=9):
    g = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    args, heads, rel, mask = _swin_stage_args(g, dev, stage)
    x, qkv_w, qkv_b, proj_w = args[:4]
    nbw, n, c = x.shape
    qkv = K.linear_plain(x.reshape(nbw * n, c), qkv_w, qkv_b)
    do = _rand(g, dev, nbw * n, c)
    am = (additive_matrix(heads, n, args[5], rel, mask)
          if with_addmask else None)
    return qkv, do, am, n, heads, (c // heads) ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("stage,with_addmask", [
    ("stage1", True), ("stage2", True), ("stage3", True), ("stage4", False),
    ("stage4", True)])
def test_window_attention_bwd_core_matches_plain(cuda, stage, with_addmask):
    """K4's backward kernel (``wa_attention_bwd``) against its plain version
    at the four Swin stage shapes (stages 1-3 with the bias table and the
    shift mask, stage 4's 3x3 windows without an additive matrix and with
    the bias table alone): dqkv, the context and d_addmask within 1e-4 x
    max(1, max|plain|); one launch."""
    inputs = _window_bwd_core_inputs(stage, with_addmask)
    K.reset_launch_counts()
    got = K.window_attention_bwd_core(*inputs)
    assert K.LAUNCHES["wa_attention_bwd"] == 1
    want = K.window_attention_bwd_core_plain(*inputs)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, i
        assert (a - b).abs().max().item() <= _f32_tol(b), i


# (N, head dim, heads, variants of the additive matrix or None): every
# key-tile count the kernel is built for (N <= 8, 16, 24, 32), head dims
# past one 32-column pass up to 160, and one (18) whose rows are not
# 16-byte chunks
WINDOW_BWD_RAGGED = [(5, 32, 2, 2), (16, 32, 3, None), (25, 32, 2, 3),
                     (32, 32, 1, 1), (20, 64, 2, 2), (20, 160, 2, None),
                     (9, 18, 2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,heads,nw", WINDOW_BWD_RAGGED)
def test_window_attention_bwd_core_at_ragged_shapes(cuda, n, d, heads, nw):
    """The backward kernel away from the Swin's shapes, within its limits:
    against its plain version within 1e-4 x max(1, max|plain|), on five
    windows of each variant (the last slice of windows a short one) or 15
    windows."""
    g = torch.Generator().manual_seed(11)
    nbw, c = 15 if nw is None else 5 * nw, heads * d
    qkv = _rand(g, cuda, nbw * n, 3 * c)
    do = _rand(g, cuda, nbw * n, c)
    am = None if nw is None else _rand(g, cuda, nw, heads, n, n)
    args = (qkv, do, am, n, heads, d ** -0.5)
    got = K.window_attention_bwd_core(*args)
    want = K.window_attention_bwd_core_plain(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        assert (a - b).abs().max().item() <= _f32_tol(b), i


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["stage1", "stage4"])
def test_window_attention_bwd_core_is_deterministic(cuda, stage):
    """Two calls on the same inputs give the same bits: d_addmask sums its
    partials in a fixed order (no float atomics), dqkv has one writer."""
    inputs = _window_bwd_core_inputs(stage)
    first = K.window_attention_bwd_core(*inputs)
    second = K.window_attention_bwd_core(*inputs)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# tokens a frame at each Swin stage (64x20, 32x10, 16x5, 9x3): the rows of
# K4's backward are frames x these
STAGE_TOKENS = {"stage1": 1280, "stage2": 320, "stage3": 80, "stage4": 27}


def _wgrad_inputs(dev, rows, c, bf16_origin=False, seed=12):
    """dqkv [rows, 3C], x2, g2, o [rows, C], float32; x2 and g2 upcast from
    bf16 under bf16_origin."""
    g = torch.Generator().manual_seed(seed)
    dqkv, x2, g2, o = (_rand(g, dev, rows, w) for w in (3 * c, c, c, c))
    if bf16_origin:
        x2, g2 = x2.to(BF).float(), g2.to(BF).float()
    return dqkv, x2, g2, o


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(SWIN_STAGES))
@pytest.mark.parametrize("origin", ["f32", "bf16"])
def test_wgrad_matches_plain_at_swin_stages(cuda, stage, origin):
    """K4 backward's weight-gradient kernel (``wa_wgrad``) against its plain
    version at the four Swin stages' rows and widths: d_qkv_w, d_qkv_b,
    d_proj_w and d_proj_b within 1e-4 x max(1, max|plain|), with x2 and g2
    f32 or upcast from bf16 (then claimed exact, the lo pass dropped); one
    launch of the entry point."""
    c = SWIN_STAGES[stage][2]
    rows = STAGE_FRAMES[stage] * STAGE_TOKENS[stage]
    bf16 = origin == "bf16"
    args = _wgrad_inputs(cuda, rows, c, bf16)
    K.reset_launch_counts()
    got = K.window_attention_wgrad(*args, x_tf32=bf16, g_tf32=bf16)
    assert K.LAUNCHES["wa_wgrad"] == 1
    want = K.window_attention_wgrad_plain(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, i
        assert (a - b).abs().max().item() <= _f32_tol(b), i


# (rows, C): row counts under, at and past a k-block (32) and a run, C off
# the 64 x 96 output tile (100, 36, 4) and the Swin's widest (768)
WGRAD_RAGGED = [(1, 96), (31, 64), (32, 64), (33, 64), (1000, 100), (4097, 96),
                (77, 36), (129, 768), (300, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", WGRAD_RAGGED)
def test_wgrad_at_ragged_rows(cuda, rows, c):
    """The weight-gradient kernel away from the Swin's shapes: its rows
    zero-filled past a run's end and its columns past the operands', within
    1e-4 x max(1, max|plain|)."""
    args = _wgrad_inputs(cuda, rows, c, seed=13)
    got = K.window_attention_wgrad(*args)
    want = K.window_attention_wgrad_plain(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a - b).abs().max().item() <= _f32_tol(b), i


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["stage1", "stage4"])
def test_wgrad_is_deterministic_and_drops_the_lo_pass_bit_equal(cuda, stage):
    """Two calls give the same bits (the runs' partial sums add in one order,
    no float atomics), and with x2 and g2 upcast from bf16 the claims that
    drop their lo pass change no bit."""
    c = SWIN_STAGES[stage][2]
    rows = STAGE_FRAMES[stage] * STAGE_TOKENS[stage]
    for bf16 in (False, True):
        args = _wgrad_inputs(cuda, rows, c, bf16, seed=14)
        first = K.window_attention_wgrad(*args, x_tf32=bf16, g_tf32=bf16)
        second = K.window_attention_wgrad(*args, x_tf32=bf16, g_tf32=bf16)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        if bf16:
            three = K.window_attention_wgrad(*args)
            assert all(torch.equal(a, b) for a, b in zip(first, three))


@pytest.mark.cuda
def test_window_attention_bwd_raises_above_its_limits(cuda):
    """Windows of 33 tokens: the CUDA branch raises, it does not run the
    PyTorch backward."""
    g = torch.Generator().manual_seed(10)
    c, heads = 32, 1
    x = _rand(g, cuda, 2, 33, c)
    qkv_w, proj_w = _rand(g, cuda, 3 * c, c), _rand(g, cuda, c, c)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="at most 32 tokens"):
        K.window_attention_bwd(x, qkv_w, None, proj_w, None, x, heads, 0.5)
    with pytest.raises(ValueError, match="at most 32 tokens"):
        K.window_attention_bwd_core(_rand(g, cuda, 66, 3 * c),
                                    _rand(g, cuda, 66, c), None, 33, heads, 0.5)
    assert not any(K.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(SWIN_STAGES))
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_window_attention_backward_matches_plain_autograd(cuda, stage, dtype):
    """WindowAttentionFused (the kernel forward, the backward with its
    attention part in one kernel) against autograd through the plain
    version at the four Swin stage shapes: the gradients of x, both
    projections, both biases and the bias table within 1e-4 x max(1,
    max|plain|) (f32) or 1 bf16 quantum of max|plain| (dx under a bf16 x);
    one backward kernel launch a backward."""
    args, heads, rel, mask = _swin_stage_args(torch.Generator().manual_seed(5),
                                              cuda, stage, dtype=dtype)
    for t in args:
        t.requires_grad_()
    go = _rand(torch.Generator().manual_seed(6), cuda, *args[0].shape,
               dtype=dtype)
    grads = []
    for fn in (K.window_attention_fused, K.window_attention_plain):
        K.reset_launch_counts()
        out = fn(*args[:5], heads, bias_table=args[5], rel_index=rel, mask=mask)
        grads.append(torch.autograd.grad(out, args, go))
        fused = fn is K.window_attention_fused
        assert K.LAUNCHES["window_attention"] == fused
        assert K.LAUNCHES["wa_attention_bwd"] == fused
        assert K.LAUNCHES["wa_wgrad"] == fused
    for i, (got, want) in enumerate(zip(*grads)):
        assert got.dtype == want.dtype == args[i].dtype
        tol = (_f32_tol(want) if got.dtype == torch.float32
               else want.float().abs().max().item() / 256)
        assert (got.float() - want.float()).abs().max().item() <= tol, i


@pytest.mark.cuda
def test_transformer_block_matches_plain(cuda):
    g = torch.Generator().manual_seed(4)
    c, mlp, heads = 256, 1024, 4
    r = lambda *s, scale=0.1, dtype=torch.float32: _rand(g, cuda, *s, scale=scale,
                                                        dtype=dtype)
    w = K.BlockWeights(1 + r(c), r(c), r(3 * c, c, scale=0.01, dtype=BF), r(3 * c),
                       r(c, c, scale=c ** -0.5, dtype=BF), r(c), 1 + r(c), r(c),
                       r(mlp, c, scale=c ** -0.5, dtype=BF), r(mlp),
                       r(c, mlp, scale=mlp ** -0.5, dtype=BF), r(c))
    x = r(16, 80, c, scale=1.0, dtype=BF)
    K.reset_launch_counts()
    for fin in (None, (1 + r(c), r(c))):
        got = K.transformer_block(x, w, heads, 0.5, 1e-6, fin).float()
        want = K.transformer_block_plain(x, w, heads, 0.5, 1e-6, fin).float()
        quantum = want.abs().max().item() / 256
        assert (got - want).abs().max().item() <= 4 * quantum
    assert K.LAUNCHES["transformer_block"] == 2
    assert K.LAUNCHES["tb_linear"] == 8 and K.LAUNCHES["tb_attention_core"] == 2


def _quanta(want, n):
    """n bf16 quanta (2^-8 relative) of max|want|."""
    return n * want.float().abs().max().item() / 256


def _f32_tol(want):
    return 1e-4 * max(1.0, want.float().abs().max().item())


# (rows, F, gsize) of branch2 and branch1 at the flagship's four stages,
# batch 32
GFN_FLAGSHIP = [(163840, 90, 10), (163840, 27, 3), (40960, 189, 21), (40960, 63, 7),
                (10240, 378, 42), (10240, 126, 14), (2560, 765, 85), (2560, 252, 28)]


def _gfn_matches_plain(dev, rows, f, gsize, dtype, act, seed=5):
    """K2 forward and backward against the plain version; dscale and dbias
    are also checked to be the same bits on a second run.

    With the LeakyReLU folded in, the biases are +-(scale * sqrt(gsize - 1)
    + 1) by channel: a normalized value never exceeds sqrt(gsize - 1), so
    every pre-activation lies at least 1 from the kink, where a rounding
    difference could send the kernel and the plain version down the two
    (equally right) branches of the derivative."""
    g = torch.Generator().manual_seed(seed)
    y = _rand(g, dev, rows, f, scale=2.0, dtype=dtype) + 0.5
    s, b = 1 + _rand(g, dev, f, scale=0.1), _rand(g, dev, f, scale=0.1)
    if act is not None:
        sign = torch.where(torch.arange(f, device=dev) % 2 == 0, 1.0, -1.0)
        b = sign * (s.abs() * (gsize - 1) ** 0.5 + 1)
    go = _rand(g, dev, rows, f, dtype=dtype)
    K.reset_launch_counts()
    got = K.group_flat_norm_fwd(y, s, b, gsize, 1e-3, act)
    want = K.group_flat_norm_fwd_plain(y, s, b, gsize, 1e-3, act)
    nq = 2
    tol = _f32_tol(want) if dtype == torch.float32 else _quanta(want, nq)
    assert (got.float() - want.float()).abs().max().item() <= tol
    dy, ds, db = K.group_flat_norm_bwd(y, go, s, b, gsize, 1e-3, act)
    wdy, wds, wdb = K.group_flat_norm_bwd_plain(y, go, s, b, gsize, 1e-3, act)
    tol = _f32_tol(wdy) if dtype == torch.float32 else _quanta(wdy, nq)
    assert (dy.float() - wdy.float()).abs().max().item() <= tol
    for got_s, want_s in ((ds, wds), (db, wdb)):
        rel = 1e-4 * max(1.0, want_s.abs().max().item())
        assert (got_s - want_s).abs().max().item() <= rel
    again = K.group_flat_norm_bwd(y, go, s, b, gsize, 1e-3, act)
    assert torch.equal(again[1], ds) and torch.equal(again[2], db)
    assert K.LAUNCHES["group_flat_norm_fwd"] == 1
    assert K.LAUNCHES["group_flat_norm_bwd"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f,gsize", GFN_FLAGSHIP)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("act", [None, 0.3])
def test_group_flat_norm_matches_plain(cuda, rows, f, gsize, dtype, act):
    """K2 at all eight branch shapes of the flagship at batch 32."""
    _gfn_matches_plain(cuda, rows, f, gsize, dtype, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_group_flat_norm_ragged_rows(cuda, dtype):
    """Row counts at the edges of the launch plan: fewer rows than one tile
    (and than 16 bytes' worth of rows), one row over a tile, and a run of
    many tiles whose last one ends off a 16-byte multiple (rows * F * elem),
    so its tail is copied by the threads."""
    f, gsize = 63, 7
    elem = torch.tensor([], dtype=dtype).element_size()
    step = 16 // math.gcd(f * elem, 16)
    blocks = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count
    for rows, edge in ((step - 1, "under"), (step + 1, "over"), (100001, "tail")):
        r, _ = K.gfn_plan(rows, f, elem, "fwd", blocks)
        assert {"under": rows < r, "over": rows == r + 1,
                "tail": rows > 8 * r and rows * f * elem % 16 != 0}[edge]
        _gfn_matches_plain(cuda, rows, f, gsize, dtype, 0.3)


@pytest.mark.cuda
def test_group_flat_norm_unaligned_view(cuda):
    """A contiguous view whose data does not start 16-byte aligned: the
    kernel wrappers raise ValueError; the autograd entry copies it once
    (counted) and launches."""
    g = torch.Generator().manual_seed(12)
    base = _rand(g, cuda, 64 * 90 + 1)
    y = base[1:].view(64, 90)
    assert y.data_ptr() % 16
    s, b = torch.ones(90, device=cuda), torch.zeros(90, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        K.group_flat_norm_fwd(y, s, b, 10, 1e-3)
    with pytest.raises(ValueError, match="16-byte"):
        K.group_flat_norm_bwd(y, y.clone(), s, b, 10, 1e-3)
    K.reset_launch_counts()
    out = K.group_flat_norm(y, s, b, 10, 1e-3, act="leaky")
    assert K.LAYOUT_COPIES["group_flat_norm"] == 1
    assert K.LAUNCHES["group_flat_norm_fwd"] == 1
    torch.testing.assert_close(out, K.group_flat_norm_plain(y, s, b, 10, 1e-3, act="leaky"),
                               rtol=1e-5, atol=1e-5)


# K2's forward op, the TransUNet's eval branch norm: the eight branch shapes
# of a b64 serving forward (GFN_FLAGSHIP's rows twice)
GFN_SERVE = [(2 * rows, f, gsize) for rows, f, gsize in GFN_FLAGSHIP]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,f,gsize", GFN_SERVE)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_group_flat_norm_eval_op_at_serving_shapes(cuda, rows, f, gsize, dtype):
    """group_flat_norm_eval on a [64, rows / 64, F] branch output: one op
    call, one kernel launch, no layout copy, and the plain forward's values
    within two bf16 quanta (f32: 1e-4 relative)."""
    g = torch.Generator().manual_seed(gsize)
    y = _rand(g, cuda, 64, rows // 64, f, scale=2.0, dtype=dtype) + 0.5
    s, b = 1 + _rand(g, cuda, f, scale=0.1), _rand(g, cuda, f, scale=0.1)
    K.reset_launch_counts()
    got = K.group_flat_norm_eval(y, s, b, gsize, 1e-3, act="leaky",
                                 act_alpha=0.3)
    want = K.group_flat_norm_fwd_plain(y.view(rows, f), s, b, gsize, 1e-3, 0.3)
    assert got.shape == y.shape and got.dtype == dtype
    tol = _f32_tol(want) if dtype == torch.float32 else _quanta(want, 2)
    assert (got.view(rows, f).float() - want.float()).abs().max().item() <= tol
    assert K.LAUNCHES["group_flat_norm"] == K.LAUNCHES["group_flat_norm_fwd"] == 1
    assert K.LAYOUT_COPIES["group_flat_norm"] == 0


def _old_eval_norm(y, scale, bias, gsize, eps, act, act_alpha):
    """The eval branch norm as it was written before it ran on K2: PyTorch
    ops, the float32 result cast to y's dtype before the LeakyReLU."""
    shape = y.shape
    yg = y.float().reshape(*shape[:-1], shape[-1] // gsize, gsize)
    zc = yg - yg.mean(-1, keepdim=True)
    out = (zc * torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)).reshape(shape)
    out = (out * scale.reshape(-1) + bias.reshape(-1)).to(y.dtype)
    return torch.where(out >= 0, out, act_alpha * out)


@pytest.mark.cuda
def test_transunet_bf16_b64_eval_runs_k2_for_its_branch_norms(cuda, monkeypatch):
    """The full-width TransUNet's bf16 eval forward at b64 (seeded random
    weights): K2's forward op once for each of the 8 branch norms (two a
    stage), each one launch, no layout copy; its probabilities within the
    serving cell's limit (0.0065, the worst frame's RMS) of the same forward
    with the old eval norm formula."""
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    from ultrasound_modeling_tpu_torch.utils.checkpoint import (
        from_flax, random_flax_variables)
    mcfg = default_config("transunet").model
    model = build_model(mcfg)
    model.load_state_dict(from_flax(random_flax_variables(model, 0), "transunet"))
    model = model.eval().to(cuda)
    model.compute_dtype = BF
    h, w = mcfg.img_size
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, h, w, mcfg.in_channels)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        K.reset_launch_counts()
        got = model(x)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        copies = K.LAYOUT_COPIES["group_flat_norm"]
        monkeypatch.setattr(K, "group_flat_norm_eval", _old_eval_norm)
        want = model(x)
    assert counts["group_flat_norm"] == counts["group_flat_norm_fwd"] == 8
    assert copies == 0
    d = (got.double() - want.double()).reshape(64, -1)
    worst = d.pow(2).mean(1).sqrt().max().item()
    print(f"bf16 b64 eval forward, K2 vs the old norm formula: worst frame "
          f"RMS {worst:.3e}, max abs {d.abs().max().item():.3e}")
    assert worst <= 0.0065


@pytest.mark.cuda
def test_transunet_bf16_eval_folds_its_batch_norms(cuda, monkeypatch):
    """The full-width TransUNet's bf16 eval forward at b8 (seeded random
    weights) folds its 26 BatchNorms into the convs before them
    (``models.common.conv_norm``): within the serving gate of its f32
    forward (max abs 0.05, argmax agreement 0.99, TF32 off), and within the
    serving cell's limit (0.0065, the worst frame's RMS) of the same bf16
    forward with each conv, then its norm."""
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.models import common, resnest, transunet
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    from ultrasound_modeling_tpu_torch.utils.checkpoint import (
        from_flax, random_flax_variables)
    common.full_f32_matmuls()
    mcfg = default_config("transunet").model
    model = build_model(mcfg)
    model.load_state_dict(from_flax(random_flax_variables(model, 0), "transunet"))
    model = model.eval().to(cuda)
    h, w = mcfg.img_size
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, h, w, mcfg.in_channels)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        f32 = model(x)
        model.compute_dtype = BF
        common.reset_fold_counts()
        got = model(x)
        torch.cuda.synchronize()
        folds = dict(common.FOLDS)
        for mod in (transunet, resnest):
            monkeypatch.setattr(mod, "conv_norm", lambda c, n, t: n(c(t)))
        separate = model(x)
    assert folds == {"conv_norm": 26, "separate": 0}
    diff = (got - f32).abs().max().item()
    agree = (got.argmax(-1) == f32.argmax(-1)).float().mean().item()
    d = (got.double() - separate.double()).reshape(8, -1)
    worst = d.pow(2).mean(1).sqrt().max().item()
    print(f"bf16 b8 eval forward, folded: vs f32 max abs {diff:.3e}, argmax "
          f"agreement {agree:.6f}; vs conv then norm worst frame RMS "
          f"{worst:.3e}, max abs {d.abs().max().item():.3e}")
    assert diff <= 0.05 and agree >= 0.99
    assert worst <= 0.0065


@pytest.mark.cuda
@pytest.mark.parametrize("b,seq,c,heads", [(32, 80, 512, 4), (3, 20, 48, 4),
                                           (2, 160, 1280, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_flash_attention_matches_plain(cuda, b, seq, c, heads, dtype):
    """K3 forward (context, LSE) and backward (dqkv) at the flagship train
    shape, a small ragged one and the ViT limits (S 160, d 160)."""
    g = torch.Generator().manual_seed(6)
    qk = _rand(g, cuda, b * seq, 2 * c, scale=0.3)
    qkv = torch.cat([qk, _rand(g, cuda, b * seq, c)], dim=1).to(dtype)
    go = _rand(g, cuda, b * seq, c, dtype=dtype)
    scale = heads ** -0.5
    K.reset_launch_counts()
    ctx, lse = K.flash_attention_fwd(qkv, seq, heads, scale)
    wctx, wlse = K.flash_attention_fwd_plain(qkv, seq, heads, scale)
    f32 = dtype == torch.float32
    assert (ctx.float() - wctx.float()).abs().max().item() <= (
        _f32_tol(wctx) if f32 else _quanta(wctx, 2))
    assert (lse - wlse).abs().max().item() <= _f32_tol(wlse)
    dqkv = K.flash_attention_bwd(qkv, wlse, go, seq, heads, scale)
    want = K.flash_attention_bwd_plain(qkv, wlse, go, seq, heads, scale)
    assert (dqkv.float() - want.float()).abs().max().item() <= (
        _f32_tol(want) if f32 else _quanta(want, 4))
    assert K.LAUNCHES["flash_attention_fwd"] == 1
    assert K.LAUNCHES["flash_attention_bwd"] == 1


@pytest.mark.cuda
def test_autograd_functions_launch_backward_kernels(cuda):
    """group_flat_norm and flash_mha: the forward and the backward each
    launch their kernel once, and the gradients agree with autograd of the
    plain routes."""
    g = torch.Generator().manual_seed(7)
    y = _rand(g, cuda, 2, 16, 10, 90).requires_grad_()
    s = (1 + _rand(g, cuda, 3, 3, 10, scale=0.1)).requires_grad_()
    bias = _rand(g, cuda, 3, 3, 10, scale=0.1).requires_grad_()
    qkv = _rand(g, cuda, 4, 80, 3 * 512, scale=0.3).requires_grad_()
    K.reset_launch_counts()
    out = (K.group_flat_norm(y, s, bias, 10, 1e-3, act="leaky").sin().sum()
           + K.flash_mha(qkv, 4, 0.5).sin().sum())
    grads = torch.autograd.grad(out, (y, s, bias, qkv))
    for name in ("group_flat_norm_fwd", "group_flat_norm_bwd",
                 "flash_attention_fwd", "flash_attention_bwd"):
        assert K.LAUNCHES[name] == 1, name
    ref = (K.group_flat_norm_plain(y, s, bias, 10, 1e-3, act="leaky").sin().sum()
           + K.flash_mha_plain(qkv, 4, 0.5).sin().sum())
    for got, want in zip(grads, torch.autograd.grad(ref, (y, s, bias, qkv))):
        assert (got - want).abs().max().item() <= _f32_tol(want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,seq,c,heads", [(8, 160, 1280, 8), (32, 80, 512, 4),
                                           (3, 20, 48, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_attention_train_fwd_matches_plain(cuda, b, seq, c, heads, dtype):
    """K5 forward (out, saved qkv, P) at the ViT and TransUNet train shapes
    and a small ragged one, bf16 included (its contract: the output
    projection of the f32 context, rounded once); then AttentionTrainFused's
    gradients against autograd of the plain route."""
    g = torch.Generator().manual_seed(8)
    lin = c ** -0.5
    x = _rand(g, cuda, b * seq, c, dtype=dtype)
    qkv_w = torch.cat([_rand(g, cuda, 2 * c, c, scale=0.3 * lin),
                       _rand(g, cuda, c, c, scale=lin)]).to(dtype)
    qkv_b = _rand(g, cuda, 3 * c, scale=0.1).to(dtype).float()
    proj_w = _rand(g, cuda, c, c, scale=lin, dtype=dtype)
    proj_b = _rand(g, cuda, c, scale=0.1).to(dtype).float()
    args = (x, qkv_w, qkv_b, proj_w, proj_b, seq, heads, heads ** -0.5)
    K.reset_launch_counts()
    got = K.attention_train_fwd(*args)
    want = K.attention_train_fwd_plain(*args)
    f32 = dtype == torch.float32
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype == dtype and gt.shape == wt.shape
        tol = _f32_tol(wt) if f32 else _quanta(wt, 2)
        assert (gt.float() - wt.float()).abs().max().item() <= tol
    assert K.LAUNCHES["attention_train"] == 1
    assert K.LAUNCHES["at_attention_core"] == 1
    # the qkv projection in x's dtype, the output projection in f32 (the f32
    # context times the upcast weights)
    assert K.LAUNCHES["wa_linear"] == (2 if f32 else 1)
    assert K.LAUNCHES["tb_linear"] == (0 if f32 else 1)

    leaves = [t.detach().clone().requires_grad_() for t in args[:5]]
    x3 = leaves[0].view(b, seq, c)
    out = K.attention_train_fused(x3, *leaves[1:], heads, heads ** -0.5)
    go = _rand(g, cuda, b, seq, c, dtype=dtype)
    grads = torch.autograd.grad(out, leaves, go)
    ref = K.attention_train_fused_plain(x3, *leaves[1:], heads, heads ** -0.5)
    for gt, wt in zip(grads, torch.autograd.grad(ref, leaves, go)):
        assert gt.dtype == wt.dtype
        tol = _f32_tol(wt) if f32 else _quanta(wt, 8)
        assert (gt.float() - wt.float()).abs().max().item() <= tol


RAGGED_SEQ = [20, 77, 80, 150, 160]   # one tile, tile edges, two and three tiles
RAGGED_D = [32, 128, 160]


def _qkv(g, dev, b, seq, c, dtype=torch.float32):
    qk = _rand(g, dev, b * seq, 2 * c, scale=0.3)
    return torch.cat([qk, _rand(g, dev, b * seq, c)], dim=1).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", RAGGED_SEQ)
@pytest.mark.parametrize("d", RAGGED_D)
def test_attention_core_variants_at_ragged_shapes(cuda, seq, d):
    """The tensor-core forward core in each of its launchers: K1's (P, V
    rounded to bf16), K4's with an additive matrix (three windows' worth,
    -inf-free), K5's f32 and bf16 (f32 context, saved qkv, P)."""
    g = torch.Generator().manual_seed(10 + seq + d)
    heads, b = 2, 3
    c = heads * d
    qkv = _qkv(g, cuda, b, seq, c)
    scale = d ** -0.5
    got = K.attention_core(qkv, seq, heads, scale, pv_bf16=True, out_dtype=BF)
    want = K.attention_core_plain(qkv, seq, heads, scale, pv_bf16=True,
                                  out_dtype=BF)
    assert (got.float() - want.float()).abs().max().item() <= _quanta(want, 2)
    mask = _rand(g, cuda, 3, heads, seq, seq)
    got = K.attention_core(qkv, seq, heads, scale, addmask=mask)
    want = K.attention_core_plain(qkv, seq, heads, scale, addmask=mask)
    assert (got - want).abs().max().item() <= _f32_tol(want)
    for dt in (torch.float32, BF):
        got = K.attention_train_core(qkv, seq, heads, scale, dt)
        want = K.attention_train_core_plain(qkv, seq, heads, scale, dt)
        # the context in float32, the saved qkv and P in dt
        for gt, wt, want_dt in zip(got, want, (torch.float32, dt, dt)):
            assert gt.dtype == wt.dtype == want_dt and gt.shape == wt.shape
            tol = _f32_tol(wt) if want_dt == torch.float32 else _quanta(wt, 2)
            assert (gt.float() - wt.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("seq", RAGGED_SEQ)
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_flash_attention_at_ragged_shapes(cuda, seq, d, dtype):
    """K3's forward and both passes of its backward across tile edges (key
    tiles and query tiles alike) and head widths."""
    g = torch.Generator().manual_seed(20 + seq + d)
    heads, b = 2, 3
    c = heads * d
    qkv = _qkv(g, cuda, b, seq, c, dtype)
    go = _rand(g, cuda, b * seq, c, dtype=dtype)
    scale = d ** -0.5
    f32 = dtype == torch.float32
    ctx, lse = K.flash_attention_fwd(qkv, seq, heads, scale)
    wctx, wlse = K.flash_attention_fwd_plain(qkv, seq, heads, scale)
    assert (ctx.float() - wctx.float()).abs().max().item() <= (
        _f32_tol(wctx) if f32 else _quanta(wctx, 2))
    assert (lse - wlse).abs().max().item() <= _f32_tol(wlse)
    dqkv = K.flash_attention_bwd(qkv, wlse, go, seq, heads, scale)
    want = K.flash_attention_bwd_plain(qkv, wlse, go, seq, heads, scale)
    assert (dqkv.float() - want.float()).abs().max().item() <= (
        _f32_tol(want) if f32 else _quanta(want, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label2vec_smooth_matches_plain(cuda, smoothing):
    """K6 on labels straddling 0.95 and 1.05: the same bits as the plain
    version (rounded multiply, then add)."""
    g = torch.Generator().manual_seed(9)
    lab = (torch.rand(32, 256, 80, generator=g) * 2.3 - 0.1).to(cuda)
    lab.view(-1)[:4] = torch.tensor([0.95, 1.05, 2.0, 0.0])
    K.reset_launch_counts()
    got = K.label2vec_smooth(lab, smoothing)
    assert K.LAUNCHES["label2vec_smooth"] == 1
    assert torch.equal(got, K.label2vec_smooth_plain(lab, smoothing))


def test_ragged_shape_lists_cover_the_tile_edges():
    """The shapes above straddle the 64-row tile (77, 150), fill one and
    three tiles (20, 160) and cross the 80-token register bucket (80 vs
    150); the head widths are the Swin, TransUNet and ViT ones."""
    tiles = {-(-s // 64) for s in RAGGED_SEQ}
    assert tiles == {1, 2, 3}
    assert any(s % 64 for s in RAGGED_SEQ) and max(RAGGED_SEQ) == K.MAX_SEQ
    assert max(RAGGED_D) == K.MAX_HEAD_DIM and min(RAGGED_D) == 32


def test_wrapper_device_routing():
    """Without a card a CUDA tensor cannot even be made; with one, the
    wrapper launches (counted) — it never computes a CUDA input on the
    plain path.  Here: the wrapper's device routing itself."""
    assert K._on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        K._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
    assert np.isclose(float(K.layer_norm(torch.ones(1, 4), torch.ones(4),
                                         torch.zeros(4), 1e-6,
                                         torch.float32).sum()), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["resnest_unet", "mobileunet"])
def test_unet_family_full_width_forward_matches_the_cpu(cuda, family):
    """The two U-Nets at full width (the default config: 256x64x6 and
    256x64x15), seeded random weights through the bridge, batch 64 on the
    card against the port's CPU forward of the first 4 frames: f32 within
    1e-4 (TF32 off), bf16 within 0.05 of the card's f32 with argmax
    agreement >= 0.99, and no kernel of ops/kernels.py launched (neither
    family has one on its path)."""
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    from ultrasound_modeling_tpu_torch.utils.checkpoint import (
        from_flax, random_flax_variables)
    full_f32_matmuls()
    mcfg = default_config(family).model
    model = build_model(mcfg)
    model.load_state_dict(from_flax(random_flax_variables(model, 0), family))
    model.eval()
    h, w = mcfg.img_size
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, h, w, mcfg.in_channels)).astype(np.float32))
    with torch.inference_mode():
        cpu = model(x[:4])
        model.to(cuda)
        K.reset_launch_counts()
        f32 = model(x.to(cuda))
        model.compute_dtype = torch.bfloat16
        bf16 = model(x.to(cuda))
        torch.cuda.synchronize()
    assert not any(K.LAUNCHES.values())
    assert f32.shape == (64, h, w, 3) and torch.isfinite(f32).all()
    assert (f32[:4].cpu() - cpu).abs().max().item() <= 1e-4
    assert (bf16 - f32).abs().max().item() <= 0.05
    assert (bf16.argmax(-1) == f32.argmax(-1)).float().mean().item() >= 0.99


# K4's forward at the Swin's shapes: the per-window core (wa_window_fwd_kernel,
# windows of at most 32 tokens) and the narrow schedule of the f32 GEMM
# (linear_narrow_kernel, K a whole multiple of 96)

# (N, head dim): stage 4's padded 3x3, the 4x5 window and the longest window
# the kernel takes, at the Swin's d 32, and at head dims that are not 16-byte
# rows (18), past one 32-column pass (40) and the limit (160)
WINDOW_FWD_SHAPES = [(n, d) for n in (9, 20, 32) for d in (32, 18, 40, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", WINDOW_FWD_SHAPES)
@pytest.mark.parametrize("masked", [True, False])
def test_window_core_matches_plain(cuda, n, d, masked):
    """wa_attention_core at N <= 32 runs the per-window kernel (one launch
    of it, beside the one count of its entry point): against its plain
    version within 1e-4 x max(1, max|plain|), with an additive matrix of
    three variants and without one, on 3 x 5 windows of 2 heads."""
    g = torch.Generator().manual_seed(30 + n + d)
    heads, nw = 2, 3
    qkv = _qkv(g, cuda, 5 * nw, n, heads * d)
    am = _rand(g, cuda, nw, heads, n, n) if masked else None
    K.reset_launch_counts()
    got = K.attention_core(qkv, n, heads, d ** -0.5, addmask=am)
    assert K.LAUNCHES["wa_attention_core"] == K.LAUNCHES["wa_window_fwd"] == 1
    want = K.attention_core_plain(qkv, n, heads, d ** -0.5, addmask=am)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= _f32_tol(want)


@pytest.mark.cuda
def test_window_core_is_deterministic(cuda):
    """Two calls of the per-window core on the same inputs give the same
    bits (each context element has one writer and a fixed order of sums)."""
    g = torch.Generator().manual_seed(31)
    qkv = _qkv(g, cuda, 256, 20, 96)
    am = _rand(g, cuda, 64, 3, 20, 20)
    first = K.attention_core(qkv, 20, 3, 32 ** -0.5, addmask=am)
    assert torch.equal(first, K.attention_core(qkv, 20, 3, 32 ** -0.5, addmask=am))


def _swin_gemm_shapes(frames):
    """(M, N, K) of K4's products at the Swin's four stages for `frames`
    frames: qkv (N 3C, K C), proj and do (N C, K C), dx (N C, K 3C)."""
    out = []
    for grid, window, c, _, _ in SWIN_STAGES.values():
        gh, gw = -(-grid[0] // window[0]) * window[0], grid[1]
        m = frames * gh * gw
        out += [(m, 3 * c, c), (m, c, c), (m, c, 3 * c)]
    return out


# the Swin's products at b64 serving, and the tile edges: M one past and
# one short of a 128-row tile, N not a multiple of 96 (a ragged, odd last
# 96-column tile, whose epilogue stores scalars, and one under a tile)
NARROW_SHAPES = _swin_gemm_shapes(64) + [(128 * 7 + 1, 288, 96),
                                         (128 * 7 - 1, 192, 192),
                                         (200, 101, 96), (130, 40, 288)]


def _narrow(a, w, bias=None, a_tf32=False):
    """wa_linear's narrow schedule on any shape, whatever linear_plan would
    pick (the C entry point called as linear calls it), f32 out."""
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty((m, n), device=a.device)
    bm, bn = K.NARROW_TILE
    grid = min(-(-m // bm) * -(-n // bn), K.NARROW_BLOCKS_PER_SM * K._sm_count(a.device))
    rc = K.build().wa_linear(K._ptr(a), K._ptr(w), K._ptr(bias), None, 0, K._ptr(out),
                             0, m, n, k, 0, int(a_tf32), grid, K._stream())
    assert rc == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", NARROW_SHAPES)
def test_wa_linear_narrow_matches_plain(cuda, m, n, k):
    """wa_linear at the Swin's products and the tile edges, on the schedule
    linear_plan picks (one launch, counted as narrow when it is), against
    linear_plain within 1e-4 x max(1, max|plain|) with a bias, and bf16 out
    with an f32 residual within 2 bf16 quanta (one rounding flip moves an
    element by up to 2^-7 of itself); the narrow schedule itself at every
    one of these shapes, and on an A upcast from bf16 with its A_lo pass
    dropped: the same bits as with it."""
    g = torch.Generator().manual_seed(40 + n + k)
    a = _rand(g, cuda, m, k)
    w = _rand(g, cuda, n, k, scale=k ** -0.5)
    b = _rand(g, cuda, n)
    r = _rand(g, cuda, m, n)
    K.reset_launch_counts()
    got = K.linear(a, w, b)
    narrow = K.linear_plan(m, n, k, torch.float32, K._sm_count(cuda)) > 0
    assert K.LAUNCHES["wa_linear"] == 1 and K.LAUNCHES["wa_linear_narrow"] == narrow
    want = K.linear_plain(a, w, b)
    assert (got - want).abs().max().item() <= _f32_tol(want)
    assert (_narrow(a, w, b) - want).abs().max().item() <= _f32_tol(want)
    got = K.linear(a, w, residual=r, out_dtype=BF)
    want = K.linear_plain(a, w, residual=r, out_dtype=BF)
    assert (got.float() - want.float()).abs().max().item() <= _quanta(want, 2)
    a16 = a.to(BF).float()
    three = _narrow(a16, w, b)
    assert torch.equal(three, _narrow(a16, w, b, a_tf32=True))
    assert (three - K.linear_plain(a16, w, b)).abs().max().item() <= _f32_tol(three)


@pytest.mark.cuda
def test_wa_linear_narrow_holds_the_f32_contract_at_swin_depth(cuda):
    """The narrow schedule at the Swin's deepest K (dx at stage 4: K 2304)
    against a float64 product: within 1e-5 of max|out|, three passes and,
    on an A upcast from bf16, two."""
    g = torch.Generator().manual_seed(12)
    a = _rand(g, cuda, 1728, 2304)
    w = _rand(g, cuda, 768, 2304, scale=2304 ** -0.5)
    K.reset_launch_counts()
    got = K.linear(a, w)
    assert K.LAUNCHES["wa_linear_narrow"] == 1
    want = a.double() @ w.double().t()
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    two = K.linear(a.to(BF).float(), w, a_tf32=True)
    want = a.to(BF).double() @ w.double().t()
    assert (two.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(5120, 1536, 512), (10240, 3840, 1280),
                                   (1280, 1280, 1280)])
def test_wa_linear_keeps_the_128_tile_at_transunet_and_vit_widths(cuda, m, n, k):
    """The TransUNet's, the ViT's and K5's f32 products stay on the 128 x
    128 schedule (no narrow launch), within 1e-4 of plain."""
    g = torch.Generator().manual_seed(13)
    a, w = _rand(g, cuda, m, k), _rand(g, cuda, n, k, scale=k ** -0.5)
    K.reset_launch_counts()
    got = K.linear(a, w)
    assert K.LAUNCHES["wa_linear"] == 1 and K.LAUNCHES["wa_linear_narrow"] == 0
    want = K.linear_plain(a, w)
    assert (got - want).abs().max().item() <= _f32_tol(want)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(SWIN_STAGES))
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_window_attention_forward_at_swin_stages(cuda, stage, dtype):
    """K4's whole forward at the four Swin stage shapes, f32 and bf16 x:
    two GEMMs on the schedules linear_plan picks (the qkv one without its
    A_lo pass under bf16) and the per-window core; against the plain
    version within 1e-4 x max(1, max|plain|) (f32) or 2 bf16 quanta of
    max|plain| (one rounding flip of an element in max's binade)."""
    args, heads, rel, mask = _swin_stage_args(torch.Generator().manual_seed(7),
                                              cuda, stage, dtype=dtype)
    kw = dict(bias_table=args[5], rel_index=rel, mask=mask)
    K.reset_launch_counts()
    got = K.window_attention(*args[:5], heads, **kw)
    m, c = args[0].shape[0] * args[0].shape[1], args[0].shape[2]
    sms = K._sm_count(cuda)
    narrow = ((K.linear_plan(m, 3 * c, c, torch.float32, sms, dtype == BF) > 0)
              + (K.linear_plan(m, c, c, torch.float32, sms) > 0))
    assert K.LAUNCHES["wa_linear"] == 2 and K.LAUNCHES["wa_window_fwd"] == 1
    assert K.LAUNCHES["wa_linear_narrow"] == narrow
    want = K.window_attention_plain(*args[:5], heads, **kw)
    assert got.dtype == want.dtype == dtype
    tol = _f32_tol(want) if dtype == torch.float32 else _quanta(want, 2)
    assert (got.float() - want.float()).abs().max().item() <= tol
