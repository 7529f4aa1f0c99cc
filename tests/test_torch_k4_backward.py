"""K4's backward on the CPU: the plain versions of the port's backward and
of its attention kernel (``window_attention_bwd_core``) against the JAX
package's ``_fused_attn_bwd`` / ``_fused_attn_recompute``
(``ultrasound_modeling_tpu/ops/pallas_kernels.py:190-235``), the sequence
the card runs (``_window_attention_bwd``) against the plain backward, and
the kernel's limits and launch plan.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.ops import pallas_kernels as pk
from ultrasound_modeling_tpu.ops import window_attn as jwa
from ultrasound_modeling_tpu_torch.ops import kernels as K

# (nbw, window, c, heads, addmask): a Swin stage-1 slice (4x5 windows, C 96,
# 3 heads, the bias table and the shift mask of an 8x10 grid: four
# variants), and stage 4's padded 3x3 windows (N 9) with the bias table
# alone (one variant) and with no additive matrix at all
CASES = {"stage1_mask_bias": (4, (4, 5), 96, 3, "mask"),
         "n9_bias": (4, (3, 3), 64, 2, "bias"),
         "n9_none": (4, (3, 3), 64, 2, None)}


def _inputs(case, seed=0, orthonormal_x=False):
    """Seeded float32 inputs in the JAX layout (``qkv_w [C, 3C]``,
    ``proj_w [C, C]``), the additive matrix ``[nW, heads, N, N]`` (or None)
    and the output gradient.  ``orthonormal_x``: x's rows orthonormal
    (nBW*N <= C), so that dqkv follows from x2 and d_qkv_w."""
    nbw, window, c, heads, kind = CASES[case]
    n = window[0] * window[1]
    r = np.random.default_rng(seed)
    if orthonormal_x:
        q, _ = np.linalg.qr(r.normal(size=(c, c)))
        x = q[:, :nbw * n].T.reshape(nbw, n, c) * 2.0
    else:
        x = r.normal(size=(nbw, n, c))
    a = dict(x=x, qkv_w=r.normal(size=(c, 3 * c)) * c ** -0.5,
             qkv_b=r.normal(size=(3 * c,)) * 0.1,
             proj_w=r.normal(size=(c, c)) * c ** -0.5,
             proj_b=r.normal(size=(c,)) * 0.1,
             g=r.normal(size=(nbw * n, c)))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    addmask = None
    if kind is not None:
        table = (r.normal(size=((2 * window[0] - 1) * (2 * window[1] - 1),
                                heads)) * 0.5).astype(np.float32)
        rel = jwa.relative_position_index(window)
        bias = table[rel.reshape(-1)].reshape(n, n, heads).transpose(2, 0, 1)
        addmask = bias[None]
        if kind == "mask":
            mask = np.asarray(jwa.shifted_window_mask(8, 10, window, 2))
            addmask = bias[None] + mask[:, None]
        addmask = np.ascontiguousarray(addmask, np.float32)
    return a, addmask, n, heads, (c // heads) ** -0.5


def _jax_bwd(a, addmask, n, heads, scale):
    """``_fused_attn_bwd`` with one window a grid step (its additive matrix
    is then the port's [nW, heads, N, N]); no addmask is a zero one."""
    c = a["x"].shape[-1]
    am = (np.zeros((1, heads, n, n), np.float32) if addmask is None
          else addmask)
    static = (heads, scale, n, c, am.shape[0], True)
    res = tuple(jnp.asarray(v) for v in (
        a["x"].reshape(-1, c), a["qkv_w"], a["qkv_b"], a["proj_w"],
        a["proj_b"], am))
    grads = pk._fused_attn_bwd(static, res, jnp.asarray(a["g"]))
    _, _, _, _, _, o = pk._fused_attn_recompute(static, *res)
    return [np.asarray(t) for t in grads], np.asarray(o).reshape(-1, c)


def _port_args(a, addmask, dtype=torch.float32):
    """(x, qkv_w, qkv_b, proj_w, addmask, g) in the port's layout."""
    t = torch.from_numpy
    x = t(a["x"]).to(dtype)
    return (x, t(a["qkv_w"].T.copy()), t(a["qkv_b"]), t(a["proj_w"].T.copy()),
            None if addmask is None else t(addmask),
            t(a["g"]).reshape(x.shape).to(dtype))


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax_fused_attn_bwd(case):
    """The port's plain backward (its PyTorch body) equals JAX's
    ``_fused_attn_bwd`` leaf by leaf: dx, d_qkv_w, d_qkv_b, d_proj_w,
    d_proj_b and d_addmask (f32, rtol 1e-4, atol 1e-5 x max)."""
    a, addmask, n, heads, scale = _inputs(case)
    want, _ = _jax_bwd(a, addmask, n, heads, scale)
    got = K.window_attention_bwd_plain(*_port_args(a, addmask), heads, scale)
    names = ["dx", "d_qkv_w", "d_qkv_b", "d_proj_w", "d_proj_b", "d_addmask"]
    for name, g, w in zip(names, got, want):
        if name == "d_addmask" and addmask is None:
            assert g is None
            continue
        g = g.numpy()
        if name in ("d_qkv_w", "d_proj_w"):
            g = g.T
        _close(g.reshape(w.shape), w, name)


@pytest.mark.parametrize("case", ["stage1_mask_bias", "n9_bias"])
def test_bwd_core_plain_matches_jax(case):
    """The plain version of the kernel's entry point against the JAX
    pieces: o against ``_fused_attn_recompute``'s context, d_addmask against
    ``_fused_attn_bwd``'s, and dqkv against the one backed out of
    ``_fused_attn_bwd``'s ``d_qkv_w = x2^T dqkv`` (x's rows orthonormal:
    dqkv = (x2 x2^T)^-1 x2 d_qkv_w)."""
    a, addmask, n, heads, scale = _inputs(case, seed=1, orthonormal_x=True)
    (_, d_qkv_w, _, _, _, d_am), o = _jax_bwd(a, addmask, n, heads, scale)
    x2 = a["x"].reshape(-1, a["x"].shape[-1]).astype(np.float64)
    x, qkv_w, qkv_b, proj_w, am, g = _port_args(a, addmask)
    c = x.shape[-1]
    qkv = K.linear_plain(x.reshape(-1, c), qkv_w, qkv_b)
    do = g.reshape(-1, c) @ proj_w
    dqkv, o_got, d_am_got = K.window_attention_bwd_core_plain(
        qkv, do, am, n, heads, scale)
    _close(o_got.numpy(), o, "o")
    _close(d_am_got.numpy(), d_am, "d_addmask")
    want = np.linalg.solve(x2 @ x2.T, x2 @ d_qkv_w.astype(np.float64))
    _close(dqkv.numpy(), want, "dqkv")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_sequence_matches_plain_backward(case, dtype):
    """Steps a-e as the card runs them (``_window_attention_bwd``: the two
    GEMMs, the attention core, the weight and bias gradients, dx in x's
    dtype), here with the plain GEMM, the plain core and the plain weight
    gradients, against the plain backward: f32 within 1e-5 x max|plain|
    (sums in another order), dx under a bf16 x within 1 bf16 quantum."""
    a, addmask, n, heads, scale = _inputs(case, seed=2)
    args = _port_args(a, addmask, dtype)
    got = K._window_attention_bwd(*args, heads, scale, K.linear_plain,
                                  K.window_attention_bwd_core_plain,
                                  K.window_attention_wgrad_plain)
    want = K.window_attention_bwd_plain(*args, heads, scale)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, i
        top = w.float().abs().max().item()
        tol = top / 256 if g.dtype == torch.bfloat16 else 1e-5 * top
        assert (g.float() - w.float()).abs().max().item() <= tol, i


@pytest.mark.parametrize("case", list(CASES))
def test_wgrad_plain_matches_jax_fused_attn_bwd(case):
    """The plain version of the weight-gradient kernel
    (``window_attention_wgrad_plain``) on the plain core's dqkv and context
    equals JAX's ``_fused_attn_bwd`` d_qkv_w, d_qkv_b, d_proj_w and d_proj_b
    (f32, rtol 1e-4, atol 1e-5 x max)."""
    a, addmask, n, heads, scale = _inputs(case, seed=4)
    want, _ = _jax_bwd(a, addmask, n, heads, scale)
    x, qkv_w, qkv_b, proj_w, am, g = _port_args(a, addmask)
    c = x.shape[-1]
    x2, g2 = x.reshape(-1, c), g.reshape(-1, c)
    qkv = K.linear_plain(x2, qkv_w, qkv_b)
    dqkv, o, _ = K.window_attention_bwd_core_plain(qkv, g2 @ proj_w, am, n,
                                                   heads, scale)
    got = K.window_attention_wgrad_plain(dqkv, x2, g2, o)
    names = ["d_qkv_w", "d_qkv_b", "d_proj_w", "d_proj_b"]
    for name, gt, w in zip(names, got, want[1:5]):
        gt = gt.numpy()
        if gt.ndim == 2:
            gt = gt.T
        _close(gt.reshape(w.shape), w, name)


def test_wgrad_tf32_claims_are_checked_on_the_cpu():
    """``window_attention_wgrad`` on CPU tensors gives the plain version's
    result bit for bit, with or without the claims that x2 and g2 are
    exactly TF32 (both upcast from bf16); a claim about an operand below
    TF32 precision raises, and so does a dqkv that is not 3C wide."""
    a, addmask, n, heads, scale = _inputs("stage1_mask_bias", seed=5)
    x, qkv_w, qkv_b, proj_w, am, g = _port_args(a, addmask)
    c = x.shape[-1]
    x2, g2 = x.reshape(-1, c), g.reshape(-1, c)
    dqkv, o, _ = K.window_attention_bwd_core_plain(
        K.linear_plain(x2, qkv_w, qkv_b), g2 @ proj_w, am, n, heads, scale)
    x16, g16 = x2.to(torch.bfloat16).float(), g2.to(torch.bfloat16).float()
    want = K.window_attention_wgrad_plain(dqkv, x16, g16, o)
    for claims in ({}, {"x_tf32": True}, {"g_tf32": True},
                   {"x_tf32": True, "g_tf32": True}):
        got = K.window_attention_wgrad(dqkv, x16, g16, o, **claims)
        assert all(torch.equal(u, w) for u, w in zip(got, want)), claims
    for claims in ({"x_tf32": True}, {"g_tf32": True}):
        with pytest.raises(ValueError, match="below TF32"):
            K.window_attention_wgrad(dqkv, x2, g2, o, **claims)
    with pytest.raises(ValueError, match="3C"):
        K.window_attention_wgrad(dqkv[:, :-1].contiguous(), x2, g2, o)


@pytest.mark.parametrize("n,head_dim,ok", [(32, 32, True), (9, 160, True),
                                           (33, 32, False), (20, 161, False)])
def test_window_bwd_shape_guard(n, head_dim, ok):
    """The CUDA branch's limits (N <= 32, head dim <= 160) hold on any
    device; above them it raises a ValueError naming the limit, never
    falling back to the PyTorch backward."""
    if ok:
        K.check_window_bwd_shape(n, head_dim)
    else:
        with pytest.raises(ValueError, match="at most 32 tokens"):
            K.check_window_bwd_shape(n, head_dim)


def test_window_bwd_plan_spreads_and_sums_in_blocks():
    """Each warp walks windows of one (variant, head) in slices: the warps
    (slices x variants x heads) fill at most one wave of the card's resident
    warps unless one slice already does, cover every repeat of the variant
    once, and hold one d_addmask partial each.  On 132 SMs the Swin's stage
    1 at b64 (64 variants, 3 heads, eight warps an SM) walks 13 windows a
    warp, stage 4's bias alone (one variant, 24 heads, twelve warps an SM)
    3, and a slice is never longer than the variant's repeats."""
    assert K.window_bwd_plan(4096, 20, 64, 3, 132) == 13
    assert K.window_bwd_plan(192, 9, 1, 24, 132) == 3
    assert K.window_bwd_plan(64, 20, 64, 3, 132) == 1
    for nbw, n, nw, heads in ((4096, 20, 64, 3), (1024, 20, 16, 6),
                              (256, 20, 4, 12), (192, 9, 1, 24),
                              (2048, 20, 64, 3), (96, 9, 1, 24),
                              (15, 32, 1, 2), (5, 5, 1, 2)):
        per = K.window_bwd_plan(nbw, n, nw, heads, 132)
        reps = nbw // nw
        slices = -(-reps // per)
        assert 1 <= per <= reps and (slices - 1) * per < reps
        resident = K.WINDOW_BWD_WARPS[-(-n // 8)] * 132
        assert slices * nw * heads <= resident or slices == 1


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors go to the plain versions, bit for bit."""
    a, addmask, n, heads, scale = _inputs("stage1_mask_bias", seed=3)
    args = _port_args(a, addmask)
    for g, w in zip(K.window_attention_bwd(*args, heads, scale),
                    K.window_attention_bwd_plain(*args, heads, scale)):
        assert torch.equal(g, w)
    x, qkv_w, qkv_b, proj_w, am, g = args
    c = x.shape[-1]
    qkv = K.linear_plain(x.reshape(-1, c), qkv_w, qkv_b)
    do = g.reshape(-1, c) @ proj_w
    for got, want in zip(
            K.window_attention_bwd_core(qkv, do, am, n, heads, scale),
            K.window_attention_bwd_core_plain(qkv, do, am, n, heads, scale)):
        assert torch.equal(got, want)
