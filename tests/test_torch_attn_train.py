"""The port's K5 (``ops.kernels.attention_train_fused``) and K6
(``ops.kernels.label2vec_smooth``) against the JAX package's Pallas kernels
in interpret mode (as tests/test_pallas.py:14-43 and :397-445 run them), on
the same numpy-seeded inputs.  On the CPU the port's wrappers run their
plain versions; ``AttentionTrainFused``'s backward is the same PyTorch code
on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.ops import pallas_kernels as pk
from ultrasound_modeling_tpu_torch.ops import kernels as K

B, N, C, HEADS = 4, 16, 32, 4
SCALE = 1.0 / np.sqrt(HEADS)
NAMES = ("x", "qkv_w", "qkv_b", "proj_w", "proj_b")


def _inputs(seed=7):
    """test_pallas.py:407-414's draws, JAX layout (``qkv_w [C, 3C]``)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, C)).astype(np.float32),
            rng.normal(size=(C, 3 * C), scale=0.2).astype(np.float32),
            rng.normal(size=(3 * C,), scale=0.1).astype(np.float32),
            rng.normal(size=(C, C), scale=0.2).astype(np.float32),
            rng.normal(size=(C,), scale=0.1).astype(np.float32))


def _jax(args, dt, t):
    """JAX forward, saved (qkv, probs) and the gradients of sum(sin(out))
    w.r.t. the five inputs, all in ``dt`` (the Attention casts every
    parameter to the compute dtype)."""
    ja = [jnp.asarray(a, dt) for a in args]

    def fused(*a):
        return pk.attention_train_fused(*a, HEADS, scale=SCALE,
                                        seqs_per_step=t, interpret=True)

    out = fused(*ja)
    grads = jax.grad(lambda a: jnp.sum(jnp.sin(fused(*a).astype(jnp.float32))))(ja)
    tt = t or pk._pick_seqs_per_step(B, N, None)
    static = (HEADS, float(SCALE), tt * N, C, tt, N, True)
    x2 = ja[0].reshape(B * N, C)
    _, qkv_hm, probs = pk._attn_train_fwd_pallas(static, x2, *ja[1:])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(out), [f32(g) for g in grads], f32(qkv_hm), f32(probs), tt


def _port_args(args, dt):
    """The port's layout: x [B, N, C], weights ``[out, in]`` in ``dt``,
    biases float32 holding ``dt``'s values."""
    x, qkv_w, qkv_b, proj_w, proj_b = (torch.from_numpy(a) for a in args)
    return [x.to(dt).requires_grad_(), qkv_w.t().contiguous().to(dt).requires_grad_(),
            qkv_b.to(dt).float().requires_grad_(),
            proj_w.t().contiguous().to(dt).requires_grad_(),
            proj_b.to(dt).float().requires_grad_()]


def _port_grads(fn, targs):
    out = fn(*targs, HEADS, SCALE)
    torch.sin(out.float()).sum().backward()
    g = [a.grad.float().numpy() for a in targs]
    g[1], g[3] = g[1].T, g[3].T        # back to the JAX [in, out] layout
    return out.detach().float().numpy(), g


def _quanta(want, n):
    """n bf16 quanta (2^-8 relative) of max|want|."""
    return n * np.abs(want).max() / 256.0


def _autograd_plain(x, qkv_w, qkv_b, proj_w, proj_b, heads, scale):
    """Autograd through the plain forward: an independent check of
    AttentionTrainFused's hand-written backward."""
    b, n, c = x.shape
    out, _, _ = K.attention_train_fwd_plain(x.reshape(b * n, c), qkv_w, qkv_b,
                                            proj_w, proj_b, n, heads, scale)
    return out.view(b, n, c)


ROUTES = {"fused": K.attention_train_fused,
          "plain": K.attention_train_fused_plain, "autograd": _autograd_plain}


@pytest.mark.parametrize("t", [None, 2])
@pytest.mark.parametrize("route", list(ROUTES))
def test_k5_f32_forward_saved_and_grads_match_pallas(t, route):
    """f32: forward <= 2e-6 (test_pallas.py's bound); the saved qkv and P
    equal JAX's after undoing its head-major layouts (1e-6: the same sums
    in another order); the gradients to x and the four projections
    <= 1e-4.  'fused' and 'plain' run AttentionTrainFused's saving backward
    (behind the kernel's wrapper and its plain version), 'autograd' is
    autograd through the plain forward.  Both JAX packings, one sequence
    per grid step and two (t=2, the -1e9 block-diagonal mask)."""
    args = _inputs()
    jout, jgrads, qkv_hm, probs, tt = _jax(args, jnp.float32, t)
    targs = _port_args(args, torch.float32)
    out, grads = _port_grads(ROUTES[route], targs)
    np.testing.assert_allclose(out, jout, rtol=2e-6, atol=2e-6)
    for name, g, w in zip(NAMES, grads, jgrads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)

    x2, qkv_w, qkv_b, proj_w, proj_b = (a.detach() for a in targs)
    _, qkv, p = K.attention_train_fwd(x2.reshape(B * N, C), qkv_w, qkv_b,
                                      proj_w, proj_b, N, HEADS, SCALE)
    d = C // HEADS
    head_major = qkv.view(B * N, 3, HEADS, d).permute(2, 0, 1, 3).reshape(
        HEADS, B * N, 3 * d)
    np.testing.assert_allclose(head_major.numpy(), qkv_hm, rtol=1e-6, atol=1e-6)
    g = B // tt
    blocks = probs.reshape(g, HEADS, tt, N, tt, N)
    for j in range(tt):
        for i in range(tt):
            blk = blocks[:, :, i, :, j, :]
            if i != j:
                assert not blk.any()        # the mask's off-diagonal zeros
    diag = np.stack([blocks[:, :, i, :, i, :] for i in range(tt)], axis=1)
    np.testing.assert_allclose(p.numpy(), diag.reshape(B, HEADS, N, N),
                               rtol=1e-6, atol=1e-6)


def test_k5_bf16_matches_pallas_within_quanta():
    """bf16 (x, weights and biases bf16, as the JAX Attention casts them):
    both project the f32 context with f32 sums and round the output once,
    so the forward agrees within 1 bf16 quantum of max|out| (one rounding
    of values that agree to f32); saved qkv and P within 1 quantum of each's
    max (the same f32 values, rounded after sums in another order); every
    gradient within 8 quanta of its max (bf16 operands through two more
    products)."""
    args = _inputs(seed=11)
    jout, jgrads, qkv_hm, probs, tt = _jax(args, jnp.bfloat16, None)
    targs = _port_args(args, torch.bfloat16)
    out, grads = _port_grads(K.attention_train_fused, targs)
    assert np.abs(out - jout).max() <= _quanta(jout, 1)
    for name, g, w in zip(NAMES, grads, jgrads):
        assert np.abs(g - w).max() <= _quanta(w, 8), name
    x2, qkv_w, qkv_b, proj_w, proj_b = (a.detach() for a in targs)
    _, qkv, p = K.attention_train_fwd(x2.reshape(B * N, C), qkv_w, qkv_b,
                                      proj_w, proj_b, N, HEADS, SCALE)
    assert qkv.dtype == p.dtype == torch.bfloat16
    d = C // HEADS
    head_major = qkv.float().view(B * N, 3, HEADS, d).permute(2, 0, 1, 3)
    head_major = head_major.reshape(HEADS, B * N, 3 * d).numpy()
    assert np.abs(head_major - qkv_hm).max() <= _quanta(qkv_hm, 1)
    blocks = probs.reshape(B // tt, HEADS, tt, N, tt, N)
    diag = np.stack([blocks[:, :, i, :, i, :] for i in range(tt)], axis=1)
    assert np.abs(p.float().numpy() - diag.reshape(B, HEADS, N, N)).max() <= (
        _quanta(diag, 1))


def test_k5_bf16_projects_the_f32_context():
    """Under bf16 the plain forward's core returns the context in float32,
    and the output is exactly the f32 product of that context and the
    upcast projection weights, rounded once to bf16 (the reference's
    ``jnp.dot(ho, projw, preferred_element_type=f32)``, :294-308)."""
    x, qkv_w, qkv_b, proj_w, proj_b = (a.detach() for a in _port_args(
        _inputs(seed=3), torch.bfloat16))
    x2 = x.reshape(B * N, C)
    out, qkv, p = K.attention_train_fwd(x2, qkv_w, qkv_b, proj_w, proj_b, N,
                                        HEADS, SCALE)
    ctx, qkv_c, p_c = K.attention_train_core_plain(
        K.linear_plain(x2, qkv_w, qkv_b), N, HEADS, SCALE, torch.bfloat16)
    assert ctx.dtype == torch.float32
    assert qkv_c.dtype == p_c.dtype == out.dtype == torch.bfloat16
    want = K.linear_plain(ctx, proj_w.float(), proj_b,
                          out_dtype=torch.bfloat16)
    assert torch.equal(out, want)
    assert torch.equal(qkv, qkv_c) and torch.equal(p, p_c)


def test_k5_guards():
    """The port's guards (as K3's): heads divide C, seq and head dim
    <= 160, matching dtypes, contiguity."""
    x = torch.zeros(2 * 8, 12)
    w, b = torch.zeros(36, 12), torch.zeros(36)
    pw, pb = torch.zeros(12, 12), torch.zeros(12)
    with pytest.raises(ValueError, match="heads"):
        K.attention_train_fwd(x, w, b, pw, pb, 8, 5, 1.0)
    with pytest.raises(ValueError, match="seq <= 160"):
        K.attention_train_fwd(torch.zeros(161, 12), w, b, pw, pb, 161, 3, 1.0)
    with pytest.raises(TypeError):
        K.attention_train_fwd(x, w.to(torch.bfloat16), b, pw, pb, 8, 3, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        K.attention_train_fwd(x, w, b, pw.t(), pb, 8, 3, 1.0)
    with pytest.raises(ValueError, match="whole sequences"):
        K.attention_train_fwd(x, w, b, pw, pb, 5, 3, 1.0)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(3, 16, 8), (16, 8)])
def test_k6_matches_pallas_interpret(smoothing, shape):
    """Labels straddle 0.95 and 1.05 (and hit them).  Without smoothing
    exact (the same comparisons and one subtraction); with it within 1e-6
    (test_pallas.py's bound): XLA may fuse the smoothing's multiply-add,
    which rounds once where the port rounds twice (1 ulp)."""
    rng = np.random.default_rng(5)
    lab = rng.uniform(-0.1, 2.2, size=shape).astype(np.float32)
    lab.flat[:6] = [0.95, 1.05, 0.9499999, 1.0500001, 2.0, 0.0]
    want = np.asarray(pk.fused_label2vec_smooth(jnp.asarray(lab), smoothing,
                                                interpret=True))
    got = K.label2vec_smooth(torch.from_numpy(lab), smoothing).numpy()
    assert got.shape == want.shape == shape + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if smoothing else 0)
    with pytest.raises(TypeError):
        K.label2vec_smooth(torch.from_numpy(lab).double(), smoothing)
