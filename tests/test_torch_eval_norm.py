"""The split-attention branches' eval LayerNorm + LeakyReLU on K2's forward
(``ops.kernels.group_flat_norm_eval``, the op
``ultrasound_port::group_flat_norm``): on CPU tensors the op is K2's plain
forward, which these tests hold against the formula the eval norm was
written as before (PyTorch ops in y's dtype, then LeakyReLU), kept here.
The kernel itself is checked on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu_torch.infer import export as ex
from ultrasound_modeling_tpu_torch.models.common import (
    KERAS_LN_EPS, LEAKY_ALPHA, leaky)
from ultrasound_modeling_tpu_torch.models.resnest import ResidualS
from ultrasound_modeling_tpu_torch.ops import kernels as K
from test_torch_evaluate import (  # noqa: F401  (two_threads: autouse)
    H, W, frames, model_cfgs, port_model, two_threads)

BF = torch.bfloat16
OP = "ultrasound_port.group_flat_norm.default"
# (F, gsize) of branch1 and branch2 at the flagship's four stages
FLAGSHIP = [(27, 3), (90, 10), (63, 7), (189, 21), (126, 14), (378, 42),
            (252, 28), (765, 85)]
# the flagship stages' (c11, ckk): branch1 is 9 groups of c11, branch2 9 of ckk
STAGES = [(3, 10), (7, 21), (14, 42), (28, 85)]


def _old_group_norm(y, scale, bias, gsize):
    """The eval branch norm as PyTorch ops, the float32 result cast to y's
    dtype before the LeakyReLU."""
    shape = y.shape
    yg = y.float().reshape(*shape[:-1], shape[-1] // gsize, gsize)
    mu = yg.mean(-1, keepdim=True)
    zc = yg - mu
    var = (zc * zc).mean(-1, keepdim=True)
    out = (zc * torch.rsqrt(var + KERAS_LN_EPS)).reshape(shape)
    return leaky((out * scale.reshape(-1) + bias.reshape(-1)).to(y.dtype))


def _old_eval_norm(y, scale, bias, gsize, eps, act, act_alpha):
    assert (eps, act, act_alpha) == (KERAS_LN_EPS, "leaky", LEAKY_ALPHA)
    return _old_group_norm(y, scale, bias, gsize)


def _stage(c11, ckk, seed=0):
    """An eval-mode ResidualS (LayerNorm, LeakyReLU) of the flagship's
    branch widths, seeded weights, norm scales near 1."""
    card = 3 * ckk
    stage = ResidualS(10, 2 * card, 3, 3, 3)
    assert (stage.c11, stage.ckk) == (c11, ckk)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in stage.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3
                    + (1.0 if name.endswith("norm_scale") else 0.0))
    return stage.eval()


def _quantum(t):
    """The bf16 spacing at each value of ``t``."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("f,gsize", FLAGSHIP)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_op_cpu_impl_is_the_plain_forward(f, gsize, dtype):
    """The op's CPU implementation is group_flat_norm_fwd_plain, bit for
    bit, with and without the folded LeakyReLU; the wrapper takes y of any
    leading shape."""
    g = torch.Generator().manual_seed(f)
    y = (torch.randn(6, f, generator=g) * 2 + 0.5).to(dtype)
    s = 1 + 0.1 * torch.randn(f, generator=g)
    b = 0.1 * torch.randn(f, generator=g)
    op = torch.ops.ultrasound_port.group_flat_norm.default
    for alpha in (None, LEAKY_ALPHA):
        want = K.group_flat_norm_fwd_plain(y, s, b, gsize, KERAS_LN_EPS, alpha)
        got = op(y, s, b, gsize, KERAS_LN_EPS, alpha)
        assert got.dtype == dtype and torch.equal(got, want)
    got = K.group_flat_norm_eval(y.view(2, 3, 1, f), s.view(9, -1), b, gsize,
                                 KERAS_LN_EPS, act="leaky",
                                 act_alpha=LEAKY_ALPHA)
    assert got.shape == (2, 3, 1, f) and torch.equal(got.view(6, f), want)


@pytest.mark.parametrize("c11,ckk", STAGES)
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_eval_branch_norm_matches_the_old_formula(c11, ckk, dtype):
    """Both branch norms of an eval ResidualS against the old formula: in
    float32 within 1e-6, in bfloat16 within one bf16 quantum of each value
    (the LeakyReLU now runs before the cast to bf16, not after it)."""
    stage = _stage(c11, ckk)
    g = torch.Generator().manual_seed(c11)
    for name, gsize in (("branch1_norm", c11), ("branch2_norm", ckk)):
        y = (torch.randn(2, 8, 5, 9 * gsize, generator=g) * 2 + 0.5).to(dtype)
        got = stage._branch_norm(y, name, gsize)
        want = _old_group_norm(y, getattr(stage, f"{name}_scale"),
                               getattr(stage, f"{name}_bias"), gsize)
        assert got.dtype == dtype and got.shape == y.shape
        diff = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 1e-6
        else:
            tol = torch.maximum(_quantum(got), _quantum(want))
            assert (diff <= tol).all(), diff.max().item()


def test_eval_stage_forward_matches_the_old_formula(monkeypatch):
    """A float32 eval ResidualS runs the op twice (both branches), copies no
    layout, and its output is the old formula's within 1e-6."""
    stage = _stage(7, 21)
    x = torch.randn(2, 8, 5, 10, generator=torch.Generator().manual_seed(3))
    calls = []
    op = K._forward_op

    def spy(name, *args):
        calls.append(name)
        return op(name, *args)

    monkeypatch.setattr(K, "_forward_op", spy)
    K.reset_launch_counts()
    with torch.no_grad():
        got = stage(x)
    assert calls == ["group_flat_norm"] * 2
    assert K.LAYOUT_COPIES["group_flat_norm"] == 0
    monkeypatch.setattr(K, "group_flat_norm_eval", _old_eval_norm)
    with torch.no_grad():
        want = stage(x)
    assert (got - want).abs().max().item() <= 1e-6


def test_eval_norm_copies_a_strided_input_once():
    """A non-contiguous y is copied into the kernel's layout once, counted."""
    g = torch.Generator().manual_seed(4)
    y = torch.randn(90, 12, generator=g).t()
    s, b = torch.ones(90), torch.zeros(90)
    K.reset_launch_counts()
    got = K.group_flat_norm_eval(y, s, b, 10, KERAS_LN_EPS, act="leaky")
    assert K.LAYOUT_COPIES["group_flat_norm"] == 1
    assert torch.equal(got, K.group_flat_norm_fwd_plain(
        y.contiguous(), s, b, 10, KERAS_LN_EPS, 0.3))


def test_backward_through_the_eval_norm_raises(monkeypatch):
    """The op has no gradient (a backward through it raises), so where a
    gradient is taken an eval stage's branch norms run GroupFlatNorm
    instead: the output is the no-gradient forward's, and the gradients of
    x and of every parameter are the train-mode stage's, bit for bit."""
    stage = _stage(3, 10)
    applied = []
    apply = K.GroupFlatNorm.apply

    def spy(*args):
        applied.append(args[3])
        return apply(*args)

    monkeypatch.setattr(K.GroupFlatNorm, "apply", spy)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 5, 10, generator=g).requires_grad_()
    params = [x, *stage.parameters()]
    out = stage(x)
    assert applied == [3, 10]
    cot = torch.randn(out.shape, generator=g)
    grads = torch.autograd.grad((out * cot).sum(), params)
    with torch.no_grad():
        assert torch.equal(out.detach(), stage(x))
    train_out = stage.train()(x)
    assert torch.equal(out, train_out)
    want = torch.autograd.grad((train_out * cot).sum(), params)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    y = torch.randn(4, 27, generator=g).requires_grad_()
    out = K.group_flat_norm_eval(y, stage.branch1_norm_scale,
                                 stage.branch1_norm_bias, 3, KERAS_LN_EPS,
                                 act="leaky", act_alpha=LEAKY_ALPHA)
    with pytest.raises(RuntimeError, match="group_flat_norm is a forward op"):
        out.sum().backward()


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_train_mode_keeps_its_route(monkeypatch, route):
    """Train mode runs GroupFlatNorm (the kernel route) or, under
    kernels.plain_versions(), the plain version, never the forward op: the
    output and the gradients of y, scale and bias are those of the route's
    own function, bit for bit."""
    stage = _stage(7, 21).train()
    applied = []
    apply = K.GroupFlatNorm.apply

    def spy(*args):
        applied.append(args[3])
        return apply(*args)

    monkeypatch.setattr(K.GroupFlatNorm, "apply", spy)
    monkeypatch.setattr(K, "group_flat_norm_eval", None)
    g = torch.Generator().manual_seed(6)
    y = (torch.randn(2, 8, 5, 189, generator=g) * 2).requires_grad_()
    cot = torch.randn(y.shape, generator=g)
    with K.plain_versions(route == "plain"):
        out = stage._branch_norm(y, "branch2_norm", 21)
        grads = torch.autograd.grad((out * cot).sum(), (
            y, stage.branch2_norm_scale, stage.branch2_norm_bias))
    assert applied == ([21] if route == "kernel" else [])
    fn = K.group_flat_norm if route == "kernel" else K.group_flat_norm_plain
    want = fn(y, stage.branch2_norm_scale, stage.branch2_norm_bias, 21,
              KERAS_LN_EPS, act="leaky", act_alpha=LEAKY_ALPHA)
    wgrads = torch.autograd.grad((want * cot).sum(), (
        y, stage.branch2_norm_scale, stage.branch2_norm_bias))
    assert torch.equal(out, want)
    for a, b in zip(grads, wgrads):
        assert torch.equal(a, b)


def test_bf16_export_holds_two_norm_ops_a_stage(tmp_path):
    """The bf16 tiny TransUNet's exported program calls the op for both
    branch norms of each of its split-attention stages, and the loaded
    artifact equals the eager bf16 forward."""
    model = port_model(compute_dtype="bfloat16")
    _, mcfg = model_cfgs(compute_dtype="bfloat16")
    stages = sum(isinstance(m, ResidualS) for m in model.modules())
    assert stages == 4
    exported = ex.export_forward(mcfg, model, (H, W, 10), batch=2)
    assert sum(str(n.target) == OP for n in exported.graph.nodes) == 2 * stages
    path = str(tmp_path / "bf16.pt2")
    ex.save_exported(exported, path)
    fn = ex.load_exported(path, torch.device("cpu"))
    x = torch.from_numpy(frames(2, seed=21))
    with torch.no_grad():
        want = model(x)
    np.testing.assert_allclose(fn(x).numpy(), want.numpy(), rtol=0, atol=1e-6)
