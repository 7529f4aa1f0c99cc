"""``models.common.conv_norm``: a conv feeding an eval BatchNorm runs as one
conv with the norm folded into its weight and bias; in train mode, and
before a LayerNorm, it is the conv, then the norm.  Each conv form the
models pair with a BatchNorm, held against ``norm(conv(x))`` in float64,
float32 and bfloat16; the fold counter over whole eval and train
forwards."""

import pytest
import torch

from ultrasound_modeling_tpu_torch.models import common
from ultrasound_modeling_tpu_torch.models.common import (
    BatchNorm, Conv, ConvTranspose, Norm, conv_norm)
from ultrasound_modeling_tpu_torch.models.mobileunet import (
    SYMMETRIC_PAD, MobileUNet)
from ultrasound_modeling_tpu_torch.models.resnest import ResNeStUNet
from ultrasound_modeling_tpu_torch.models.transunet import TransUNet
from test_torch_evaluate import two_threads  # noqa: F401  (autouse)

BF = torch.bfloat16

# (name, conv factory, input channels): the forms the port's models pair
# with a BatchNorm
FORMS = [
    ("1x1", lambda: Conv(12, 8, 1), 12),                     # decoder branch 0
    ("3x3", lambda: Conv(12, 8, 3), 12),                     # stems
    ("3x3_d2", lambda: Conv(12, 8, 3, 2), 12),               # decoder branches
    ("3x3_d4", lambda: Conv(12, 8, 3, 4), 12),
    ("3x3_d8", lambda: Conv(12, 8, 3, 8), 12),
    ("1x1_nobias", lambda: Conv(12, 24, 1, use_bias=False), 12),  # expand
    ("depthwise", lambda: Conv(12, 12, 3, groups=12, use_bias=False), 12),
    ("depthwise_s2", lambda: Conv(12, 12, 3, stride=2, padding=SYMMETRIC_PAD,
                                  groups=12, use_bias=False), 12),
    ("t_k4s2", lambda: ConvTranspose(12, 8, 4, 2), 12),      # ResNeStUNet
    ("t_k3s2_nobias", lambda: ConvTranspose(12, 8, 3, 2, use_bias=False), 12),
]


def _pair(make, seed, dtype):
    """A seeded conv and an eval ``Norm("batch")`` with gamma, beta and
    running statistics far from their defaults."""
    g = torch.Generator().manual_seed(seed)
    conv = make()
    cout = conv.weight.shape[conv.OUT_AXIS]
    norm = Norm("batch", cout)
    bn = norm.BatchNorm_0
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.3)
        if conv.bias is not None:
            conv.bias.copy_(torch.randn(cout, generator=g) * 0.5)
        bn.weight.copy_(1 + 0.5 * torch.randn(cout, generator=g))
        bn.bias.copy_(0.5 * torch.randn(cout, generator=g))
        bn.running_mean.copy_(torch.randn(cout, generator=g))
        bn.running_var.copy_(0.2 + 1.8 * torch.rand(cout, generator=g))
    return conv.to(dtype).eval(), norm.to(dtype).eval(), g


def _x(g, cin, dtype):
    return (torch.randn(2, 16, 10, cin, generator=g) * 1.5).to(dtype)


@pytest.mark.parametrize("form,make,cin", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_fold_matches_conv_then_norm(form, make, cin, dtype, tol):
    """float64 within 1e-12 and float32 within 1e-5 of max|norm(conv(x))|;
    one folded pair counted, and the norm's forward never runs."""
    conv, norm, g = _pair(make, len(form), dtype)
    x = _x(g, cin, dtype)
    with torch.no_grad():
        want = norm(conv(x))
        common.reset_fold_counts()
        calls = []
        norm.BatchNorm_0.register_forward_hook(lambda *a: calls.append(a))
        got = conv_norm(conv, norm, x)
    assert common.FOLDS == {"conv_norm": 1, "separate": 0}
    assert not calls
    assert got.dtype == dtype and got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("form,make,cin", FORMS, ids=[f[0] for f in FORMS])
def test_fold_in_bf16_is_within_its_roundings(form, make, cin):
    """bf16 (float32 parameters, bf16 activations, as the models serve):
    against the exact float64 composition on the same bf16 input, each
    element within 2^-8 of |W'| * |x| + |b'| + |y|, twice the bf16
    roundings of W' = W a, of b' and of the output."""
    conv, norm, g = _pair(make, len(form), torch.float32)
    x = _x(g, cin, torch.float32).to(BF)
    c64, n64, _ = _pair(make, len(form), torch.float64)
    bn = n64.BatchNorm_0
    with torch.no_grad():
        exact = n64(c64(x.double()))
        a = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        shape = [1] * c64.weight.dim()
        shape[c64.OUT_AXIS] = -1
        w_abs = (c64.weight * a.reshape(shape)).abs()
        b = 0.0 if c64.bias is None else c64.bias
        shift = (b - bn.running_mean) * a + bn.bias
        scale = c64.run(x.double().abs(), w_abs, None) + shift.abs() + exact.abs()
        got = conv_norm(conv, norm, x)
    assert got.dtype == BF
    assert ((got.double() - exact).abs() <= 2.0 ** -8 * scale).all()


@pytest.mark.parametrize("form,make,cin", FORMS, ids=[f[0] for f in FORMS])
def test_train_mode_runs_conv_then_norm(form, make, cin):
    """A train-mode BatchNorm is not folded: the same output and the same
    running-statistic update as the conv, then the norm, bit for bit, and
    the pair counted as separate."""
    conv, norm, g = _pair(make, len(form), torch.float32)
    ref_conv, ref_norm, _ = _pair(make, len(form), torch.float32)
    for m in (conv, norm, ref_conv, ref_norm):
        m.train()
    x = _x(g, cin, torch.float32)
    before = norm.BatchNorm_0.running_var.clone()
    common.reset_fold_counts()
    got = conv_norm(conv, norm, x)
    assert common.FOLDS == {"conv_norm": 0, "separate": 1}
    assert torch.equal(got, ref_norm(ref_conv(x)))
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(norm.BatchNorm_0, name),
                           getattr(ref_norm.BatchNorm_0, name))
    assert not torch.equal(norm.BatchNorm_0.running_var, before)


def test_layer_norm_pair_is_conv_then_norm_uncounted():
    """Before a LayerNorm (the TransUNet's stage shortcuts) the helper is
    the conv, then the norm, bit for bit, in neither count."""
    g = torch.Generator().manual_seed(3)
    conv, norm = Conv(12, 8, 1), Norm("layer", 8)
    with torch.no_grad():
        for p in (*conv.parameters(), *norm.parameters()):
            p.copy_(torch.randn(p.shape, generator=g))
    x = _x(g, 12, torch.float32)
    common.reset_fold_counts()
    with torch.no_grad():
        assert torch.equal(conv_norm(conv, norm, x), norm(conv(x)))
    assert common.FOLDS == {"conv_norm": 0, "separate": 0}


class _Pair(torch.nn.Module):
    def __init__(self, make):
        super().__init__()
        self.conv, self.norm, _ = _pair(make, 5, torch.float32)

    def forward(self, x):
        return conv_norm(self.conv, self.norm, x)


def test_fold_reads_substituted_weights():
    """The fold is taken on every call from the weights the module holds
    then: under ``functional_call`` (int8 serving's dequantized weights)
    it uses the substituted conv weight and norm statistics."""
    m = _Pair(FORMS[1][1]).eval()
    g = torch.Generator().manual_seed(8)
    x = _x(g, 12, torch.float32)
    sub = {"conv.weight": torch.randn(m.conv.weight.shape, generator=g),
           "norm.BatchNorm_0.running_mean": torch.randn(8, generator=g)}
    with torch.no_grad():
        first = m(x)
        got = torch.func.functional_call(m, sub, (x,))
        c, n = _pair(FORMS[1][1], 5, torch.float32)[:2]
        c.weight.copy_(sub["conv.weight"])
        n.BatchNorm_0.running_mean.copy_(sub["norm.BatchNorm_0.running_mean"])
        want = n(c(x))
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert not torch.allclose(got, first)
    assert torch.equal(m(x), first)


def _tiny(family):
    if family == "transunet":
        return TransUNet(num_classes=3, hidden_size=64, num_heads=4,
                         num_layers=2, mlp_dim=128, grid=(4, 5), radix=2,
                         kpaths=2), (64, 80, 10)
    if family == "resnest_unet":
        return ResNeStUNet(radix=2, kpaths=2), (64, 64, 6)
    return MobileUNet(), (32, 32, 15)


@pytest.mark.parametrize("family,pairs", [("transunet", 26),
                                          ("resnest_unet", 10),
                                          ("mobileunet", 35)])
def test_every_batch_norm_folds_in_eval(family, pairs, monkeypatch):
    """A bf16 eval forward at b2 folds every conv -> BatchNorm pair (the
    TransUNet's 2 stem and 24 decoder pairs) and runs no BatchNorm
    forward; a train-mode forward folds none."""
    model, (h, w, c) = _tiny(family)
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == pairs
    model.compute_dtype = BF
    calls = []
    orig = BatchNorm.forward
    monkeypatch.setattr(BatchNorm, "forward",
                        lambda self, x: calls.append(self.training)
                        or orig(self, x))
    x = torch.randn(2, h, w, c, generator=torch.Generator().manual_seed(1))
    common.reset_fold_counts()
    with torch.inference_mode():
        model.eval()(x)
    assert common.FOLDS == {"conv_norm": pairs, "separate": 0}
    assert calls == []
    common.reset_fold_counts()
    with torch.no_grad():
        if family != "transunet":
            common.set_dropout_generator(model, torch.Generator())
        model.train()(x)
    assert common.FOLDS == {"conv_norm": 0, "separate": pairs}
    assert calls == [True] * pairs
