"""``ops.kernels.plain_versions()``: the one switch between the kernels and
their plain versions.  Spies on the kernels' autograd Functions and on the
``ultrasound_port`` ops show that a tiny TransUNet, ViT and Swin reach
them through the kernel entries, in eval and in train, and reach none of
them under the switch.  On CPU tensors the kernel route runs the kernels'
plain pieces, so both routes give the same probabilities to rounding."""

import pytest
import torch

from ultrasound_modeling_tpu_torch.models.swin import SwinSegmenter
from ultrasound_modeling_tpu_torch.models.transunet import TransUNet
from ultrasound_modeling_tpu_torch.models.vit import ViTSegmenter
from ultrasound_modeling_tpu_torch.ops import kernels as K
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge

FAMILIES = {
    "transunet": (lambda **kw: TransUNet(
        hidden_size=64, num_heads=4, num_layers=2, mlp_dim=128, grid=(4, 5),
        radix=2, kpaths=2, **kw), (64, 80)),
    "vit": (lambda **kw: ViTSegmenter(
        hidden_size=32, num_heads=4, num_layers=2, grid=(4, 5),
        img_size=(32, 20), mlp_dim=64, **kw), (32, 20)),
    "swin": (lambda **kw: SwinSegmenter(
        img_size=(32, 20), embed_dim=16, depths=(2, 2), num_heads=(2, 4),
        window=(2, 5), drop_path_rate=0.0), (32, 20)),
}
OPS = ("transformer_block", "window_attention", "group_flat_norm")
FUNCTIONS = (K.WindowAttentionFused, K.FlashMHA, K.GroupFlatNorm,
             K.AttentionTrainFused)
# (family, mode, compute dtype, attn_train_impl): what the kernel route
# reaches there
CASES = {
    ("transunet", "eval", "f32", None): {"window_attention",
                                         "group_flat_norm"},
    ("transunet", "eval", "bf16", None): {"transformer_block",
                                          "group_flat_norm"},
    ("transunet", "train", "f32", "flash"): {"FlashMHA", "GroupFlatNorm"},
    ("transunet", "train", "bf16", "pallas"): {"AttentionTrainFused",
                                               "GroupFlatNorm"},
    ("vit", "eval", "f32", None): {"window_attention"},
    ("vit", "eval", "bf16", None): {"transformer_block"},
    ("vit", "train", "f32", "flash"): {"FlashMHA"},
    ("vit", "train", "f32", "pallas"): {"AttentionTrainFused"},
    ("swin", "eval", "f32", None): {"window_attention"},
    ("swin", "train", "f32", None): {"WindowAttentionFused",
                                     "window_attention"},
}


@pytest.fixture
def calls(monkeypatch):
    """The names of the Functions applied and the ops called.  K5's plain
    version keeps AttentionTrainFused (its backward is PyTorch on both
    routes) with the plain forward, so that Function counts only with
    K5's kernel forward."""
    seen = []
    for fn in FUNCTIONS:
        def spy(*args, _apply=fn.apply, _name=fn.__name__):
            if args[-1] is not K.attention_train_fwd_plain:
                seen.append(_name)
            return _apply(*args)
        monkeypatch.setattr(fn, "apply", spy)
    for name in OPS:
        packet = getattr(torch.ops.ultrasound_port, name)

        def op_spy(*args, _op=packet.default, _name=name):
            seen.append(_name)
            return _op(*args)
        monkeypatch.setattr(packet, "default", op_spy)
    return seen


def _run(case, plain):
    family, mode, dtype, attn_train = case
    build, (h, w) = FAMILIES[family]
    kw = {} if family == "swin" else dict(
        attn_train_impl=attn_train or "composed",
        compute_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    model = build(num_classes=3, **kw)
    model.load_state_dict(bridge.from_flax(
        bridge.random_flax_variables(model, seed=1), model.family),
        strict=True)
    x = torch.randn(2, h, w, 10, generator=torch.Generator().manual_seed(2))
    with K.plain_versions(plain):
        if mode == "eval":
            with torch.no_grad():
                return model.eval()(x)
        out = model.train()(x)
        out.square().sum().backward()
    return out.detach()


@pytest.mark.parametrize("case", list(CASES),
                         ids=lambda c: "-".join(filter(None, c)))
def test_kernel_entries_reach_the_kernels_only_outside_the_switch(calls,
                                                                   case):
    out = _run(case, plain=False)
    reached = set(calls)
    calls.clear()
    plain = _run(case, plain=True)
    assert reached == CASES[case]
    assert calls == []
    tol = 1e-2 if case[2] == "bf16" else 1e-5
    assert (out - plain).abs().max().item() <= tol
