"""The span ``attention.train`` of ``models.transunet.Attention`` (the
ViT's and the TransUNet's blocks): under a profiler, one record a block a
train step, nested in ``train.forward``, on each of the three train
routes (composed, K3 ``flash``, K5 ``pallas``; their plain versions run on
the CPU); none without a profiler; none in an eval forward of either
family.  The benchmark's ``attention_device_ms.train`` reads the kernels
launched under its range ``port::attention.train``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ultrasound_modeling_tpu_torch.models.transunet import TransUNet
from ultrasound_modeling_tpu_torch.models.vit import ViTSegmenter
from ultrasound_modeling_tpu_torch.train import losses, optim
from ultrasound_modeling_tpu_torch.train.step import TrainState, make_train_step
from ultrasound_modeling_tpu_torch.utils import tracing

torch.set_num_threads(2)

SPAN = "attention.train"
LAYERS = 2
VIT = dict(num_classes=3, hidden_size=32, num_heads=2, num_layers=LAYERS,
           grid=(4, 4), img_size=(32, 16), mlp_dim=64)
TRANSUNET = dict(num_classes=3, hidden_size=64, num_heads=4,
                 num_layers=LAYERS, mlp_dim=128, grid=(4, 5), radix=2,
                 kpaths=2)
FRAMES = {"vit": (32, 16), "transunet": (64, 80)}
ROUTES = ("composed", "flash", "pallas")


@pytest.fixture(autouse=True)
def empty_records():
    tracing.clear()
    yield
    tracing.clear()


def _model(family, **kw):
    torch.manual_seed(4)
    cls, tiny = {"vit": (ViTSegmenter, VIT),
                 "transunet": (TransUNet, TRANSUNET)}[family]
    return cls(**tiny, **kw)


def _frames(family, b=2):
    h, w = FRAMES[family]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(b, h, w, 10)).astype(np.float32)
    y = rng.choice([0.0, 0.5, 1.0, 1.3, 2.0], size=(b, h, w)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _steps(model, family, n):
    step = make_train_step(model, losses.cce_smooth, augment=True)
    state = TrainState(model, optim.Adam(model.parameters(), 1.0), 0,
                       torch.Generator().manual_seed(0),
                       torch.Generator().manual_seed(1))
    x, y = _frames(family)
    for _ in range(n):
        step(state, x, y, 1e-3)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family", ["vit", "transunet"])
def test_one_span_a_block_a_step_inside_the_forward(family, route):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(_model(family, attn_train_impl=route), family, 2)
    recs = tracing.records()
    forwards = [i for i, r in enumerate(recs) if r[0] == "train.forward"]
    spans = [r for r in recs if r[0] == SPAN]
    assert len(forwards) == 2 and len(spans) == 2 * LAYERS
    for f in forwards:
        inside = [r for r in spans if r[1] == f]
        assert len(inside) == LAYERS
        for _, _, start, end in inside:
            assert recs[f][2] <= start <= end <= recs[f][3]
    ranges = [e for e in prof.events() if e.name == tracing.PREFIX + SPAN]
    assert len(ranges) == 2 * LAYERS


@pytest.mark.parametrize("route", ROUTES)
def test_no_span_without_a_profiler(route):
    _steps(_model("vit", attn_train_impl=route), "vit", 1)
    assert tracing.records() == [] and tracing.dropped() == 0


@pytest.mark.parametrize("attn_impl, dtype", [
    ("kernel", torch.float32), ("composed", torch.float32),
    ("kernel", torch.bfloat16)])
@pytest.mark.parametrize("family", ["vit", "transunet"])
def test_an_eval_forward_opens_no_span(family, attn_impl, dtype):
    model = _model(family, attn_impl=attn_impl, attn_train_impl="flash",
                   compute_dtype=dtype).eval()
    x, _ = _frames(family)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        probs = model(x)
    assert probs.shape == (*x.shape[:3], 3)
    assert SPAN not in {r[0] for r in tracing.records()}
    assert not [e for e in prof.events()
                if e.name == tracing.PREFIX + SPAN]
