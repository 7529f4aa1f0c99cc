"""PyTorch port vs the JAX package on the MobileNetV2 U-Net
(``models/mobileunet.MobileUNet``): the bridge (bias-less and depthwise
kernels), the eval forward in f32 and bf16, the train-mode forward with
JAX's dropout masks, the loss (``pixelcnn``) and every gradient, and one
Trainer step (the dual-rate Adam: b1 0.5, the encoder at 0.1 of the lr, no
clip), on the same flax weights and numpy-seeded inputs.  The widths are
the architecture's; the frames are 64x32x15 (a 2x1 bottleneck) at batch
4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.data import labels as jlabels
from ultrasound_modeling_tpu.data import synthetic as jsynthetic
from ultrasound_modeling_tpu.models import common as jc
from ultrasound_modeling_tpu.models.mobileunet import MobileUNet as JaxMobileUNet
from ultrasound_modeling_tpu.train import losses as jlosses
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.config import default_config
from ultrasound_modeling_tpu_torch.data import labels
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.models.common import set_dropout_masks
from ultrasound_modeling_tpu_torch.models.mobileunet import MobileUNet
from ultrasound_modeling_tpu_torch.models.registry import build_model
from ultrasound_modeling_tpu_torch.train import losses
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge
from test_torch_unet_train import (
    check_grads, check_trainer_step, dropout_masks, first_trainer_steps,
    flax_variables, port64, port_model, to64, unet_cfg)

IMG = (64, 32)
BF16_Q = 2.0 ** -8     # one bf16 quantum, relative


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _batch():
    raw = jsynthetic.make_raw_array(4, 5, *IMG, 15)
    return raw[:, 0, :, :, 1:-1], raw[:, 0, :, :, 0]


@functools.lru_cache(maxsize=None)
def _flax():
    return flax_variables(JaxMobileUNet(), _batch()[0], 1)


def _port(**kw):
    return port_model(MobileUNet(in_channels=15, **kw), _flax()[1])


@functools.lru_cache(maxsize=None)
def _jax_eval(dtype="float32"):
    jc.set_compute_dtype(None if dtype == "float32" else dtype)
    try:
        out = jax.jit(JaxMobileUNet().apply, static_argnums=(2,))(
            _flax()[0], jnp.asarray(_batch()[0]), False)
        return np.asarray(out, np.float32)
    finally:
        jc.set_compute_dtype(None)


def test_mobileunet_bridge_round_trip_is_exact_and_covers_the_tree():
    """``to_flax(from_flax(p)) == p`` bit for bit over the whole flax tree;
    the convs but the stem and the head have no bias on either side; a
    depthwise kernel ``[3, 3, 1, ch]`` is ``[ch, 1, 3, 3]``; block 0 has no
    expand conv; the transposed kernels are flipped;
    ``random_flax_variables`` draws the same tree."""
    flat = _flax()[1]
    m = _port()
    assert set(bridge.to_flax(m.state_dict(), "mobileunet")) == set(flat)
    back = bridge.to_flax(bridge.from_flax(flat, "mobileunet"), "mobileunet")
    for k, a in flat.items():
        assert back[k].shape == a.shape and np.array_equal(back[k], a), k
    biases = sorted(k for k in flat if k.endswith("/bias")
                    and "BatchNorm_0" not in k)
    assert biases == ["params/decoder_head/bias", "params/encoder/conv1/bias"]
    dw = flat["params/encoder/block_3/depthwise/kernel"]
    assert dw.shape == (3, 3, 1, 144)
    sd = m.state_dict()
    assert np.array_equal(sd["encoder.block_3.depthwise.weight"].numpy(),
                          dw.transpose(3, 2, 0, 1))
    assert not any(k.startswith("params/encoder/block_0/expand") for k in flat)
    tk = flat["params/decoder_up_0/t_conv/kernel"]          # [3, 3, in, out]
    assert np.array_equal(sd["decoder_up_0.t_conv.weight"].numpy(),
                          tk[::-1, ::-1].transpose(2, 3, 0, 1))
    assert set(bridge.random_flax_variables(m, 3)) == set(flat)


def test_mobileunet_f32_eval_matches_flax():
    """Eval mode, probabilities atol 2e-5 (the symmetric stride-2 pads:
    flax's SAME would shift every map by a pixel)."""
    m = _port().eval()
    with torch.inference_mode():
        got = m(_t(_batch()[0])).numpy()
    want = _jax_eval()
    assert got.shape == want.shape == (4, 64, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_mobileunet_bf16_eval_matches_the_jax_bf16_forward():
    """bf16 compute on both sides against JAX's bf16 forward, 16 inverted
    residuals and four upsamples deep: the phase-3 bf16 gate of
    chip_smoke.py (max abs probability difference 0.05, argmax agreement
    0.99), and within 8 bf16 quanta of 1 on average.  JAX's softmax runs
    in bf16 and ties the top two probabilities at ~5% of these pixels (the
    random weights leave the classes near 1/3); the argmax agreement counts
    the pixels where JAX's argmax is defined."""
    m = _port(compute_dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        got = m(_t(_batch()[0])).numpy()
    want = _jax_eval("bfloat16")
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 0.05
    top2 = np.sort(want, -1)[..., -2:]
    defined = top2[..., 1] > top2[..., 0]
    assert defined.mean() > 0.9
    assert (got.argmax(-1) == want.argmax(-1))[defined].mean() >= 0.99
    assert np.abs(got - want).mean() <= 8 * BF16_Q


@functools.lru_cache(maxsize=None)
def _jax_train():
    """JAX in float64: (masks, train-mode probs, running statistics after
    the forward, loss, flat gradients), dropout key PRNGKey(6)."""
    jm = JaxMobileUNet()
    x, y = _batch()
    with jax.enable_x64(True):
        variables = to64(_flax()[0])
        key = jax.random.PRNGKey(6)
        masks, probs, stats = dropout_masks(jm, variables, x, key)

        def loss_of(params):
            p, _ = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x, jnp.float64), True,
                            mutable=["batch_stats"], rngs={"dropout": key})
            return jlosses.pixelcnn_loss(
                jlabels.label2vec(jnp.asarray(y, jnp.float64)), p)

        loss, grads = jax.jit(jax.value_and_grad(loss_of))(
            variables["params"])
        flat = {k: np.asarray(v, np.float32) for k, v in
                flatten_params({"params": grads}).items()}
    return masks, probs, stats, float(loss), flat


def test_mobileunet_train_forward_with_jax_dropout_masks():
    """Train mode (flax's fast-variance batch statistics) with the masks
    JAX's dropout drew on the first three upsamples, against JAX in
    float64: probabilities atol 2e-5, the running statistics after the
    forward rtol 1e-5, atol 1e-6."""
    masks, want, stats, _, _ = _jax_train()
    assert sorted(masks) == [f"decoder_up_{i}.Dropout_0" for i in range(3)]
    for keep in masks.values():
        assert 0.4 < keep.float().mean() < 0.6
    m = _port().train()
    set_dropout_masks(m, masks)
    with torch.no_grad():
        got = m(_t(_batch()[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    sd = bridge.to_flax(m.state_dict(), "mobileunet")
    for k, w in stats.items():
        np.testing.assert_allclose(sd[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_mobileunet_pixelcnn_loss_and_grads_match_jax():
    """pixelcnn (the family's default loss) rtol 1e-5 and every gradient
    leaf (``check_grads``: 1e-4 of the leaf's max, as
    tests/test_torch_train.py holds the TransUNet) against
    jax.value_and_grad, both in float64, under the same dropout masks
    (both frameworks' float32 gradients sit up to 9% of a leaf's max from
    float64 here: see tests/test_torch_unet_train.py); the port's float32
    loss rtol 1e-5."""
    masks, _, _, jl, want = _jax_train()
    x, y = _batch()
    m = _port().train()
    set_dropout_masks(m, masks)
    with torch.no_grad():
        l32 = losses.pixelcnn_loss(labels.label2vec(_t(y)), m(_t(x)))
    assert float(l32) == pytest.approx(jl, rel=1e-5)
    m = port64(_port().train())
    set_dropout_masks(m, masks)
    loss = losses.pixelcnn_loss(labels.label2vec(_t(y)), m(_t(x).double()))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jl, rel=1e-5)
    got = bridge.to_flax({n: p.grad for n, p in m.named_parameters()},
                         "mobileunet")
    check_grads(got, want, None)


def test_mobileunet_trainer_step_matches_the_jax_trainer():
    """One step of each package's Trainer for the default config at 64x32
    (augmentation off; pixelcnn, the dual-rate Adam, lr 2e-3) on the same
    weights, batch and dropout masks, both in float64: the loss rtol
    1e-5, the gradients, Adam's first moments, every parameter and the
    running statistics (``check_trainer_step``); Adam's first update is
    ~sign(g), so the encoder's largest move is 0.1 of the decoder's."""
    v, flat = _flax()
    x, y = _batch()
    before = {n: p.detach().clone() for n, p in _port().named_parameters()}
    new_state, jl, tr, loss = first_trainer_steps("mobileunet", IMG, v, flat,
                                                  x, y)
    opt = tr.state.opt
    assert opt.clip_norm is None and opt.b1 == 0.5 and tr.current_lr() == 2e-3
    assert loss == pytest.approx(jl, rel=1e-5)
    check_trainer_step(new_state, tr, 0.5, None)
    moved = {top: max(float((p.detach() - before[n]).abs().max())
                      for n, p in tr.model.named_parameters()
                      if (n.split(".")[0] == "encoder") == (top == "encoder"))
             for top in ("encoder", "decoder")}
    assert moved["encoder"] / moved["decoder"] == pytest.approx(0.1, rel=1e-3)


def test_mobileunet_trainer_fit_tiny_on_cpu():
    """Trainer.fit with augmentation and dropout drawn from the state's
    generator: two epochs end with finite metrics; the encoder, the
    decoder and the running statistics moved."""
    cfg = unet_cfg("mobileunet", IMG)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, augment=True),
        train=dataclasses.replace(cfg.train, eval_every_epochs=1))
    ds = Dataset.synthetic(n_train=6, n_test=4, height=64, width=32,
                           n_disp=15, device="cpu")
    trainer = Trainer(cfg, ds, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    summary = trainer.fit(2)
    assert trainer.state.step == 4 and np.isfinite(trainer.last_epoch["loss"])
    assert summary and all(np.isfinite(v) for v in summary.values())
    after = trainer.model.state_dict()
    for k in ("encoder.conv1.weight", "encoder.block_5.depthwise.weight",
              "encoder.block_1.expand_bn.BatchNorm_0.running_var",
              "decoder_up_0.bn.BatchNorm_0.running_mean",
              "decoder_head.weight"):
        assert not torch.equal(after[k], before[k]), k


def test_cli_builds_the_mobileunet():
    args = cli.make_parser().parse_args(
        ["train", "--model", "mobileunet", "--synthetic", "--epochs", "1"])
    cfg = cli.build_config(args)
    assert cfg.train.batch_size == 256 and cfg.train.loss == "pixelcnn"
    assert cfg.model.img_size == (256, 64) and cfg.model.in_channels == 15
    m = build_model(cfg.model)
    assert isinstance(m, MobileUNet) and m.family == "mobileunet"
    assert m.encoder.conv1.weight.shape == (32, 15, 3, 3)
    assert m.encoder.block_0.expand is None
    assert hasattr(m.encoder, "block_15") and not hasattr(m.encoder, "block_16")
    assert not hasattr(m, "decoder_up_4")       # only four upsamples run
    assert m.decoder_head.weight.shape == (224, 3, 3, 3)


def test_cli_mobileunet_refuses_cuda_without_a_card():
    """``cli train|serve --model mobileunet`` run on the card by default and
    raise without one (a test machine with a card skips this)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--model", "mobileunet", "--synthetic"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--model", "mobileunet", "--params", "p.npz"])


def test_serve_mobileunet_builds_from_npz(tmp_path):
    """``serve --model mobileunet`` builds the default-config model from a
    flax-layout npz through the bridge and answers 256x64x15 frames."""
    m = build_model(default_config("mobileunet").model)
    path = tmp_path / "m.npz"
    np.savez(path, **bridge.random_flax_variables(m, 1))
    model = cli.build_serving_model(str(path), True, torch.device("cpu"),
                                    "mobileunet")
    fwd = cli.make_forward(model, torch.device("cpu"))
    x = np.random.default_rng(0).standard_normal((2, 256, 64, 15))
    p = fwd(x.astype(np.float32))
    assert p.shape == (2, 256, 64, 3) and np.isfinite(p).all()
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)
