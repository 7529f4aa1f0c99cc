"""PyTorch port vs the JAX package on the standalone ResNeSt U-Net
(``models/resnest.ResNeStUNet``): the bridge, the eval forward in f32 and
bf16, the train-mode forward with JAX's dropout masks, the loss
(``class_balanced``) and every gradient, and one Trainer step (no clip),
on the same flax weights and numpy-seeded inputs.  The widths are the
architecture's; the frames are 64x64x6 (six pools to 1x1) at batch 4, radix
2 and kpaths 2."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.data import labels as jlabels
from ultrasound_modeling_tpu.data import synthetic as jsynthetic
from ultrasound_modeling_tpu.models import common as jc
from ultrasound_modeling_tpu.models.resnest import ResNeStUNet as JaxResNeStUNet
from ultrasound_modeling_tpu.train import losses as jlosses
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.config import default_config
from ultrasound_modeling_tpu_torch.data import labels
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.models.common import set_dropout_masks
from ultrasound_modeling_tpu_torch.models.registry import build_model
from ultrasound_modeling_tpu_torch.models.resnest import ResidualS, ResNeStUNet
from ultrasound_modeling_tpu_torch.train import losses
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge
from test_torch_unet_train import (
    check_grads, check_trainer_step, dropout_masks, first_trainer_steps,
    flax_variables, port64, port_model, to64, unet_cfg)

SMALL = dict(radix=2, kpaths=2)
IMG = (64, 64)
BF16_Q = 2.0 ** -8     # one bf16 quantum, relative
# Leaves whose exact gradient is 0: a bias right before a train-mode
# BatchNorm (the batch mean removes it), the branch convs' and the
# attention's first dense bias included (their norms are per channel, the
# attention's over the batch)
ZERO_GRAD = re.compile(r"/(conv2_1_2|t_conv|shortcut_conv)/bias$"
                       r"|/(branch1|branch2|attn_dense1)_bias$")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _batch():
    raw = jsynthetic.make_raw_array(4, 3, *IMG, 6)
    return raw[:, 0, :, :, 1:-1], raw[:, 0, :, :, 0]


@functools.lru_cache(maxsize=None)
def _flax():
    return flax_variables(JaxResNeStUNet(**SMALL), _batch()[0], 0)


def _port(**kw):
    return port_model(ResNeStUNet(**SMALL, in_channels=6, **kw), _flax()[1])


@functools.lru_cache(maxsize=None)
def _jax_eval(dtype="float32"):
    jc.set_compute_dtype(None if dtype == "float32" else dtype)
    try:
        out = jax.jit(JaxResNeStUNet(**SMALL).apply, static_argnums=(2,))(
            _flax()[0], jnp.asarray(_batch()[0]), False)
        return np.asarray(out, np.float32)
    finally:
        jc.set_compute_dtype(None)


def test_resnest_unet_bridge_round_trip_is_exact_and_covers_the_tree():
    """``to_flax(from_flax(p)) == p`` bit for bit over the whole flax tree
    (params and the stages' ``{branch1,branch2,attn}_norm_{mean,var}``
    running statistics), the transposed kernels flipped, ``conv4_1``
    without a shortcut; ``random_flax_variables`` draws the same tree,
    its variances positive."""
    flat = _flax()[1]
    m = _port()
    assert set(bridge.to_flax(m.state_dict(), "resnest_unet")) == set(flat)
    back = bridge.to_flax(bridge.from_flax(flat, "resnest_unet"),
                          "resnest_unet")
    for k, a in flat.items():
        assert back[k].shape == a.shape and np.array_equal(back[k], a), k
    assert "params/conv4_1/shortcut_conv/kernel" not in flat
    assert "params/conv3_2/shortcut_conv/kernel" in flat
    assert flat["batch_stats/conv2_1/attn_norm_var"].shape == (2, 8)
    assert flat["batch_stats/conv2_1/branch2_norm_mean"].shape == (2, 2, 16)
    tk = flat["params/upsample_0/t_conv/kernel"]            # [4, 4, in, out]
    sd = m.state_dict()
    assert np.array_equal(sd["upsample_0.t_conv.weight"].numpy(),
                          tk[::-1, ::-1].transpose(2, 3, 0, 1))
    rand = bridge.random_flax_variables(m, 3)
    assert set(rand) == set(flat)
    assert all(rand[k].min() > 0 for k in rand if k.endswith("var"))


def test_resnest_unet_f32_eval_matches_flax():
    """Eval mode (running statistics everywhere), probabilities atol 2e-5."""
    m = _port().eval()
    with torch.inference_mode():
        got = m(_t(_batch()[0])).numpy()
    want = _jax_eval()
    assert got.shape == want.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_resnest_unet_bf16_eval_matches_the_jax_bf16_forward():
    """bf16 compute on both sides against JAX's bf16 forward: five
    split-attention stages and five upsamples deep, so the phase-3 bf16
    gate of chip_smoke.py (max abs probability difference 0.05, argmax
    agreement 0.99); the port's f32 softmax against JAX's bf16 one is
    within 8 bf16 quanta of 1 on average."""
    m = _port(compute_dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        got = m(_t(_batch()[0])).numpy()
    want = _jax_eval("bfloat16")
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 0.05
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    assert np.abs(got - want).mean() <= 8 * BF16_Q


@functools.lru_cache(maxsize=None)
def _jax_train():
    """JAX in float64 (the stages' branch norms keep their float32
    statistics, as JAX writes them): (masks, train-mode probs, running
    statistics after the forward, loss, flat gradients), dropout key
    PRNGKey(5)."""
    jm = JaxResNeStUNet(**SMALL)
    x, y = _batch()
    with jax.enable_x64(True):
        variables = to64(_flax()[0])
        key = jax.random.PRNGKey(5)
        masks, probs, stats = dropout_masks(jm, variables, x, key)

        def loss_of(params):
            p, _ = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x, jnp.float64), True,
                            mutable=["batch_stats"], rngs={"dropout": key})
            return jlosses.class_balanced(
                jlabels.label2vec(jnp.asarray(y, jnp.float64)), p)

        loss, grads = jax.jit(jax.value_and_grad(loss_of))(
            variables["params"])
        flat = {k: np.asarray(v, np.float32) for k, v in
                flatten_params({"params": grads}).items()}
    return masks, probs, stats, float(loss), flat


def test_resnest_unet_train_forward_with_jax_dropout_masks():
    """Train mode (batch statistics: flax's fast variance in the stem and
    the upsamples, the two-pass one in the stages' branch and attention
    norms) with the masks JAX's dropout drew, against JAX in float64:
    probabilities atol 2e-5, the running statistics after the forward rtol
    1e-5, atol 1e-6; about half of each map is dropped."""
    masks, want, stats, _, _ = _jax_train()
    assert sorted(masks) == ["upsample_0.Dropout_0", "upsample_1.Dropout_0",
                             "upsample_2.Dropout_0"]
    for keep in masks.values():
        assert 0.4 < keep.float().mean() < 0.6
    m = _port().train()
    set_dropout_masks(m, masks)
    with torch.no_grad():
        got = m(_t(_batch()[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    sd = bridge.to_flax(m.state_dict(), "resnest_unet")
    for k, w in stats.items():
        np.testing.assert_allclose(sd[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_resnest_unet_class_balanced_loss_and_grads_match_jax(dtype):
    """class_balanced (the family's default loss) rtol 1e-5 and every
    gradient leaf (``check_grads``: 1e-4 of the leaf's max, as
    tests/test_torch_train.py holds the TransUNet) against
    jax.value_and_grad in float64 under the same dropout masks, the port
    in float32 and in float64."""
    masks, _, _, jl, want = _jax_train()
    m = _port().train()
    if dtype == "float64":
        port64(m)
    set_dropout_masks(m, masks)
    x, y = _batch()
    loss = losses.class_balanced(labels.label2vec(_t(y)),
                                 m(_t(x).to(getattr(torch, dtype))))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jl, rel=1e-5)
    got = bridge.to_flax({n: p.grad for n, p in m.named_parameters()},
                         "resnest_unet")
    check_grads(got, want, ZERO_GRAD)


def test_resnest_unet_trainer_step_matches_the_jax_trainer():
    """One step of each package's Trainer for the default config at 64x64
    (augmentation off; class_balanced, no clipping, Adam b1 0.9, lr 5e-3)
    on the same weights, batch and dropout masks, both in float64: the
    loss rtol 1e-5, the gradients, Adam's first moments, every parameter
    and the running statistics (``check_trainer_step``)."""
    v, flat = _flax()
    x, y = _batch()
    new_state, jl, tr, loss = first_trainer_steps(
        "resnest_unet", IMG, v, flat, x, y, **SMALL)
    assert tr.state.opt.clip_norm is None and tr.current_lr() == 5e-3
    assert loss == pytest.approx(jl, rel=1e-5)
    check_trainer_step(new_state, tr, 0.9, ZERO_GRAD)


def test_residual_stage_keeps_the_transunet_layer_norm_stage():
    """The generalised stage's defaults are the TransUNet's: LayerNorm
    branches (K2 in train mode), LeakyReLU, the shortcut always projected,
    and no running statistics."""
    s = ResidualS(32, 64, 3, 2, 2)
    assert s.norm == "layer" and s.shortcut_conv is not None
    assert not [n for n, _ in s.named_buffers()]
    b = ResidualS(64, 64, 3, 2, 2, norm="batch", act="elu",
                  shortcut_always=False)
    assert b.shortcut_conv is None
    assert sorted(n for n, _ in b.named_buffers()) == [
        "attn_norm_mean", "attn_norm_var", "branch1_norm_mean",
        "branch1_norm_var", "branch2_norm_mean", "branch2_norm_var"]


def test_resnest_unet_trainer_fit_tiny_on_cpu():
    """Trainer.fit with augmentation and dropout drawn from the state's
    generator: two epochs end with finite metrics, the weights and every
    kind of running statistic moved."""
    cfg = unet_cfg("resnest_unet", IMG, **SMALL)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, augment=True),
        train=dataclasses.replace(cfg.train, eval_every_epochs=1))
    ds = Dataset.synthetic(n_train=6, n_test=4, height=64, width=64,
                           n_disp=6, device="cpu")
    trainer = Trainer(cfg, ds, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    summary = trainer.fit(2)
    assert trainer.state.step == 4 and np.isfinite(trainer.last_epoch["loss"])
    assert summary and all(np.isfinite(v) for v in summary.values())
    after = trainer.model.state_dict()
    for k in ("conv2_1_2bn.BatchNorm_0.running_var",
              "conv2_1.branch2_norm_var", "conv3_1.attn_norm_mean",
              "upsample_0.bn.BatchNorm_0.running_mean", "f_tran.weight"):
        assert not torch.equal(after[k], before[k]), k


def test_cli_builds_the_resnest_unet():
    args = cli.make_parser().parse_args(
        ["train", "--model", "resnest_unet", "--synthetic", "--bf16",
         "--epochs", "1"])
    cfg = cli.build_config(args)
    assert cfg.train.batch_size == 64 and cfg.train.loss == "class_balanced"
    assert cfg.model.img_size == (256, 64) and cfg.model.in_channels == 6
    m = build_model(cfg.model)
    assert isinstance(m, ResNeStUNet) and m.family == "resnest_unet"
    assert m.compute_dtype == torch.bfloat16
    assert m.conv1.weight.shape == (16, 6, 3, 3)
    assert m.conv4_1.shortcut_conv is None
    assert m.f_tran.weight.shape == (160, 3, 4, 4)


def test_cli_resnest_unet_refuses_cuda_without_a_card():
    """``cli train|serve --model resnest_unet`` run on the card by default and
    raise without one (a test machine with a card skips this)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--model", "resnest_unet", "--synthetic"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--model", "resnest_unet", "--params", "p.npz"])


def test_serve_resnest_unet_builds_from_npz(tmp_path):
    """``serve --model resnest_unet`` builds the default-config model from a
    flax-layout npz through the bridge and answers 256x64x6 frames."""
    m = build_model(default_config("resnest_unet").model)
    path = tmp_path / "r.npz"
    np.savez(path, **bridge.random_flax_variables(m, 1))
    model = cli.build_serving_model(str(path), False, torch.device("cpu"),
                                    "resnest_unet")
    fwd = cli.make_forward(model, torch.device("cpu"))
    x = np.random.default_rng(0).standard_normal((2, 256, 64, 6))
    p = fwd(x.astype(np.float32))
    assert p.shape == (2, 256, 64, 3) and np.isfinite(p).all()
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)
