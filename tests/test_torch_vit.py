"""PyTorch port vs the JAX package: the ViT family (``models/vit.py``) at
the tiny config of tests/test_pallas.py:453-454 (hidden 32, 4 heads, 2
layers, grid (4, 5), image 32x20, MLP 64) on the same weights and inputs —
the bridge, the eval forward on every route, train-mode loss and gradients
with the L2 kernel penalty on the three train attentions, one full step,
the Trainer and the cli; plus the building blocks the ViT added to
``models/common.py`` (strided and VALID convs, LeakyReLU's slope).

One flax init per variant serves the module; zero-initialized biases and
position embeddings are redrawn so that every leaf matters.  JAX runs its
Pallas kernels in interpret mode, the port its plain versions (CPU
tensors)."""

import dataclasses
import functools
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.config import default_config
from ultrasound_modeling_tpu.data import labels as jlabels
from ultrasound_modeling_tpu.models import common as jc
from ultrasound_modeling_tpu.models.vit import ViTSegmenter as JaxViT
from ultrasound_modeling_tpu.train import losses as jlosses
from ultrasound_modeling_tpu.train import optim as joptim
from ultrasound_modeling_tpu.train import step as jstep
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.data import labels
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.models import common as tc
from ultrasound_modeling_tpu_torch.models.registry import build_model
from ultrasound_modeling_tpu_torch.models.vit import ViTSegmenter
from ultrasound_modeling_tpu_torch.ops import kernels as K
from ultrasound_modeling_tpu_torch.train import losses, optim
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.train.step import TrainState, make_train_step
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge

TINY = dict(num_classes=3, hidden_size=32, num_heads=4, num_layers=2,
            grid=(4, 5), img_size=(32, 20), mlp_dim=64)
VARIANTS = {"base": {}, "learned_pos": {"learned_pos": True},
            "conv_stem": {"conv_stem": True}}
L2 = 1e-2        # large enough that the penalty shows in every kernel's grad
# the attention's key bias has an exactly-zero gradient (the row softmax
# ignores it): both frameworks return rounding noise there
ZERO_GRAD = re.compile(r"attn/key_bias$")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 32, 20, 10)).astype(np.float32)
    y = rng.choice([0.0, 0.5, 0.96, 1.0, 1.04, 1.3, 2.0],
                   size=(2, 32, 20)).astype(np.float32)
    return x, y


@functools.lru_cache(maxsize=None)
def _flax(variant):
    """(nested params, flat npz-layout dict) of the variant: flax init
    PRNGKey(4), then biases and position embeddings redrawn (seed 9)."""
    x = np.zeros((2, 32, 20, 10), np.float32)
    params = jax.jit(JaxViT(**TINY, **VARIANTS[variant]).init,
                     static_argnums=(2,))(
        {"params": jax.random.PRNGKey(4)}, jnp.asarray(x), False)["params"]
    rng = np.random.default_rng(9)

    def redraw(path, a):
        name = str(path[-1].key)
        if name.endswith("bias") or name == "position_embeddings":
            return jnp.asarray(rng.normal(size=a.shape, scale=0.1), a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(redraw, params)
    flat = {k: np.asarray(v) for k, v in flatten_params({"params": params}).items()}
    return params, flat


def _port(variant, **kw):
    m = ViTSegmenter(**TINY, **VARIANTS[variant], **kw)
    m.load_state_dict(bridge.from_flax(_flax(variant)[1], "vit"), strict=True)
    return m


# ---------------------------------------------------------------------------
# the weight bridge (repair: the ViT's `head` is a plain conv)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_vit_bridge_round_trip_is_exact(variant):
    """npz -> state_dict -> npz is exact and loads strictly into the
    port's tree; ``head`` maps as a plain conv (HWIO -> OIHW), where the
    TransUNet's ``head`` is a transposed conv."""
    _, flat = _flax(variant)
    sd = bridge.from_flax(flat, "vit")
    assert set(sd) == set(ViTSegmenter(**TINY, **VARIANTS[variant]).state_dict())
    head = flat["params/head/kernel"]
    assert head.shape == (3, 3, 1, 3)
    assert np.array_equal(sd["head.weight"].numpy(), head.transpose(3, 2, 0, 1))
    back = bridge.to_flax(sd, "vit")
    assert set(back) == set(flat)
    for k, a in flat.items():
        assert back[k].shape == a.shape and np.array_equal(back[k], a), k
    ct = bridge.from_flax({"params/decoder/head/kernel": head})
    assert ct["decoder.head.weight"].shape == (1, 3, 3, 3)   # [in, out, kh, kw]
    with pytest.raises(ValueError, match="family"):
        bridge.from_flax(flat, "ksac_unet")


def test_vit_random_flax_variables_cover_the_tree():
    m = ViTSegmenter(**TINY, learned_pos=True, conv_stem=True)
    flat = bridge.random_flax_variables(m, seed=3)
    assert set(flat) == set(_flax("learned_pos")[1]) | set(_flax("conv_stem")[1])
    m.load_state_dict(bridge.from_flax(flat, "vit"), strict=True)


# ---------------------------------------------------------------------------
# eval forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("attn_impl", ["composed", "plain", "kernel"])
def test_vit_f32_eval_matches_flax(batch, variant, attn_impl):
    """f32 eval probabilities against flax (its composed 'xla' path) within
    1e-5; 'kernel' runs K4 in every Attention (its plain version here),
    'plain' the kernel route under kernels.plain_versions()."""
    x, _ = batch
    params, _ = _flax(variant)
    want = np.asarray(JaxViT(**TINY, **VARIANTS[variant]).apply(
        {"params": params}, jnp.asarray(x), False))
    impl = "composed" if attn_impl == "composed" else "kernel"
    with torch.inference_mode(), K.plain_versions(attn_impl == "plain"):
        got = _port(variant, attn_impl=impl).eval()(_t(x))
    assert got.shape == (2, 32, 20, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_vit_bf16_eval_matches_jax_fused_stack(batch):
    """bf16: the K1 stack with encoder_norm folded (plain version) against
    the JAX bf16 forward through transformer_block_fused in interpret mode:
    max abs probability difference <= 0.02 (as the TransUNet's)."""
    x, _ = batch
    params, _ = _flax("base")
    jc.set_compute_dtype("bfloat16")
    try:
        want = np.asarray(JaxViT(**TINY, attn_impl="pallas").apply(
            {"params": params}, jnp.asarray(x), False), np.float32)
    finally:
        jc.set_compute_dtype(None)
    with torch.inference_mode():
        m = _port("base", compute_dtype=torch.bfloat16).eval()
        got = m(_t(x))
        with K.plain_versions():
            plain = m(_t(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, plain)
    assert np.abs(got.numpy() - want).max() <= 0.02


# ---------------------------------------------------------------------------
# train mode: loss and every gradient, with the L2 penalty
# ---------------------------------------------------------------------------

def _jax_value_and_grad(variant, x, y, impl):
    params, _ = _flax(variant)
    model = JaxViT(**TINY, **VARIANTS[variant], attn_train_impl=impl)

    def loss_of(p):
        probs = model.apply({"params": p}, jnp.asarray(x), True)
        return (jlosses.cce_smooth(jlabels.label2vec(jnp.asarray(y)), probs)
                + jlosses.l2_regularization(p, L2))

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return float(loss), {k: np.asarray(v) for k, v in
                         flatten_params({"params": grads}).items()}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl,port_impl", [("xla", "composed"),
                                            ("flash", "flash"),
                                            ("pallas", "pallas")])
def test_vit_train_loss_and_grads_match_jax(batch, variant, impl, port_impl):
    """Train-mode loss (cce_smooth + L2 1e-2 on the 'kernel' leaves) rtol
    1e-5 and every gradient leaf within 1e-4 of its max against
    jax.value_and_grad; JAX runs K3 / K5 in interpret mode.  The key bias
    (exactly-zero gradient) is held to 1e-6 of the largest gradient."""
    x, y = batch
    jl, want = _jax_value_and_grad(variant, x, y, impl)
    model = _port(variant, attn_train_impl=port_impl).train()
    loss = (losses.cce_smooth(labels.label2vec(_t(y)), model(_t(x)))
            + losses.l2_regularization(losses.l2_kernels(model), L2))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jl, rel=1e-5)
    got = bridge.to_flax({n: p.grad for n, p in model.named_parameters()}, "vit")
    assert set(got) == set(want)
    gmax = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if ZERO_GRAD.search(k):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-6 * gmax, k
        else:
            assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def test_l2_penalty_takes_the_kernel_leaves_only():
    """The JAX rule: leaves named exactly 'kernel' (convs, fc1, fc2) — not
    the attention's {query,key,value,out}_kernel, biases, norm scales or
    position embeddings — and the same value."""
    params, flat = _flax("conv_stem")
    m = _port("conv_stem")
    names = {n for n, p in m.named_parameters()
             if any(p is k for k in losses.l2_kernels(m))}
    assert names == {"stem_0.weight", "stem_1.weight", "patch_embeddings.weight",
                     "head.weight", "block_0.ffn.fc1.weight",
                     "block_0.ffn.fc2.weight", "block_1.ffn.fc1.weight",
                     "block_1.ffn.fc2.weight"}
    want = float(jlosses.l2_regularization(params, L2))
    with torch.no_grad():
        got = float(losses.l2_regularization(losses.l2_kernels(m), L2))
    assert got == pytest.approx(want, rel=1e-6)


def test_vit_train_step_matches_jax_make_train_step(batch):
    """One full step (augmentation off, L2 1e-2, clip 1.0, Adam, lr 1e-3)
    against make_train_step(l2_scale=...) jitted: loss rtol 1e-5, Adam's
    first moments within 1e-4 of each leaf's max, parameters within rtol
    1e-4, atol 1e-6 plus lr * |u(g_jax) - u(g_port)| (Adam's first update
    u(g) = g / (|g| + 1e-8) amplifies differences where g is near 1e-8, as
    in tests/test_torch_train.py)."""
    x, y = batch
    lr = 1e-3
    params, _ = _flax("base")
    tx = joptim.make_direction(clip_norm=1.0)
    state = jstep.TrainState(params=params, batch_stats={},
                             opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(JaxViT(**TINY), jlosses.cce_smooth, tx,
                                         augment=False, l2_scale=L2, jit=False))
    new_state, jl, _ = step(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.float32(lr))
    want = flatten_params({"params": new_state.params})
    jax_mu = {k: np.asarray(v) for k, v in flatten_params(
        {"params": new_state.opt_state[1].mu}).items()}

    model = _port("base")
    ts = TrainState(model, optim.Adam(model.parameters(), 1.0), 0,
                    torch.Generator().manual_seed(0))
    loss, probs = make_train_step(model, losses.cce_smooth, augment=False,
                                  l2_scale=L2)(ts, _t(x), _t(y), lr)
    assert ts.step == 1 and probs.shape == (2, 32, 20, 3)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    got = bridge.to_flax(model.state_dict(), "vit")
    port_g = bridge.to_flax({n: p.grad for n, p in model.named_parameters()}, "vit")
    port_mu = bridge.to_flax({n: m for (n, _), m in
                              zip(model.named_parameters(), ts.opt.mu)}, "vit")
    assert set(got) == set(want)

    def u(g):
        return g / (np.abs(g) + 1e-8)

    for k, w in want.items():
        w = np.asarray(w)
        if not ZERO_GRAD.search(k):
            assert (np.abs(port_mu[k] - jax_mu[k]).max()
                    <= 1e-4 * np.abs(jax_mu[k]).max()), k
        slack = lr * np.abs(u(jax_mu[k] / 0.1) - u(port_g[k]))
        assert np.all(np.abs(got[k] - w) <= 1e-6 + 1e-4 * np.abs(w) + slack), k


def _tiny_vit_cfg(**train):
    cfg = default_config("vit")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, img_size=(32, 20),
                                  vit_hidden=32, vit_heads=4, vit_layers=2,
                                  vit_grid=(4, 5), mlp_dim=64,
                                  attn_train_impl="pallas"),
        train=dataclasses.replace(cfg.train, **train))


def test_vit_trainer_fit_tiny_on_cpu():
    """Trainer.fit on the tiny ViT with K5's plain route, augmentation and
    the config's L2 term: finite loss and metrics, and the weights moved."""
    cfg = _tiny_vit_cfg(batch_size=4, eval_every_epochs=1)
    assert cfg.train.l2_regularization == 1e-5
    ds = Dataset.synthetic(n_train=8, n_test=4, height=32, width=20,
                           device="cpu")
    trainer = Trainer(cfg, ds, device="cpu")
    before = trainer.model.head.weight.detach().clone()
    summary = trainer.fit(1)
    assert trainer.state.step == 2 and np.isfinite(trainer.last_epoch["loss"])
    assert summary and all(np.isfinite(v) for v in summary.values())
    assert not torch.equal(trainer.model.head.weight, before)


@pytest.mark.parametrize("field,value", [("weight_decay", 1e-4),
                                         ("adam_mu_dtype", "bfloat16")])
def test_trainer_refuses_unported_optimizer_options(field, value):
    ds = Dataset.synthetic(n_train=4, n_test=4, height=32, width=20,
                           device="cpu")
    with pytest.raises(NotImplementedError, match=field):
        Trainer(_tiny_vit_cfg(**{field: value}), ds, device="cpu")


# ---------------------------------------------------------------------------
# registry and cli
# ---------------------------------------------------------------------------

def test_cli_builds_the_vit():
    args = cli.make_parser().parse_args(
        ["train", "--model", "vit", "--synthetic", "--attn-train", "pallas",
         "--bf16", "--epochs", "1"])
    cfg = cli.build_config(args)
    assert cfg.model.name == "vit" and cfg.train.batch_size == 8
    m = build_model(dataclasses.replace(cfg.model, vit_layers=1))
    assert isinstance(m, ViTSegmenter) and m.family == "vit"
    assert m.block_0.attn.attn_train_impl == "pallas"
    assert m.compute_dtype == torch.bfloat16 and m.hidden_size == 1280
    assert m.attn_impl == "kernel" and m.img_size == (256, 80)
    assert m.head.weight.shape == (3, 10, 3, 3)
    auto = build_model(dataclasses.replace(default_config("vit").model,
                                           vit_layers=1))
    assert auto.block_0.attn.attn_train_impl == "composed"  # 'auto' off the TPU
    with pytest.raises(NotImplementedError, match="dropout"):
        build_model(dataclasses.replace(cfg.model, dropout_rate=0.1))


def test_serve_vit_without_params_refuses():
    with pytest.raises(SystemExit, match="--params"):
        cli.main(["serve", "--model", "vit", "--device", "cpu"])


def test_serve_vit_builds_from_npz(tmp_path, monkeypatch):
    """cli's serving model for --model vit loads a flax-layout ViT npz
    through the bridge (the default config cut to the tiny one here)."""
    tiny = _tiny_vit_cfg()
    monkeypatch.setattr(cli, "default_config", lambda name: tiny)
    m = build_model(tiny.model)
    path = str(tmp_path / "vit.npz")
    np.savez(path, **bridge.random_flax_variables(m, seed=1))
    served = cli.build_serving_model(path, True, torch.device("cpu"), "vit")
    assert isinstance(served, ViTSegmenter) and not served.training
    assert served.compute_dtype == torch.bfloat16
    assert torch.equal(served.head.weight,
                       bridge.load_params_npz(path, "vit")["head.weight"])
    x = np.random.default_rng(0).standard_normal((2, 32, 20, 10))
    probs = cli.make_forward(served, torch.device("cpu"))(x)
    assert probs.shape == (2, 32, 20, 3) and np.isfinite(probs).all()


# ---------------------------------------------------------------------------
# building blocks the ViT added (repairs to models/common.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride,padding,shape", [
    ((16, 8), (16, 8), "VALID", (2, 32, 16, 3)),   # the patch conv
    ((3, 3), (2, 2), "SAME", (2, 16, 10, 3)),      # the stem: pads 0 low, 1 high
    ((3, 3), (2, 2), "SAME", (2, 15, 9, 3)),       # odd sizes: 1 and 1
    ((4, 2), (4, 2), "VALID", (2, 8, 6, 3))])
def test_strided_conv_matches_flax(rng, kernel, stride, padding, shape):
    """flax nn.Conv with strides and SAME (asymmetric pads) or VALID, to
    1e-5; the stride-1 SAME convs of the TransUNet keep their path."""
    x = rng.standard_normal(shape).astype(np.float32)
    mod = fnn.Conv(5, kernel, strides=stride, padding=padding, name="c")
    v = mod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    flat = {f"params/c/{k}": np.asarray(a) for k, a in v["params"].items()}
    port = tc.Conv(3, 5, kernel, stride=stride, padding=padding)
    port.load_state_dict({k[2:]: t for k, t in bridge.from_flax(flat).items()})
    with torch.inference_mode():
        got = port(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flax_same_pads():
    assert tc.flax_same_pads(256, 3, 2) == (0, 1)
    assert tc.flax_same_pads(80, 3, 2) == (0, 1)
    assert tc.flax_same_pads(15, 3, 2) == (1, 1)
    assert tc.flax_same_pads(12, 3, 1, dilation=8) == (8, 8)


@pytest.mark.parametrize("slope", [0.2, 0.3])
def test_leaky_slope_and_derivative_at_zero_match_flax(slope):
    """Values and gradients of LeakyReLU(slope), exact zeros included
    (flax: slope 1 at 0)."""
    x = np.array([-2.0, -0.5, 0.0, 0.0, 0.7, 3.0], np.float32)
    want = np.asarray(jax.nn.leaky_relu(jnp.asarray(x), slope))
    gwant = np.asarray(jax.grad(lambda a: jnp.sum(
        jax.nn.leaky_relu(a, slope) * jnp.arange(6.0)))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = tc.leaky(xt, slope)
    (got * torch.arange(6.0)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), gwant)
    with torch.inference_mode():
        np.testing.assert_array_equal(tc.leaky(_t(x), slope).numpy(), want)
