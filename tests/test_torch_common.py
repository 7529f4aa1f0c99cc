"""PyTorch port's building blocks vs flax on the same weights and inputs
(numpy-seeded): conv / transposed conv / norms, mha and the window
attention helpers."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.models import common as jc
from ultrasound_modeling_tpu.ops import attention as jattn
from ultrasound_modeling_tpu.ops import window_attn as jwa
from ultrasound_modeling_tpu_torch.models import common as tc
from ultrasound_modeling_tpu_torch.ops import attention as tattn
from ultrasound_modeling_tpu_torch.ops import window_attn as twa
from ultrasound_modeling_tpu_torch.utils.checkpoint import from_flax


def _load(module, flax_params, prefix):
    """Bridge one flax module's params (under ``prefix``) into ``module``."""
    flat = {f"params/{prefix}/{k}": np.asarray(v)
            for k, v in flax_params.items()}
    sd = {k[len(prefix) + 1:]: v for k, v in from_flax(flat).items()}
    module.load_state_dict(sd, strict=True)
    return module


@pytest.mark.parametrize("kernel", [3, 4])
def test_conv_transpose_matches_flax(rng, kernel):
    """flax ConvTranspose(k, s=2, SAME) == the port's ConvTranspose through
    the bridge's flipped layout, to 1e-6 (k=3: pad 0 + crop; k=4: pad 1)."""
    x = rng.standard_normal((2, 5, 3, 6)).astype(np.float32)
    fl = jc.conv_transpose(4, kernel, 2, name="up")
    v = fl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(fl.apply(v, jnp.asarray(x)))
    port = _load(tc.ConvTranspose(6, 4, kernel, 2), v["params"], "up")
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10, 6, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel,dilation", [(1, 1), (3, 1), (3, 2), (3, 8)])
def test_conv_same_matches_flax(rng, kernel, dilation):
    x = rng.standard_normal((2, 12, 10, 5)).astype(np.float32)
    fl = jc.conv(7, kernel, dilation=dilation, name="c")
    v = fl.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(fl.apply(v, jnp.asarray(x)))
    port = _load(tc.Conv(5, 7, kernel, dilation), v["params"], "c")
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["layer", "batch"])
def test_keras_norms_match_flax_eval(rng, kind):
    """Keras LayerNorm (eps 1e-3) and BatchNorm at eval (running stats,
    eps 1e-3), through the Norm wrapper's flax names."""
    x = rng.standard_normal((2, 4, 3, 8)).astype(np.float32) * 3 + 1
    fl = jc.Norm(kind)
    v = fl.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    v = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32), v)
    want = np.asarray(fl.apply(v, jnp.asarray(x), False))
    flat = {f"{col}/n/{'/'.join(str(p.key) for p in path)}": np.asarray(a)
            for col in v
            for path, a in jax.tree_util.tree_flatten_with_path(v[col])[0]}
    sd = {k[2:]: t for k, t in from_flax(flat).items()}
    port = tc.Norm(kind, 8)
    port.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_avg_pool_and_activations_match_flax(rng):
    x = rng.standard_normal((2, 6, 4, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tc.avg_pool2(xt).numpy(),
                               np.asarray(jc.avg_pool2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    for kind, fn in (("leaky", tc.leaky), ("gelu", tc.gelu)):
        np.testing.assert_allclose(
            fn(xt).numpy(), np.asarray(jc.activation(kind)(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6, err_msg=kind)


def test_mha_matches_jax(rng):
    """Scale 1/sqrt(heads) (not 1/sqrt(d)), f32 scores."""
    q, k, v = (rng.standard_normal((2, 10, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jattn.mha(*map(jnp.asarray, (q, k, v)), 4))
    got = tattn.mha(*map(torch.from_numpy, (q, k, v)), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_window_helpers_match_jax():
    np.testing.assert_array_equal(twa.relative_position_index((4, 5)),
                                  jwa.relative_position_index((4, 5)))
    np.testing.assert_array_equal(twa.shifted_window_mask(8, 10, (4, 5), 2),
                                  jwa.shifted_window_mask(8, 10, (4, 5), 2))


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_plain_matches_jax(rng, masked):
    c, heads = 16, 4
    x = rng.standard_normal((8, 20, c)).astype(np.float32)
    qkv_w = (rng.standard_normal((c, 3 * c)) * 0.1).astype(np.float32)
    qkv_b = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    table = (rng.standard_normal((63, heads)) * 0.1).astype(np.float32)
    rel = jwa.relative_position_index((4, 5))
    mask = jwa.shifted_window_mask(8, 10, (4, 5), 2) if masked else None
    want = np.asarray(jwa.window_attention(
        jnp.asarray(x), jnp.asarray(qkv_w), jnp.asarray(qkv_b),
        jnp.asarray(table), jnp.asarray(rel), heads,
        mask=None if mask is None else jnp.asarray(mask)))
    got = twa.window_attention(
        torch.from_numpy(x), torch.from_numpy(qkv_w.T.copy()),
        torch.from_numpy(qkv_b), torch.from_numpy(table),
        torch.from_numpy(rel), heads,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flax_dense_is_linear_transposed(rng):
    """Dense [in, out] -> Linear [out, in] through the bridge."""
    x = rng.standard_normal((3, 5)).astype(np.float32)
    fl = nn.Dense(4)
    v = fl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(fl.apply(v, jnp.asarray(x)))
    port = _load(torch.nn.Linear(5, 4), v["params"], "fc1")
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the layers the ResNeStUNet and the MobileUNet add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,use_bias,hw", [
    (4, True, (4, 6)), (4, True, (5, 3)), (4, False, (4, 6)),
    (3, False, (4, 6)), (3, False, (5, 3))])
def test_conv_transpose_sizes_and_bias_match_flax(rng, kernel, use_bias, hw):
    """flax ConvTranspose(k, s=2, SAME) at even and odd input sizes, with
    and without a bias (the ResNeStUNet's k4 upsamples and head, the
    MobileUNet's bias-less k3 upsamples), to 1e-6: k4 is ``padding=1``,
    k3 pad 0 cropped to ``2n``."""
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    fl = jc.conv_transpose(4, kernel, 2, use_bias=use_bias, name="up")
    v = fl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert ("bias" in v["params"]) == use_bias
    want = np.asarray(fl.apply(v, jnp.asarray(x)))
    port = _load(tc.ConvTranspose(6, 4, kernel, 2, use_bias=use_bias),
                 v["params"], "up")
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,cin,cout,kw,hw", [
    ("depthwise s1", 6, 6, dict(strides=1, padding="SAME", groups=6), (8, 6)),
    ("depthwise s2", 6, 6, dict(strides=2, padding=((1, 1), (1, 1)),
                                groups=6), (8, 6)),
    ("depthwise s2 odd", 6, 6, dict(strides=2, padding=((1, 1), (1, 1)),
                                    groups=6), (7, 5)),
    ("stem s2", 5, 8, dict(strides=2, padding=((1, 1), (1, 1)), bias=True),
     (8, 6)),
    ("1x1 no bias", 6, 9, dict(strides=1, padding="SAME", k=1), (8, 6)),
])
def test_conv_groups_pads_and_bias_match_flax(rng, name, cin, cout, kw, hw):
    """The MobileUNet's convs against flax ``nn.Conv``: depthwise
    (``feature_group_count = ch``, kernel ``[3, 3, 1, ch]``), explicit
    symmetric stride-2 padding, 1x1 without a bias; 1e-5."""
    k = kw.get("k", 3)
    groups, bias = kw.get("groups", 1), kw.get("bias", False)
    x = rng.standard_normal((2, *hw, cin)).astype(np.float32)
    fl = nn.Conv(cout, (k, k), strides=(kw["strides"],) * 2,
                 padding=kw["padding"], feature_group_count=groups,
                 use_bias=bias, name="c")
    v = fl.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(fl.apply(v, jnp.asarray(x)))
    port = _load(tc.Conv(cin, cout, k, stride=kw["strides"],
                         padding=kw["padding"], groups=groups, use_bias=bias),
                 v["params"], "c")
    assert (port.bias is None) == (not bias)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_symmetric_stride_two_pad_differs_from_flax_same(rng):
    """The trap the explicit padding avoids: at an even size flax's SAME
    pads a 3x3 stride-2 conv (0, 1), the reference's ZeroPadding2D(1) +
    VALID (1, 1), so the outputs are a pixel apart; a bad padding spec
    raises."""
    x = torch.from_numpy(rng.standard_normal((1, 8, 6, 2)).astype(np.float32))
    same = tc.Conv(2, 3, 3, stride=2)
    sym = tc.Conv(2, 3, 3, stride=2, padding=((1, 1), (1, 1)))
    sym.load_state_dict(same.state_dict())
    with torch.no_grad():
        torch.nn.init.normal_(sym.weight)
        same.weight.copy_(sym.weight)
        a, b = same(x), sym(x)
    assert a.shape == b.shape == (1, 4, 3, 3)
    assert not torch.allclose(a, b)
    with pytest.raises(ValueError, match="padding"):
        tc.Conv(2, 3, 3, padding="FULL")


def test_elu_and_relu6_match_flax_with_their_derivatives(rng):
    """Values and derivatives, exact zeros and sixes included (flax's ELU
    and ``min(relu(x), 6)`` take slope 1 and 0 at 0)."""
    x = rng.standard_normal((4, 5)).astype(np.float32) * 4
    x[0, :3] = [0.0, 6.0, -0.0]
    for kind, fn in (("elu", tc.elu), ("relu6", tc.relu6)):
        jf = jc.activation(kind)
        want = np.asarray(jf(jnp.asarray(x)))
        jg = np.asarray(jax.grad(lambda a: jf(a).sum())(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        got = fn(xt)
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-7, err_msg=kind)
        keep = x != 6.0     # jnp.minimum splits a tie's gradient in half
        np.testing.assert_allclose(xt.grad.numpy()[keep], jg[keep],
                                   rtol=1e-6, atol=1e-7, err_msg=kind)


def test_dropout_matches_flax_with_its_mask():
    """flax ``nn.Dropout(0.5)`` in train mode: its output's zeros are its
    mask; the port given that mask returns the same array, in x's dtype;
    the identity in eval mode; drawing needs a generator, from which it
    keeps about half once its mask is cleared."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 8, 6, 5)) + 3.0).astype(np.float32)
    want = np.asarray(nn.Dropout(0.5, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(1)}))
    keep = torch.from_numpy(want != 0)
    m = torch.nn.Sequential()
    m.add_module("Dropout_0", tc.Dropout(0.5))
    m.train()
    tc.set_dropout_masks(m, {"Dropout_0": keep})
    got = m(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert m(xb).dtype == torch.bfloat16
    tc.set_dropout_masks(m, {"Dropout_0": None})
    with pytest.raises(RuntimeError, match="Generator"):
        m(torch.from_numpy(x))
    tc.set_dropout_generator(m, torch.Generator().manual_seed(0))
    drawn = m(torch.from_numpy(x))
    assert 0.45 < float((drawn != 0).float().mean()) < 0.55
    m.eval()
    assert torch.equal(m(torch.from_numpy(x)), torch.from_numpy(x))
