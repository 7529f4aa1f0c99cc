"""PyTorch port vs the JAX package: the Swin family (``models/swin.py``)
and K4's bf16-input contract and backward, on the same weights and inputs.

Two tiny configs: the parity pin's (``benchmarks/make_parity_pins.py``:
image 16x20, 4 channels, embed 8, depths (1,), heads (2,), window (2, 2))
and ``TINY`` (image 32x20, embed 16, depths (2, 2, 2), heads (2, 4, 8),
window (2, 5)), which runs a shifted window on every stage but the last,
pads stage 2's 4x3 grid to 4x5 before its windows, and attends over stage
3's 2x2 grid as one degenerate unshifted window.  One flax init serves the
module; the zero-initialized biases and bias tables are redrawn so that
every leaf matters.  JAX runs K4 (``window_attention_fused``) in
interpret mode, the port its plain versions (CPU tensors)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.data import labels as jlabels
from ultrasound_modeling_tpu.models import common as jc
from ultrasound_modeling_tpu.models import swin as jswin
from ultrasound_modeling_tpu.ops import pallas_kernels as pk
from ultrasound_modeling_tpu.ops import window_attn as jwa
from ultrasound_modeling_tpu.train import losses as jlosses
from ultrasound_modeling_tpu.train import optim as joptim
from ultrasound_modeling_tpu.train import step as jstep
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.config import default_config
from ultrasound_modeling_tpu_torch.data import labels
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.models import swin
from ultrasound_modeling_tpu_torch.models.registry import build_model
from ultrasound_modeling_tpu_torch.ops import kernels as K
from ultrasound_modeling_tpu_torch.ops import window_attn as twa
from ultrasound_modeling_tpu_torch.train import losses, optim
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.train.step import TrainState, make_train_step
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge

TINY = dict(num_classes=3, img_size=(32, 20), embed_dim=16, depths=(2, 2, 2),
            num_heads=(2, 4, 8), window=(2, 5))
PIN = dict(num_classes=3, img_size=(16, 20), embed_dim=8, depths=(1,),
           num_heads=(2,), window=(2, 2))
# port route -> the JAX attn_impl it reproduces ('plain': the kernel route
# under kernels.plain_versions())
JAX_ROUTE = {"composed": "xla", "kernel": "pallas", "plain": "pallas"}
BF16_Q = 2.0 ** -8     # one bf16 quantum, relative


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(dtype)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 32, 20, 10)).astype(np.float32)
    y = rng.choice([0.0, 0.5, 0.96, 1.0, 1.04, 1.3, 2.0],
                   size=(2, 32, 20)).astype(np.float32)
    return x, y


def _jax_swin(impl="xla", **kw):
    return jswin.SwinSegmenter(**TINY, drop_path_rate=0.0, attn_impl=impl, **kw)


@functools.lru_cache(maxsize=None)
def _flax():
    """(nested params, flat npz-layout dict): flax init PRNGKey(4), then
    every bias and bias table redrawn (seed 9)."""
    params = jax.jit(_jax_swin().init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(4)},
        jnp.zeros((2, 32, 20, 10), jnp.float32), False)["params"]
    rng = np.random.default_rng(9)

    def redraw(path, a):
        name = str(path[-1].key)
        if name.endswith("bias") or name == "relative_position_bias_table":
            return jnp.asarray(rng.normal(size=a.shape, scale=0.1), a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(redraw, params)
    flat = {k: np.asarray(v) for k, v in flatten_params({"params": params}).items()}
    return params, flat


def _port(**kw):
    m = swin.SwinSegmenter(**TINY, drop_path_rate=0.0, **kw)
    m.load_state_dict(bridge.from_flax(_flax()[1], "swin"), strict=True)
    return m


def _impl(route):
    """The model's attn_impl on a port route."""
    return "composed" if route == "composed" else "kernel"


@functools.lru_cache(maxsize=None)
def _jax_eval(impl, dtype="float32"):
    x = np.random.default_rng(8).normal(size=(2, 32, 20, 10)).astype(np.float32)
    jc.set_compute_dtype(None if dtype == "float32" else dtype)
    try:
        out = jax.jit(_jax_swin(impl).apply, static_argnums=(2,))(
            {"params": _flax()[0]}, jnp.asarray(x), False)
        return np.asarray(out, np.float32)
    finally:
        jc.set_compute_dtype(None)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_window_partition_and_reverse_match_jax(rng):
    x = rng.normal(size=(2, 8, 10, 3)).astype(np.float32)
    want = np.asarray(jwa.window_partition(jnp.asarray(x), (4, 5)))
    got = twa.window_partition(_t(x), (4, 5))
    assert got.shape == (8, 20, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        twa.window_reverse(got, (4, 5), 8, 10).numpy(), x)


def test_drop_path_matches_the_jax_formula():
    """DropPath equals flax's ``x / keep * floor(keep + u)``
    (models/swin.py:70-83) bit for bit on the uniform draw ``u`` its
    generator makes, in f32 and bf16; eval mode and rate 0 are the
    identity."""
    x = np.random.default_rng(3).normal(size=(64, 5, 4)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        u = torch.rand((64, 1, 1), generator=torch.Generator().manual_seed(7),
                       dtype=dt)
        keep = 1.0 - 0.1
        xj, uj = jnp.asarray(x, jdt), jnp.asarray(u.float().numpy(), jdt)
        want = np.asarray((xj / keep * jnp.floor(keep + uj)).astype(jnp.float32))
        dp = swin.DropPath(0.1).train()
        dp.generator = torch.Generator().manual_seed(7)
        got = dp(_t(x, dt))
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), want)
        dropped = (got == 0).flatten(1).all(1)
        assert dropped.any() and not dropped.all()
        assert torch.equal(dp.eval()(_t(x, dt)), _t(x, dt))
    assert torch.equal(swin.DropPath(0.0).train()(_t(x)), _t(x))


def test_drop_path_draws_from_the_train_state_generator():
    """TrainState puts its drop-path generator on every DropPath: the same
    seed gives the same masks, another seed other masks, and a DropPath
    with no generator refuses to draw from the global one."""
    m = swin.SwinSegmenter(**TINY, drop_path_rate=0.5).train()
    m.load_state_dict(bridge.from_flax(bridge.random_flax_variables(m, 2),
                                       "swin"))
    x = torch.randn(8, 32, 20, 10)
    with pytest.raises(RuntimeError, match="Generator"):
        m(x)
    outs = []
    for seed in (1, 1, 2):
        TrainState(m, optim.Adam(m.parameters(), 1.0), 0,
                   torch.Generator().manual_seed(0),
                   torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(m(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    ts = TrainState.create(m, 5, "cpu")
    assert m.backbone.layer1_block1.drop_path2.generator is ts.drop_gen
    assert ts.drop_gen.initial_seed() == 6 and ts.gen.initial_seed() == 5


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

def test_swin_bridge_round_trip_is_exact_and_covers_the_tree():
    """npz -> state_dict -> npz is exact and loads strictly: the raw
    attention params become the qkv / proj linears, up_{i} / up_final1 /
    head are transposed convs (flipped), the patch conv and fuse_{i} plain
    ones, the reduction has no bias; random_flax_variables covers the same
    leaves."""
    _, flat = _flax()
    sd = bridge.from_flax(flat, "swin")
    m = swin.SwinSegmenter(**TINY)
    assert set(sd) == set(m.state_dict())
    a = "params/backbone/layer1_block1/attn/"
    assert np.array_equal(sd["backbone.layer1_block1.attn.qkv.weight"].numpy(),
                          flat[a + "qkv_kernel"].T)
    assert np.array_equal(sd["backbone.layer1_block1.attn.proj.weight"].numpy(),
                          flat[a + "proj_kernel"].T)
    up = flat["params/up_0/kernel"]
    assert np.array_equal(sd["up_0.weight"].numpy(),
                          up[::-1, ::-1].transpose(2, 3, 0, 1))
    assert np.array_equal(sd["fuse_0.weight"].numpy(),
                          flat["params/fuse_0/kernel"].transpose(3, 2, 0, 1))
    assert "params/backbone/layer0_downsample/reduction/bias" not in flat
    back = bridge.to_flax(sd, "swin")
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    rand = bridge.random_flax_variables(m, seed=3)
    assert set(rand) == set(flat)
    qkv = rand[a + "qkv_kernel"]      # q and k columns damped
    assert np.abs(qkv[:, :64]).max() < 0.2 * np.abs(qkv[:, 64:]).max()
    m.load_state_dict(bridge.from_flax(rand, "swin"), strict=True)


# ---------------------------------------------------------------------------
# eval forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pins():
    import os
    return np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "parity_pins.npz"))


@pytest.fixture(scope="module")
def pin_flax(pins):
    """The pin's flat variables: flax init PRNGKey(0) on its input, as
    make_parity_pins made them."""
    v = jax.jit(jswin.SwinSegmenter(**PIN, drop_path_rate=0.0,
                                    attn_impl="xla").init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(pins["swin/x"]), False)
    return {k: np.asarray(a) for k, a in flatten_params(dict(v)).items()}


@pytest.mark.parametrize("attn_impl", ["composed", "kernel", "plain"])
def test_swin_f32_forward_reproduces_parity_pin(pins, pin_flax, attn_impl):
    """The pin's Swin (flax init PRNGKey(0), its 'xla' route) through the
    bridge reproduces ``swin/y`` within atol 2e-5 (the TransUNet pin's
    bound) on every route."""
    m = swin.SwinSegmenter(**PIN, in_channels=4, drop_path_rate=0.0,
                           attn_impl=_impl(attn_impl))
    m.load_state_dict(bridge.from_flax(pin_flax, "swin"), strict=True)
    with torch.inference_mode(), K.plain_versions(attn_impl == "plain"):
        got = m.eval()(torch.from_numpy(pins["swin/x"])).numpy()
    want = pins["swin/y"]
    assert got.shape == want.shape == (1, 16, 20, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("attn_impl", ["composed", "kernel", "plain"])
def test_swin_f32_eval_matches_flax(batch, attn_impl):
    """f32 eval probabilities of the tiny Swin (shift, padding, degenerate
    window) against flax on the matching JAX route (K4 in interpret mode
    for 'kernel' and 'plain') within 1e-5."""
    x, _ = batch
    want = _jax_eval(JAX_ROUTE[attn_impl])
    with torch.inference_mode(), K.plain_versions(attn_impl == "plain"):
        got = _port(attn_impl=_impl(attn_impl)).eval()(_t(x))
    assert got.shape == (2, 32, 20, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _block_dtypes(model, x):
    """(probabilities, the dtype of every SwinBlock's output)."""
    seen = []
    hooks = [m.register_forward_hook(lambda mod, i, o: seen.append(o.dtype))
             for m in model.modules() if isinstance(m, swin.SwinBlock)]
    try:
        with torch.inference_mode():
            return model(x), seen
    finally:
        for h in hooks:
            h.remove()


@pytest.mark.parametrize("attn_impl", ["composed", "kernel"])
def test_swin_bf16_eval_matches_the_jax_route(batch, attn_impl):
    """bf16 eval against the same JAX route under
    ``set_compute_dtype('bfloat16')``: max abs probability difference <= 4
    bf16 quanta of 1.  The routes keep different residual streams, as in
    JAX: 'composed' projects with the f32 params, so every block returns
    f32; K4 returns its input's dtype, so every block stays bf16."""
    x, _ = batch
    want = _jax_eval(JAX_ROUTE[attn_impl], "bfloat16")
    got, dtypes = _block_dtypes(
        _port(attn_impl=attn_impl, compute_dtype=torch.bfloat16).eval(), _t(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    stream = torch.float32 if attn_impl == "composed" else torch.bfloat16
    assert len(dtypes) == 6 and set(dtypes) == {stream}
    assert np.abs(got.numpy() - want).max() <= 4 * BF16_Q


# ---------------------------------------------------------------------------
# K4 alone: bf16 input and the backward
# ---------------------------------------------------------------------------

def _k4_inputs(seed=0, nbw=8, n=20, c=16, heads=4):
    """tests/test_pallas.py's window-attention setup (4x5 windows, bias
    table, the shift mask of an 8x10 grid: four windows)."""
    r = np.random.default_rng(seed)
    return dict(
        x=r.normal(size=(nbw, n, c)).astype(np.float32),
        qkv_w=(r.normal(size=(c, 3 * c)) * 0.1).astype(np.float32),
        qkv_b=(r.normal(size=(3 * c,)) * 0.1).astype(np.float32),
        proj_w=(r.normal(size=(c, c)) * 0.1).astype(np.float32),
        proj_b=(r.normal(size=(c,)) * 0.1).astype(np.float32),
        table=(r.normal(size=(7 * 9, heads)) * 0.1).astype(np.float32),
        rel=jwa.relative_position_index((4, 5)),
        mask=jwa.shifted_window_mask(8, 10, (4, 5), 2), heads=heads)


def _k4_jax(a, x_dtype):
    def fwd(x, qkv_w, qkv_b, proj_w, proj_b, table):
        return pk.window_attention_fused(
            x.astype(x_dtype), qkv_w, qkv_b, proj_w, proj_b, table,
            jnp.asarray(a["rel"]), a["heads"], mask=jnp.asarray(a["mask"]),
            windows_per_step=4, interpret=True)
    return fwd


def _k4_port(a, dt, fn=K.window_attention_fused):
    args = [_t(a["x"], dt)] + [_t(a[k]) for k in ("qkv_w", "qkv_b", "proj_w",
                                                  "proj_b", "table")]
    args[1], args[3] = args[1].t().contiguous(), args[3].t().contiguous()
    for t in args:
        t.requires_grad_()

    def call():
        return fn(args[0], args[1], args[2], args[3], args[4], a["heads"],
                  bias_table=args[5], rel_index=torch.from_numpy(a["rel"]),
                  mask=_t(a["mask"]))
    return args, call


def test_k4_bf16_input_matches_pallas_within_a_quantum():
    """A bf16 x with f32 weights: f32 products, the output rounded once to
    bf16 (pallas_kernels.py:62-79), within 1 bf16 quantum of max|out| of
    the Pallas kernel; the wrapper, its autograd entry and the plain
    version agree bit for bit on the CPU."""
    a = _k4_inputs()
    jargs = [jnp.asarray(a[k]) for k in ("x", "qkv_w", "qkv_b", "proj_w",
                                         "proj_b", "table")]
    want = np.asarray(_k4_jax(a, jnp.bfloat16)(*jargs).astype(jnp.float32))
    outs = []
    for fn in (K.window_attention_fused, K.window_attention,
               K.window_attention_plain):
        _, call = _k4_port(a, torch.bfloat16, fn)
        with torch.no_grad():
            outs.append(call())
    assert all(o.dtype == torch.bfloat16 for o in outs)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    err = np.abs(outs[0].float().numpy() - want).max()
    assert err <= BF16_Q * np.abs(want).max()


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["fused", "plain"])
def test_k4_gradients_match_pallas_custom_vjp(x_dtype, fn):
    """Gradients of ``sum(out**2)`` to x, qkv_w, qkv_b, proj_w, proj_b and
    the bias table, through the shift mask, against jax.grad of
    ``window_attention_fused`` (its custom VJP), mirroring
    tests/test_pallas.py:66-92.  f32: rtol 1e-4, atol 1e-5 of each leaf's
    max.  bf16 x: the output and dx are bf16 on both sides, so a value on
    either side of a rounding edge moves ``g = 2 out`` or dx by a quantum;
    within 1 quantum of each leaf's max.  ``plain`` is autograd through the plain
    version, the route the card holds K4's backward against."""
    a = _k4_inputs(seed=1)
    jdt = jnp.float32 if x_dtype == "float32" else jnp.bfloat16
    f = _k4_jax(a, jdt)
    jargs = [jnp.asarray(a[k]) for k in ("x", "qkv_w", "qkv_b", "proj_w",
                                         "proj_b", "table")]
    jargs[0] = jargs[0].astype(jdt)
    want = jax.grad(lambda *p: jnp.sum(f(*p).astype(jnp.float32) ** 2),
                    argnums=tuple(range(6)))(*jargs)
    dt = torch.float32 if x_dtype == "float32" else torch.bfloat16
    args, call = _k4_port(a, dt, K.window_attention_fused if fn == "fused"
                          else K.window_attention_plain)
    (call().float() ** 2).sum().backward()
    names = ["x", "qkv_w", "qkv_b", "proj_w", "proj_b", "table"]
    for name, t, w in zip(names, args, want):
        g = t.grad
        assert g.dtype == t.dtype, name
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        if name in ("qkv_w", "proj_w"):
            g = g.T
        scale = np.abs(w).max()
        if x_dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=name)
        else:
            assert np.abs(g - w).max() <= BF16_Q * scale, name


def test_k4_backward_without_bias_or_mask_returns_what_autograd_does():
    """The TransUNet / ViT use of K4 (no bias table, no mask, scale
    1/sqrt(heads)): the fused backward equals autograd through the plain
    version to f32 rounding, and returns no gradient for what needs none."""
    r = np.random.default_rng(2)
    x = _t(r.normal(size=(3, 10, 8))).requires_grad_()
    qkv_w = _t(r.normal(size=(24, 8)) * 0.3).requires_grad_()
    proj_w = _t(r.normal(size=(8, 8)) * 0.3)
    grads = []
    for fn in (K.window_attention_fused, K.window_attention_plain):
        out = fn(x, qkv_w, None, proj_w, None, 2, scale=0.5)
        grads.append(torch.autograd.grad((out ** 2).sum(), (x, qkv_w)))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# train mode
# ---------------------------------------------------------------------------

def _jax_value_and_grad(x, y, impl):
    model = _jax_swin(impl)

    def loss_of(p):
        probs = model.apply({"params": p}, jnp.asarray(x), True)
        return jlosses.cce_smooth(jlabels.label2vec(jnp.asarray(y)), probs)

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(_flax()[0])
    return float(loss), {k: np.asarray(v) for k, v in
                         flatten_params({"params": grads}).items()}


@pytest.mark.parametrize("attn_impl", ["composed", "kernel", "plain"])
def test_swin_train_loss_and_grads_match_jax(batch, attn_impl):
    """Train-mode loss (cce_smooth, drop-path 0) rtol 1e-5 and every
    gradient leaf within 1e-4 of its max against jax.value_and_grad on the
    matching route ('kernel': the fused backward; 'plain': autograd through
    the plain version, both against K4's custom VJP in interpret mode)."""
    x, y = batch
    jl, want = _jax_value_and_grad(x, y, JAX_ROUTE[attn_impl])
    model = _port(attn_impl=_impl(attn_impl))
    model.train()
    with K.plain_versions(attn_impl == "plain"):
        loss = losses.cce_smooth(labels.label2vec(_t(y)), model(_t(x)))
        loss.backward()
    assert float(loss.detach()) == pytest.approx(jl, rel=1e-5)
    got = bridge.to_flax({n: p.grad for n, p in model.named_parameters()},
                         "swin")
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def test_swin_train_step_matches_jax_make_train_step(batch):
    """One full step on the K4 route (augmentation off, drop-path 0, clip
    1.0, Adam, the Swin's lr 1e-3) against make_train_step jitted on the
    'pallas' route: loss rtol 1e-5, Adam's first moments within 1e-4 of
    each leaf's max, parameters within rtol 1e-4, atol 1e-6 plus lr *
    |u(g_jax) - u(g_port)| (Adam's first update u(g) = g / (|g| + 1e-8),
    as in tests/test_torch_vit.py)."""
    x, y = batch
    lr = default_config("swin").train.learning_rate
    assert lr == 1e-3
    params, _ = _flax()
    tx = joptim.make_direction(clip_norm=1.0)
    state = jstep.TrainState(params=params, batch_stats={},
                             opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(_jax_swin("pallas"), jlosses.cce_smooth,
                                         tx, augment=False, jit=False))
    new_state, jl, _ = step(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.float32(lr))
    want = flatten_params({"params": new_state.params})
    jax_mu = {k: np.asarray(v) for k, v in flatten_params(
        {"params": new_state.opt_state[1].mu}).items()}

    model = _port()
    ts = TrainState(model, optim.Adam(model.parameters(), 1.0), 0,
                    torch.Generator().manual_seed(0),
                    torch.Generator().manual_seed(1))
    loss, probs = make_train_step(model, losses.cce_smooth, augment=False)(
        ts, _t(x), _t(y), lr)
    assert ts.step == 1 and probs.shape == (2, 32, 20, 3)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    got = bridge.to_flax(model.state_dict(), "swin")
    port_g = bridge.to_flax({n: p.grad for n, p in model.named_parameters()},
                            "swin")
    port_mu = bridge.to_flax({n: m for (n, _), m in
                              zip(model.named_parameters(), ts.opt.mu)}, "swin")
    assert set(got) == set(want)

    def u(g):
        return g / (np.abs(g) + 1e-8)

    for k, w in want.items():
        w = np.asarray(w)
        assert (np.abs(port_mu[k] - jax_mu[k]).max()
                <= 1e-4 * np.abs(jax_mu[k]).max()), k
        slack = lr * np.abs(u(jax_mu[k] / 0.1) - u(port_g[k]))
        assert np.all(np.abs(got[k] - w) <= 1e-6 + 1e-4 * np.abs(w) + slack), k


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _tiny_swin_cfg(**train):
    cfg = default_config("swin")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, img_size=(32, 20),
                                  swin_embed_dim=16, swin_depths=(2, 2, 2),
                                  swin_heads=(2, 4, 8), window=(2, 5)),
        train=dataclasses.replace(cfg.train, **train))


def test_swin_trainer_fit_tiny_on_cpu():
    """Trainer.fit on the tiny Swin at its config (drop-path 0.1, lr 1e-3,
    augmentation on), K4's plain versions: finite loss and metrics, the
    weights moved."""
    cfg = _tiny_swin_cfg(batch_size=4, eval_every_epochs=1)
    assert cfg.model.drop_path_rate == 0.1
    ds = Dataset.synthetic(n_train=8, n_test=4, height=32, width=20,
                           device="cpu")
    trainer = Trainer(cfg, ds, device="cpu")
    assert trainer.state.drop_gen is not None
    before = trainer.model.head.weight.detach().clone()
    table = trainer.model.backbone.layer0_block1.attn.relative_position_bias_table
    table0 = table.detach().clone()
    summary = trainer.fit(1)
    assert trainer.state.step == 2 and np.isfinite(trainer.last_epoch["loss"])
    assert summary and all(np.isfinite(v) for v in summary.values())
    assert not torch.equal(trainer.model.head.weight, before)
    assert not torch.equal(table, table0)


def test_cli_builds_the_swin():
    args = cli.make_parser().parse_args(
        ["train", "--model", "swin", "--synthetic", "--bf16", "--epochs", "1"])
    cfg = cli.build_config(args)
    assert cfg.model.name == "swin" and cfg.train.batch_size == 32
    assert cfg.train.learning_rate == 1e-3 and cfg.train.clip_global_norm == 1.0
    m = build_model(dataclasses.replace(cfg.model, swin_depths=(1, 1, 1, 1)))
    assert isinstance(m, swin.SwinSegmenter) and m.family == "swin"
    assert m.compute_dtype == torch.bfloat16 and m.img_size == (256, 80)
    attn = [mod for mod in m.modules() if isinstance(mod, swin.WindowAttention)]
    assert [a.attn_impl for a in attn] == ["kernel"] * 4     # 'auto'
    assert m.backbone.proj.weight.shape == (96, 10, 4, 4)
    last = m.backbone.layer3_block0
    assert last.window == (3, 3) and last.shift == 0 and last.padded == (9, 3)
    assert build_model(dataclasses.replace(
        cfg.model, swin_attn_impl="xla")).backbone.layer0_block0.attn.attn_impl \
        == "composed"


def test_serve_swin_without_params_refuses():
    with pytest.raises(SystemExit, match="--params"):
        cli.main(["serve", "--model", "swin", "--device", "cpu"])


def test_serve_swin_builds_from_npz(tmp_path, monkeypatch):
    """cli's serving model for --model swin loads a flax-layout Swin npz
    through the bridge (the default config cut to the tiny one here)."""
    tiny = _tiny_swin_cfg()
    monkeypatch.setattr(cli, "default_config", lambda name: tiny)
    path = str(tmp_path / "swin.npz")
    np.savez(path, **bridge.random_flax_variables(build_model(tiny.model), 1))
    served = cli.build_serving_model(path, True, torch.device("cpu"), "swin")
    assert isinstance(served, swin.SwinSegmenter) and not served.training
    assert served.compute_dtype == torch.bfloat16
    x = np.random.default_rng(0).standard_normal((2, 32, 20, 10))
    probs = cli.make_forward(served, torch.device("cpu"))(x)
    assert probs.shape == (2, 32, 20, 3) and np.isfinite(probs).all()
