"""PyTorch port vs the JAX package on what the two U-Net families train
with: the four losses beside ``cce_smooth``, the dual-rate Adam against
optax's ``multi_transform``, the Trainer's per-loss and per-family rules,
``one_hot_labels``, and the data path at the two families' shapes.  Also
the helpers ``tests/test_torch_resnest_unet.py`` and
``tests/test_torch_mobileunet.py`` share: flax variables with every bias
and running statistic redrawn, JAX's dropout masks, and both Trainers'
first step on the same weights, batch and masks.

The train-path references run JAX in float64 (``jax.enable_x64``; the
ResNeSt stages keep the float32 statistics JAX writes explicitly).  At
these sizes a few ReLU inputs lie within float32 noise of 0, and where two
float32 forwards round one to opposite signs a whole pixel's gradient
moves: JAX's own float32 gradients sit up to 8-15% of a leaf's largest
value from its float64 ones (the ResNeStUNet's ``upsample_2`` kernel, the
MobileUNet's ``block_3``; the MobileUNet's fast-variance BatchNorms over
8-32 values a channel make its forward the noisier).  So the gradients
and the Trainer step are held with both programs in float64, which
measures the distance between the two programs, not between two float32
roundings; the port's float32 gradients are held to JAX's float64 ones
where float32 is that well conditioned (the ResNeStUNet)."""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ultrasound_modeling_tpu.config import default_config as jax_default_config
from ultrasound_modeling_tpu.data import augment as jaug
from ultrasound_modeling_tpu.data import labels as jlabels
from ultrasound_modeling_tpu.data import synthetic as jsynthetic
from ultrasound_modeling_tpu.data.pipeline import Dataset as JaxDataset
from ultrasound_modeling_tpu.train import losses as jlosses
from ultrasound_modeling_tpu.train import optim as joptim
from ultrasound_modeling_tpu.train.loop import Trainer as JaxTrainer
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch.config import default_config
from ultrasound_modeling_tpu_torch.data import augment, labels, synthetic
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.models.common import set_dropout_masks
from ultrasound_modeling_tpu_torch.train import losses, optim
from ultrasound_modeling_tpu_torch.train.loop import (
    Trainer, loss_for, optimizer_for)
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# helpers shared with the two family files
# ---------------------------------------------------------------------------

def flax_variables(jmodel, x, seed):
    """flax init ``PRNGKey(seed)`` of ``jmodel`` on ``x``, then every bias
    redrawn (N(0, 0.1)) and every running statistic (means N(0, 0.1),
    variances U(0.5, 1.5)) from numpy ``seed``, so no leaf sits at its
    trivial init.  Returns (nested variables, flat npz-layout dict)."""
    v = jax.jit(jmodel.init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)}, jnp.asarray(x), False)
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = str(path[-1].key)
        if name.endswith("bias") or name.endswith("mean"):
            return jnp.asarray(rng.normal(size=a.shape, scale=0.1), a.dtype)
        if name.endswith("var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        return a

    v = jax.tree_util.tree_map_with_path(redraw, dict(v))
    flat = {k: np.asarray(a) for k, a in flatten_params(v).items()}
    return v, flat


def to64(tree):
    """Every float leaf as float64 (call inside ``jax.enable_x64``)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def port64(model):
    """``model`` with float64 params, buffers and compute dtype."""
    model.compute_dtype = torch.float64
    return model.double()


def port_model(model, flat):
    model.load_state_dict(bridge.from_flax(flat, model.family), strict=True)
    return model


def dropout_masks(jmodel, variables, x, key):
    """JAX's keep masks for a train-mode forward drawing from ``key``, read
    from ``capture_intermediates`` (a Dropout's output is 0 exactly where
    it dropped; its BatchNorm input is almost surely not), keyed by the
    port's module names; with the train-mode probabilities and the running
    statistics after the forward (flat)."""
    probs, upd = jax.jit(functools.partial(
        jmodel.apply, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout)),
        static_argnums=(2,))(variables, jnp.asarray(x), True,
                             rngs={"dropout": key})
    masks = {}
    for k, out in flatten_params(upd["intermediates"]).items():
        masks[".".join(k.split("/")[:-2])] = torch.from_numpy(
            np.asarray(out) != 0)
    stats = {k: np.asarray(a, np.float32) for k, a in
             flatten_params({"batch_stats": upd["batch_stats"]}).items()}
    return masks, np.asarray(probs, np.float32), stats


def unet_cfg(family, img_size, **model):
    """The family's default config at ``img_size``, augmentation off (JAX's
    and torch's random streams differ), batch 4."""
    cfg = default_config(family)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, img_size=img_size, **model),
        data=dataclasses.replace(cfg.data, augment=False),
        train=dataclasses.replace(cfg.train, batch_size=4))


def first_trainer_steps(family, img_size, variables, flat, x, y, **model):
    """One step of the JAX ``Trainer`` and of the port's, both in float64,
    each as its Trainer builds it (loss, optimizer rule, lr at iteration 0)
    for the family's default config at ``img_size``, on the same weights,
    batch and dropout masks.  Returns (jax new state as numpy, jax loss,
    port Trainer, port loss)."""
    jcfg = jax_default_config(family)
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, img_size=img_size, **model),
        data=dataclasses.replace(jcfg.data, augment=False),
        train=dataclasses.replace(jcfg.train, batch_size=x.shape[0]))
    h, w = img_size
    jds = JaxDataset.synthetic(n_train=4, n_test=4, height=h, width=w,
                               n_disp=x.shape[-1])
    with jax.enable_x64(True):
        jtr = JaxTrainer(jcfg, jds)
        v64 = to64(variables)
        state = jtr.state.replace(params=v64["params"],
                                  batch_stats=v64["batch_stats"],
                                  opt_state=jtr.tx.init(v64["params"]))
        key = jax.random.split(jax.random.fold_in(state.rng, state.step))[1]
        masks, _, _ = dropout_masks(jtr.model, v64, x, key)
        lr = jtr.current_lr()
        new_state, jl, _ = jtr.train_step(
            state, jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
            jnp.float32(lr))
        new_state = jax.tree.map(np.asarray, new_state)

    ds = Dataset.synthetic(n_train=4, n_test=4, height=h, width=w,
                           n_disp=x.shape[-1], device="cpu")
    tr = Trainer(unet_cfg(family, img_size, **model), ds, device="cpu")
    port64(port_model(tr.model, flat))
    tr.state.opt = optimizer_for(family, tr.cfg.train)(tr.model)
    set_dropout_masks(tr.model, masks)
    assert tr.current_lr() == pytest.approx(lr, rel=1e-7)
    loss, _ = tr.train_step(tr.state, _t(x).double(), _t(y),
                            tr.current_lr())
    return new_state, float(jl), tr, float(loss)


def check_grads(got, want, zero_grad):
    """Each gradient leaf within 1e-4 of its largest |g| (as
    tests/test_torch_train.py holds the TransUNet); the leaves whose exact
    gradient is 0 (``zero_grad``: biases right before a train-mode
    BatchNorm) within 1e-6 of the largest gradient."""
    assert set(got) == set(want)
    gmax = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if zero_grad and zero_grad.search(k):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-6 * gmax, k
        else:
            assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def check_trainer_step(new_state, tr, b1, zero_grad):
    """The port's step against JAX's: the gradients (JAX's from its first
    moment, ``(1 - b1) * g`` after one step), Adam's first moments within
    1e-4 of each leaf's max, the running statistics within rtol 1e-4, atol
    1e-6, and every parameter within rtol 1e-4, atol 1e-6 plus what the two
    gradients explain, ``lr * scale * |u(g_jax) - u(g_port)|`` with Adam's
    first update ``u(g) = g / (|g| + 1e-8)`` (as in
    tests/test_torch_train.py)."""
    model = tr.model
    fam = model.family
    want = {k: np.asarray(v, np.float32) for k, v in flatten_params(
        {"params": new_state.params,
         "batch_stats": new_state.batch_stats}).items()}
    # Adam's first moments wherever optax keeps them: under the clip's
    # chain, or in a multi_transform group (the other group's leaves
    # masked out there)
    jax_mu = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            new_state.opt_state,
            is_leaf=lambda a: isinstance(a, optax.MaskedNode))[0]:
        names = [getattr(k, "name", None) for k in path]
        if "mu" not in names or isinstance(v, optax.MaskedNode):
            continue
        rest = path[names.index("mu") + 1:]
        jax_mu["/".join(["params"] + [str(k.key) for k in rest])] = \
            np.asarray(v, np.float32)
    got = bridge.to_flax(model.state_dict(), fam)
    assert set(got) == set(want)
    port_g = bridge.to_flax({n: p.grad for n, p in model.named_parameters()},
                            fam)
    port_mu = bridge.to_flax({n: m for (n, _), m in
                              zip(model.named_parameters(), tr.state.opt.mu)},
                             fam)
    assert set(jax_mu) == set(port_mu)
    check_grads(port_g, {k: m / (1 - b1) for k, m in jax_mu.items()},
                zero_grad)
    lr = tr.current_lr()

    def u(g):
        return g / (np.abs(g) + 1e-8)

    for k, w in want.items():
        if k not in jax_mu:   # running statistics
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            continue
        if not (zero_grad and zero_grad.search(k)):
            assert (np.abs(port_mu[k] - jax_mu[k]).max()
                    <= 1e-4 * np.abs(jax_mu[k]).max()), k
        scale = 0.1 if fam == "mobileunet" and "/encoder/" in f"/{k[7:]}" else 1.0
        slack = lr * scale * np.abs(u(jax_mu[k] / (1 - b1)) - u(port_g[k]))
        assert np.all(np.abs(got[k] - w) <= 1e-6 + 1e-4 * np.abs(w) + slack), k


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _soft_labels_and_probs(rng, shape=(3, 16, 8)):
    lab = rng.choice([0.0, 0.5, 0.95, 0.96, 1.0, 1.04, 1.05, 1.3, 2.0, 2.4],
                     size=shape).astype(np.float32)
    y = np.asarray(jlabels.label2vec(jnp.asarray(lab)))
    logits = rng.normal(size=shape + (3,)) * 4
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
             ).astype(np.float32)
    probs[0, 0, 0] = [1.0, 0.0, 0.0]          # exercises the clips at 1e-7
    return y, probs


@pytest.mark.parametrize("name,kw", [
    ("class_balanced", {}),
    ("factor_scaled", {}),
    ("factor_scaled", {"smoothing": 0.2, "class_factor": (0.5, 0.2, 0.3)}),
    ("pixelcnn", {}),
    ("pixelcnn", {"class_factor": (0.5, 0.2, 0.3)}),
    ("evaluator", {}),
    ("evaluator", {"class_factor": (1.0, 2.0, 3.0)}),
])
def test_losses_match_jax(rng, name, kw):
    """Each loss and its gradient with respect to the probabilities against
    the JAX package's, rtol 1e-5 (the same float32 ops summed in another
    order), under the JAX names of ``LOSSES``."""
    y, probs = _soft_labels_and_probs(rng)
    jfn = functools.partial(jlosses.get_loss(name), **kw)
    want, jgrad = jax.value_and_grad(lambda p: jfn(jnp.asarray(y), p))(
        jnp.asarray(probs))
    p = _t(probs).requires_grad_()
    got = functools.partial(losses.get_loss(name), **kw)(_t(y), p)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    g = np.asarray(jgrad)
    assert np.abs(p.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_loss_table_matches_jax():
    assert set(losses.LOSSES) == set(jlosses.LOSSES)
    assert losses.DEFAULT_CLASS_FACTOR == jlosses.DEFAULT_CLASS_FACTOR
    assert losses.EVAL_CLASS_FACTOR == jlosses.EVAL_CLASS_FACTOR
    with pytest.raises(KeyError, match="unknown loss"):
        losses.get_loss("dice")


def test_one_hot_labels_match_jax(rng):
    lab = rng.choice([-1.5, -0.5, 0.0, 0.5, 0.99, 1.0, 1.7, 2.0, 2.4, 3.0, 7.2],
                     size=(2, 16, 8)).astype(np.float32)
    for c in (2, 3):
        want = np.asarray(jlabels.one_hot_labels(jnp.asarray(lab), c))
        np.testing.assert_array_equal(
            labels.one_hot_labels(_t(lab), c).numpy(), want)


# ---------------------------------------------------------------------------
# the dual-rate Adam and the Trainer's rules
# ---------------------------------------------------------------------------

class _TwoPart(fnn.Module):
    """A flax tree with an ``encoder`` and a ``decoder_head`` top level."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(4, (3, 3), name="encoder")(x)
        return fnn.softmax(fnn.Conv(3, (1, 1), name="decoder_head")(x), -1)


class _TwoPartTorch(torch.nn.Module):
    def __init__(self, enc, dec):
        super().__init__()
        self.encoder = torch.nn.ParameterList(enc)
        self.decoder_head = torch.nn.ParameterList(dec)


def test_dual_rate_adam_three_steps_match_optax_multi_transform(rng):
    """Three steps of ``make_dual_rate_direction`` (two Adam groups, b1 0.5,
    no clip, the encoder's direction times 0.1) and ``p -= lr * u``, the
    first with large gradients (no clip to hide them): rtol 1e-5, atol
    1e-6 (a few float32 ulps of weights near 1, for the weights near 0)."""
    enc = [rng.normal(size=s).astype(np.float32) for s in ((3, 3, 2, 4), (4,))]
    dec = [rng.normal(size=s).astype(np.float32) for s in ((1, 1, 4, 3), (3,))]
    params = {"encoder": {"kernel": enc[0], "bias": enc[1]},
              "decoder_head": {"kernel": dec[0], "bias": dec[1]}}
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * k
                                     ).astype(np.float32), params)
             for k in (30.0, 0.5, 0.01)]
    lrs = (2e-3, 1e-3, 2e-3)
    tx = joptim.make_dual_rate_direction()
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda a: -lr * a, upd))

    m = _TwoPartTorch([torch.nn.Parameter(_t(a)) for a in enc],
                      [torch.nn.Parameter(_t(a)) for a in dec])
    opt = optim.dual_rate_adam(m)
    assert opt.clip_norm is None and opt.b1 == 0.5
    order = [("encoder", "kernel"), ("encoder", "bias"),
             ("decoder_head", "kernel"), ("decoder_head", "bias")]
    for g, lr in zip(grads, lrs):
        for p, (top, leaf) in zip(opt.params, order):
            p.grad = _t(g[top][leaf])
        opt.step(lr)
    for p, (top, leaf) in zip(opt.params, order):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[top][leaf]),
                                   rtol=1e-5, atol=1e-6, err_msg=top)


def test_adam_without_clip_matches_optax(rng):
    """``Adam(clip_norm=None)`` is optax's ``scale_by_adam`` alone (the
    class_balanced rule): gradients of global norm ~30 move every weight
    by ~lr, unscaled."""
    shapes = [(4, 3), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * k).astype(np.float32) for s in shapes]
             for k in (10.0, 0.1)]
    tx = joptim.make_direction(clip_norm=None)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in grads:
        u, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda a: -5e-3 * a, u))
    tp = [torch.nn.Parameter(_t(p)) for p in params]
    opt = optim.Adam(tp, clip_norm=None)
    for g in grads:
        for p, a in zip(tp, g):
            p.grad = _t(a)
        opt.step(5e-3)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


RULES = [
    ("transunet", "cce_smooth", 0.1, None),
    ("transunet", "cce_smooth", 0.2, None),
    ("resnest_unet", "class_balanced", 0.2, (0.5, 0.2, 0.3)),
    ("transunet", "factor_scaled", 0.1, None),
    ("transunet", "factor_scaled", 0.25, (0.5, 0.2, 0.3)),
    ("mobileunet", "pixelcnn", 0.1, None),
    ("mobileunet", "pixelcnn", 0.3, (0.4, 0.4, 0.2)),
    ("transunet", "evaluator", 0.1, (1.0, 2.0, 3.0)),
]


@functools.lru_cache(maxsize=None)
def _jax_trainer(family, loss, smoothing, class_factor):
    """The JAX Trainer of ``family``'s default config with these loss
    settings, over a two-part flax model (``encoder``, ``decoder_head``):
    its ``loss_fn`` and ``tx`` are the rules under test."""
    cfg = jax_default_config(family)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, loss=loss, label_smoothing=smoothing,
        class_factor=class_factor, batch_size=2))
    ds = JaxDataset.synthetic(n_train=2, n_test=2, height=8, width=4,
                              n_disp=cfg.model.in_channels)
    return JaxTrainer(cfg, ds, model=_TwoPart())


@pytest.mark.parametrize("family,loss,smoothing,class_factor", RULES)
def test_trainer_per_loss_rules_match_the_jax_trainer(
        rng, family, loss, smoothing, class_factor):
    """The port's Trainer rules (``loss_for``, ``optimizer_for``) against
    the JAX Trainer's own ``loss_fn`` and ``tx`` for the same config: the
    smoothing keyword (``label_smoothing=`` for cce_smooth, ``smoothing=``
    for factor_scaled, only when it is not 0.1), the class-factor override
    of the factor family, no clipping under class_balanced, the dual-rate
    Adam for the MobileUNet.  The loss on one batch rtol 1e-5; three
    optimizer steps with a large first gradient (a clip would show, and
    so would a wrong scale, b1 or group) rtol 1e-5, atol 1e-6 (a few
    float32 ulps of weights near 1, for the weights near 0)."""
    jtr = _jax_trainer(family, loss, smoothing, class_factor)
    tc = default_config(family).train
    tc = dataclasses.replace(tc, loss=loss, label_smoothing=smoothing,
                             class_factor=class_factor)
    y, probs = _soft_labels_and_probs(rng)
    want = float(jtr.loss_fn(jnp.asarray(y), jnp.asarray(probs)))
    assert float(loss_for(tc)(_t(y), _t(probs))) == pytest.approx(want,
                                                                 rel=1e-5)

    params = jax.tree.map(np.asarray, jtr.state.params)
    order = [("encoder", "kernel"), ("encoder", "bias"),
             ("decoder_head", "kernel"), ("decoder_head", "bias")]
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * k
                                     ).astype(np.float32), params)
             for k in (30.0, 0.5, 0.01)]
    jp = jax.tree.map(jnp.asarray, params)
    state = jtr.tx.init(jp)
    for g in grads:
        upd, state = jtr.tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda a: -1e-2 * a, upd))
    m = _TwoPartTorch([torch.nn.Parameter(_t(params["encoder"][k]))
                       for k in ("kernel", "bias")],
                      [torch.nn.Parameter(_t(params["decoder_head"][k]))
                       for k in ("kernel", "bias")])
    opt = optimizer_for(family, tc)(m)
    for g in grads:
        for p, (top, leaf) in zip(opt.params, order):
            p.grad = _t(g[top][leaf])
        opt.step(1e-2)
    for p, (top, leaf) in zip(opt.params, order):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[top][leaf]),
                                   rtol=1e-5, atol=1e-6, err_msg=top)


def test_trainer_refuses_weight_decay_naming_its_roadmap_item():
    cfg = unet_cfg("mobileunet", (64, 32))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, weight_decay=1e-4))
    ds = Dataset.synthetic(n_train=4, n_test=4, height=64, width=32,
                           n_disp=15, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        Trainer(cfg, ds, device="cpu")


# ---------------------------------------------------------------------------
# data at the two families' shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["resnest_unet", "mobileunet"])
def test_synthetic_data_matches_jax_at_the_family_shape(family):
    """``cli train --synthetic`` data of the family's default config
    (256x64, 6 or 15 displacement channels) bit for bit, and the dataset's
    shapes."""
    mc = default_config(family).model
    h, w = mc.img_size
    want = jsynthetic.make_raw_array(3, 7, h, w, mc.in_channels)
    got = synthetic.make_raw_array(3, 7, h, w, mc.in_channels)
    assert got.shape == (3, 1, h, w, mc.in_channels + 2)
    np.testing.assert_array_equal(got, want)
    ds = Dataset.synthetic(n_train=3, n_test=2, height=h, width=w,
                           n_disp=mc.in_channels, device="cpu")
    assert (ds.height, ds.width, ds.channel) == (h, w, mc.in_channels)


@pytest.mark.parametrize("family", ["resnest_unet", "mobileunet"])
def test_augment_ops_match_jax_at_the_family_shape(family):
    """Each augmentation op on 256x64 frames of the family's channel count,
    with the parameters the JAX keys draw, as tests/test_torch_train.py
    holds them at 64x40x10: erode, cutout, shift exact, noise atol 1e-7;
    then the whole batch augmentation keeps the shapes."""
    mc = default_config(family).model
    h, w = mc.img_size
    raw = jsynthetic.make_raw_array(3, 4, h, w, mc.in_channels)
    x, y = raw[:, 0, :, :, 1:-1], raw[:, 0, :, :, 0]
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def check(got, want):
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))

    iters = np.array([0, 3, 8], np.int32)
    check(augment.erode_brain(_t(x), _t(y), torch.from_numpy(iters)),
          jax.vmap(jaug.erode_brain)(jx, jy, jnp.asarray(iters)))
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    params = []
    for lo, hi, i in ((0, h + 1, 0), (0, w + 1, 1), (20, 41, 2), (10, 21, 3)):
        params.append(torch.tensor([int(jax.random.randint(
            jax.random.split(k, 4)[i], (), lo, hi)) for k in keys]))
    check(augment.cutout(_t(x), _t(y), *params),
          jax.vmap(jaug.cutout)(keys, jx, jy))
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    sr, sc = [], []
    for k in keys:
        kr, kc, kd = jax.random.split(k, 3)
        sign = 1 if int(jax.random.randint(kd, (), 0, 2)) == 1 else -1
        sr.append(sign * int(jax.random.randint(kr, (), 0, 31)))
        sc.append(sign * int(jax.random.randint(kc, (), 0, 13)))
    check(augment.shift(_t(x), _t(y), torch.tensor(sr), torch.tensor(sc)),
          jax.vmap(jaug.shift)(keys, jx, jy))
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    noise = np.stack([np.asarray(jax.random.normal(k, x.shape[1:]))
                      for k in keys])
    np.testing.assert_allclose(
        augment.gaussian_noise(_t(x), _t(noise)).numpy(),
        np.asarray(jax.vmap(jaug.gaussian_noise)(keys, jx)), rtol=0,
        atol=1e-7)
    ax, ay = augment.augment_batch(_t(x), _t(y),
                                   torch.Generator().manual_seed(0))
    assert ax.shape == x.shape and ay.shape == y.shape
    assert torch.isfinite(ax).all()
