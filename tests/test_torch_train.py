"""PyTorch port vs the JAX package on the train path: labels, loss, the
optimizer, each augmentation op, the train-mode BatchNorm, the dataset
cursor, synthetic data, metrics, and the tiny TransUNet train step as a
whole (loss, every parameter gradient, and one full optimizer step) on the
same bridged weights.  Inputs come from numpy seeds; JAX runs K2 (and K3)
in interpret mode, the port their plain versions (CPU tensors)."""

import dataclasses
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ultrasound_modeling_tpu.config import default_config
from ultrasound_modeling_tpu.data import augment as jaug
from ultrasound_modeling_tpu.data import labels as jlabels
from ultrasound_modeling_tpu.data import synthetic as jsynthetic
from ultrasound_modeling_tpu.data.pipeline import Dataset as JaxDataset
from ultrasound_modeling_tpu.models import resnest as jresnest
from ultrasound_modeling_tpu.models.transunet import TransUNet as JaxTransUNet
from ultrasound_modeling_tpu.train import losses as jlosses
from ultrasound_modeling_tpu.train import metrics as jmetrics
from ultrasound_modeling_tpu.train import optim as joptim
from ultrasound_modeling_tpu.train import step as jstep
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.data import augment, labels, synthetic
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.models.common import BatchNorm
from ultrasound_modeling_tpu_torch.models.transunet import TransUNet
from ultrasound_modeling_tpu_torch.train import losses, metrics, optim
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.train.step import TrainState, make_train_step
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge

TINY = dict(num_classes=3, hidden_size=64, num_heads=4, num_layers=2,
            mlp_dim=128, grid=(4, 5), radix=2, kpaths=2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _labels(rng, shape):
    """Soft labels around {0, 1, 2}, with values on both sides of the 0.95
    and 1.05 thresholds."""
    return rng.choice([0.0, 0.5, 0.95, 0.96, 1.0, 1.04, 1.05, 1.3, 2.0, 2.4],
                      size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# labels, loss, optimizer, metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [3, 2])
def test_label2vec_matches_jax(rng, num_classes):
    """Exact (the same comparisons and one subtraction)."""
    lab = _labels(rng, (2, 16, 8))
    want = np.asarray(jlabels.label2vec(jnp.asarray(lab), num_classes))
    np.testing.assert_array_equal(
        labels.label2vec(_t(lab), num_classes).numpy(), want)


def test_cce_smooth_matches_jax(rng):
    """rtol 1e-6: the same float32 ops, summed in another order."""
    y = np.asarray(jlabels.label2vec(jnp.asarray(_labels(rng, (3, 16, 8)))))
    logits = rng.normal(size=(3, 16, 8, 3)) * 4
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    probs[0, 0, 0] = [1.0, 0.0, 0.0]           # exercises the clip at 1e-7
    want = float(jlosses.cce_smooth(jnp.asarray(y), jnp.asarray(probs)))
    got = float(losses.cce_smooth(_t(y), _t(probs)))
    assert got == pytest.approx(want, rel=1e-6)


def test_clip_and_adam_three_steps_match_optax(rng):
    """Three steps of clip-by-global-norm(1.0) + Adam + ``p -= lr * u``
    against optim.make_direction (optax) and the JAX step's lr update; the
    first step's gradients are large (clipped), the last small (not).
    rtol 1e-5, atol 1e-7: the same float32 ops in another order."""
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * k).astype(np.float32) for s in shapes]
             for k in (3.0, 0.5, 0.01)]
    lrs = (1e-2, 3e-3, 1e-2)

    tx = joptim.make_direction(clip_norm=1.0)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        u, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda a: -lr * a, u))

    tp = [torch.nn.Parameter(_t(p)) for p in params]
    opt = optim.Adam(tp, clip_norm=1.0)
    for g, lr in zip(grads, lrs):
        for p, a in zip(tp, g):
            p.grad = _t(a)
        opt.step(lr)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


def test_piecewise_constant_matches_jax():
    tc = default_config("transunet").train
    want = joptim.piecewise_constant(tc.learning_rate, tc.lr_boundaries,
                                     tc.lr_values)
    got = optim.piecewise_constant(tc.learning_rate, tc.lr_boundaries,
                                   tc.lr_values)
    for step in (0, 1, 1999, 2000, 2001, 4001, 9999, 15000, 15001, 99999):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6)


def test_metrics_match_jax(rng):
    """Counts, confusion, AUC histograms and the summary, rtol 1e-6."""
    y = np.asarray(jlabels.label2vec(jnp.asarray(_labels(rng, (2, 16, 8)))))
    p = rng.dirichlet(np.ones(3), size=(2, 16, 8)).astype(np.float32)
    js = jmetrics.update(jmetrics.zeros(3), jnp.asarray(y), jnp.asarray(p),
                         jnp.float32(2.5))
    ts = metrics.update(metrics.zeros(3), _t(y), _t(p), torch.tensor(2.5))
    ts = ts + metrics.update(metrics.zeros(3), _t(y), _t(p), torch.tensor(0.5))
    js = js + jmetrics.update(jmetrics.zeros(3), jnp.asarray(y),
                              jnp.asarray(p), jnp.float32(0.5))
    want = {k: float(v) for k, v in jmetrics.summarize(js).items()}
    got = metrics.summarize(ts)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k


# ---------------------------------------------------------------------------
# augmentation, op by op, with the parameters the JAX keys draw
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    raw = jsynthetic.make_raw_array(3, seed=4, height=64, width=40)
    return raw[:, 0, :, :, 1:-1], raw[:, 0, :, :, 0]


def _jax_batch(fn, *arrays):
    out = jax.vmap(fn)(*(jnp.asarray(a) for a in arrays))
    return tuple(np.asarray(o) for o in out)


def test_erode_brain_matches_jax(frames):
    """iters 0, 3 and 8 (the range t % 7 + 2 spans, and off); exact."""
    x, y = frames
    iters = np.array([0, 3, 8], np.int32)
    want = _jax_batch(jaug.erode_brain, x, y, iters)
    got = augment.erode_brain(_t(x), _t(y), torch.from_numpy(iters))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_cutout_matches_jax(frames):
    """Parameters drawn as augment.cutout draws them from its key; exact."""
    x, y = frames
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    want = _jax_batch(jaug.cutout, keys, x, y)
    h, w = y.shape[1:]
    params = []
    for lo, hi, i in ((0, h + 1, 0), (0, w + 1, 1), (20, 41, 2), (10, 21, 3)):
        params.append(torch.tensor([int(jax.random.randint(
            jax.random.split(k, 4)[i], (), lo, hi)) for k in keys]))
    got = augment.cutout(_t(x), _t(y), *params)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)


def test_shift_matches_jax(frames):
    """Index shift with zero fill vs the JAX 0/1 permutation matmuls at
    HIGHEST precision (exact), parameters drawn from the same keys."""
    x, y = frames
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    want = _jax_batch(jaug.shift, keys, x, y)
    sr, sc = [], []
    for k in keys:
        kr, kc, kd = jax.random.split(k, 3)
        sign = 1 if int(jax.random.randint(kd, (), 0, 2)) == 1 else -1
        sr.append(sign * int(jax.random.randint(kr, (), 0, 31)))
        sc.append(sign * int(jax.random.randint(kc, (), 0, 13)))
    got = augment.shift(_t(x), _t(y), torch.tensor(sr), torch.tensor(sc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_noise_and_flip_match_jax(frames):
    """The same N(0, 1) draws through both; the flip is exact."""
    x, y = frames
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    noise = np.stack([np.asarray(jax.random.normal(k, x.shape[1:]))
                      for k in keys])
    want = np.asarray(jax.vmap(jaug.gaussian_noise)(keys, jnp.asarray(x)))
    np.testing.assert_allclose(
        augment.gaussian_noise(_t(x), _t(noise)).numpy(), want, rtol=0,
        atol=1e-7)
    want = _jax_batch(jaug.hflip, x, y)
    for g, w in zip(augment.hflip(_t(x), _t(y)), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_augment_batch_draws_from_its_generator(frames):
    """The same generator seed gives the same batch; the result keeps the
    shapes, and labels stay within [0, max label]."""
    x, y = frames
    outs = [augment.augment_batch(_t(x), _t(y),
                                  torch.Generator().manual_seed(3), flip=True)
            for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][0].shape == x.shape and outs[0][1].shape == y.shape
    assert float(outs[0][1].min()) >= 0 and float(outs[0][1].max()) <= y.max()
    im, lb = augment.augment_sample(_t(x[0]), _t(y[0]),
                                    torch.Generator().manual_seed(3))
    assert im.shape == x.shape[1:] and lb.shape == y.shape[1:]


# ---------------------------------------------------------------------------
# train-mode BatchNorm, dataset, synthetic data
# ---------------------------------------------------------------------------

def test_batchnorm_train_matches_flax(rng):
    """Batch statistics (fast variance, biased), the normalized output, its
    gradients and the running-statistic update against flax nn.BatchNorm
    (momentum 0.99, eps 1e-3) in train mode; rtol 1e-5, atol 1e-6."""
    x = (rng.normal(size=(4, 6, 5, 8)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(8,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(8,))).astype(np.float32)
    ra_mean = (0.1 * rng.normal(size=(8,))).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}

    def jloss(params, xx):
        out, upd = bn.apply({"params": params, "batch_stats": v["batch_stats"]},
                            xx, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out)), (out, upd["batch_stats"])

    (_, (jout, jstats)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    m = BatchNorm(8)
    m.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                       "running_mean": _t(ra_mean), "running_var": _t(ra_var)})
    xt = _t(x).requires_grad_()
    out = m.train()(xt)
    gx, gw, gb = torch.autograd.grad(out.sin().sum(), (xt, m.weight, m.bias))
    kw = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **kw)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(jstats["mean"]), **kw)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(jstats["var"]), **kw)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg["scale"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jg["bias"]), rtol=1e-4, atol=1e-5)
    before = m.running_mean.clone()
    m.eval()(xt)
    assert torch.equal(m.running_mean, before)


def test_dataset_cursor_matches_jax():
    """next_train / next_test with and without ``fix``: the same batches,
    terminators and cursors, including the tail window of a short batch."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(11, 4, 3, 2)).astype(np.float32)
    y = rng.normal(size=(11, 4, 3)).astype(np.float32)
    xt, yt = x[:5], y[:5]
    jd = JaxDataset(x, y, xt, yt)
    td = Dataset(x, y, xt, yt, device="cpu")
    calls = [("train", 4, False), ("train", 4, True), ("train", 4, False),
             ("train", 4, False), ("train", 4, False), ("test", 2, False),
             ("test", 2, False), ("test", 2, False), ("train", 3, False)]
    for kind, bs, fix in calls:
        if kind == "train":
            jb, tb = jd.next_train(bs, fix), td.next_train(bs, fix)
        else:
            jb, tb = jd.next_test(bs), td.next_test(bs)
        np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
        np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
        assert tb[2] == jb[2]
        assert (td.idx_tr, td.idx_te) == (jd.idx_tr, jd.idx_te)


def test_synthetic_arrays_match_jax_bit_for_bit():
    want = jsynthetic.make_raw_array(3, seed=11, height=64, width=40)
    got = synthetic.make_raw_array(3, seed=11, height=64, width=40)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    jd = JaxDataset.synthetic(4, 2, seed=2, height=32, width=16)
    td = Dataset.synthetic(4, 2, seed=2, height=32, width=16, device="cpu")
    for name in ("x_tr", "y_tr", "x_te", "y_te"):
        assert np.array_equal(getattr(td, name).numpy(),
                              np.asarray(getattr(jd, name))), name


# ---------------------------------------------------------------------------
# the slice as a whole: tiny TransUNet train step vs JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_batch():
    raw = jsynthetic.make_raw_array(2, seed=3, height=64, width=80)
    return raw[:, 0, :, :, 1:-1], raw[:, 0, :, :, 0]


@pytest.fixture(scope="module")
def tiny_variables(tiny_batch):
    """flax init PRNGKey(0) of the tiny config (as test_torch_transunet)."""
    x, _ = tiny_batch
    v = jax.jit(JaxTransUNet(**TINY).init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), False)
    return jax.tree.map(np.asarray, dict(v))


@pytest.fixture(scope="module")
def pallas_norm():
    """JAX's train lowering of the branch norm through K2 (interpret mode
    off the TPU, where 'auto' would pick the einsum lowering)."""
    jresnest.set_norm_impl("pallas")
    yield
    jresnest.set_norm_impl("auto")


def _jax_value_and_grad(variables, x, y, impl):
    """(loss, flat gradients, flat batch_stats after the forward)."""
    model = JaxTransUNet(**TINY, attn_train_impl=impl)

    def loss_of(params):
        probs, upd = model.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), True, mutable=["batch_stats"])
        return jlosses.cce_smooth(jlabels.label2vec(jnp.asarray(y)), probs), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])
    flat = {k: np.asarray(v) for k, v in flatten_params({"params": grads}).items()}
    stats = flatten_params({"batch_stats": upd["batch_stats"]})
    return float(loss), flat, {k: np.asarray(v) for k, v in stats.items()}


def _port_model(variables, attn_train_impl):
    m = TransUNet(**TINY, attn_train_impl=attn_train_impl)
    m.load_state_dict(bridge.from_flax(flatten_params(variables)), strict=True)
    return m.train()


# Leaves whose exact gradient is 0: a bias right before a train-mode
# BatchNorm (the batch mean removes it) and the attention's key bias (the
# row softmax is invariant to it).  Both frameworks return rounding noise
# there, so the checks hold them to |g| <= 1e-6 * (largest gradient).
ZERO_GRAD = re.compile(
    r"(decoder/block_\d/conv\d_\d|hybrid/convtmp_\d)/bias$|attn/key_bias$")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_tiny_train_loss_and_grads_match_jax(tiny_batch, tiny_variables,
                                             pallas_norm, impl):
    """Train-mode loss and all 218 parameter gradients of the tiny
    TransUNet (batch 2) against jax.value_and_grad, with JAX running K2 (and
    K3 under 'flash') in interpret mode and the port their plain versions;
    the BatchNorm running statistics after the forward too.  Loss rtol
    1e-5; each gradient leaf max|diff| <= 1e-4 * max|g_jax| (float32
    convolutions and sums in other orders through the whole network), the
    exactly-zero leaves (ZERO_GRAD) <= 1e-6 * the largest gradient."""
    x, y = tiny_batch
    jl, want, stats = _jax_value_and_grad(tiny_variables, x, y, impl)
    model = _port_model(tiny_variables, "flash" if impl == "flash" else "composed")
    loss = losses.cce_smooth(labels.label2vec(_t(y)), model(_t(x)))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jl, rel=1e-5)
    got = bridge.to_flax({n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(want) and len(got) == 218
    gmax = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if ZERO_GRAD.search(k):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-6 * gmax, k
        else:
            assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    sd = bridge.to_flax(model.state_dict())
    for k, w in stats.items():
        np.testing.assert_allclose(sd[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def test_tiny_train_step_matches_jax_make_train_step(tiny_batch,
                                                     tiny_variables,
                                                     pallas_norm):
    """One full step (augmentation off: label2vec, forward, cce_smooth,
    backward, clip 1.0, Adam, lr 1e-2) against the JAX package's
    make_train_step(augment=False, jit=False), jitted here.

    Adam's first moments (0.1 * the clipped gradient) agree within 1e-4 of
    each leaf's largest (the gradients' bound above), the running statistics
    within rtol 1e-4, atol 1e-6.  Every parameter agrees within rtol 1e-4,
    atol 1e-6 plus what the two steps' gradients explain: Adam's first update
    is u(g) = g / (|g| + 1e-8) on the clipped gradient g, so a weight may
    differ by lr * |u(g_jax) - u(g_port)| more, which only matters where g is
    near 1e-8 (the gradients are clipped by a global norm of ~1e5 here).
    Each side's g is its own: the port's from ``.grad``, JAX's from its
    first moment."""
    x, y = tiny_batch
    lr = 1e-2
    jmodel = JaxTransUNet(**TINY)
    tx = joptim.make_direction(clip_norm=1.0)
    state = jstep.TrainState(params=tiny_variables["params"],
                             batch_stats=tiny_variables["batch_stats"],
                             opt_state=tx.init(tiny_variables["params"]),
                             step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(jmodel, jlosses.cce_smooth, tx,
                                         augment=False, jit=False))
    new_state, jl, _ = step(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.float32(lr))
    want = flatten_params({"params": new_state.params,
                           "batch_stats": new_state.batch_stats})

    model = _port_model(tiny_variables, "composed")
    ts = TrainState(model, optim.Adam(model.parameters(), 1.0), 0,
                    torch.Generator().manual_seed(0))
    loss, probs = make_train_step(model, losses.cce_smooth, augment=False)(
        ts, _t(x), _t(y), lr)
    assert ts.step == 1 and probs.shape == (2, 64, 80, 3)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    got = bridge.to_flax(model.state_dict())
    assert set(got) == set(want)
    port_grads = bridge.to_flax({n: p.grad for n, p in model.named_parameters()})
    port_mu = bridge.to_flax({n: m for (n, _), m in
                              zip(model.named_parameters(), ts.opt.mu)})
    jax_mu = {k: np.asarray(v) for k, v in flatten_params(
        {"params": new_state.opt_state[1].mu}).items()}

    def u(g):
        return g / (np.abs(g) + 1e-8)

    for k, w in want.items():
        w = np.asarray(w)
        if k not in jax_mu:   # running statistics
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
            continue
        if not ZERO_GRAD.search(k):
            assert (np.abs(port_mu[k] - jax_mu[k]).max()
                    <= 1e-4 * np.abs(jax_mu[k]).max()), k
        slack = lr * np.abs(u(jax_mu[k] / 0.1) - u(port_grads[k]))
        assert np.all(np.abs(got[k] - w) <= 1e-6 + 1e-4 * np.abs(w) + slack), k


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def test_trainer_fit_tiny_on_cpu():
    """Trainer.fit on a tiny config with augmentation: two epochs of the
    cursor loop with evaluation each epoch end with finite metrics, and the
    BatchNorm running statistics moved."""
    cfg = default_config("transunet")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, img_size=(64, 80), **TINY,
                                  attn_train_impl="flash"),
        train=dataclasses.replace(cfg.train, batch_size=4,
                                  eval_every_epochs=1))
    ds = Dataset.synthetic(n_train=10, n_test=4, height=64, width=80,
                           device="cpu")
    trainer = Trainer(cfg, ds, device="cpu")
    before = trainer.model.hybrid.convtmp_1bn.BatchNorm_0.running_var.clone()
    summary = trainer.fit(2)
    assert trainer.iteration == 6 and trainer.state.step == 6
    assert np.isfinite(trainer.last_epoch["loss"])
    assert summary and all(np.isfinite(v) for v in summary.values())
    assert not torch.equal(
        trainer.model.hybrid.convtmp_1bn.BatchNorm_0.running_var, before)


def test_cli_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for machines without")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--synthetic", "--device", "cuda"])
    args = cli.make_parser().parse_args(
        ["train", "--synthetic", "--bf16", "--attn-train", "flash",
         "--batch-size", "8", "--epochs", "3", "--seed", "5"])
    cfg = cli.build_config(args)
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.model.attn_train_impl == "flash"
    assert (cfg.train.batch_size, cfg.train.epochs, cfg.train.seed) == (8, 3, 5)
