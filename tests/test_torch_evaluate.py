"""PyTorch port vs the JAX package: ``infer/evaluate.py`` — the brain->bleed
cascade on the same brain (2-class) and bleed (3-class) TransUNets, the
batched and per-scan inference, and the numpy helpers (``class_counts``,
``group_by_path``, ``split_eval_file``, ``load_archive``) on the same
arrays.  The models are a tiny TransUNet (hidden 64, 2 layers, 64x80
frames), flax-initialized and loaded into the port through the bridge.

The helpers at the top (the tiny config, the JAX state, the port model on
its weights) serve the other serving-product test files too."""

import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu import config as jconfig
from ultrasound_modeling_tpu.infer import evaluate as jev
from ultrasound_modeling_tpu.models.registry import build_model as jbuild
from ultrasound_modeling_tpu.train import optim as joptim
from ultrasound_modeling_tpu.train import step as jstep
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch import config as tconfig
from ultrasound_modeling_tpu_torch.infer import evaluate as ev
from ultrasound_modeling_tpu_torch.models.registry import build_model
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge

H, W = 64, 80
# the tiny TransUNet of the JAX package's serving tests (tests/test_export.py)
TINY = dict(hidden_size=64, num_layers=2, num_heads=2, mlp_dim=64,
            grid=(4, 5), img_size=(H, W))
TOML = """
[model]
name = 'transunet'
hidden_size = 64
num_layers = 2
num_heads = 2
mlp_dim = 64
grid = [4, 5]
img_size = [64, 80]

[train]
batch_size = 32
eval_every_epochs = 1
"""
TOL = 2e-5   # f32 forwards, port vs JAX (the parity pins' tolerance)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads while a module runs: tier 1 runs six test
    processes on the CPU's cores, and torch's default of one thread a core
    in each oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_toml(directory) -> str:
    path = os.path.join(str(directory), "tiny.toml")
    with open(path, "w") as fh:
        fh.write(TOML)
    return path


def model_cfgs(num_classes: int = 3, compute_dtype: str = "float32"):
    """(JAX ModelConfig, port ModelConfig) of the tiny TransUNet."""
    kw = dict(TINY, num_classes=num_classes, compute_dtype=compute_dtype)
    return (dataclasses.replace(jconfig.default_config("transunet").model, **kw),
            dataclasses.replace(tconfig.default_config("transunet").model, **kw))


@functools.lru_cache(maxsize=None)
def jax_state(num_classes: int = 3, seed: int = 0):
    """(JAX model, TrainState, flat npz-layout variables) of the tiny
    TransUNet, flax-initialized from ``PRNGKey(seed)``."""
    jcfg, _ = model_cfgs(num_classes)
    model = jbuild(jcfg)
    tx = joptim.make_direction(clip_norm=1.0)
    state = jstep.TrainState.create(model, tx, jnp.zeros((1, H, W, 10)),
                                    jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_params(
        {"params": state.params, "batch_stats": state.batch_stats}).items()}
    return model, state, flat


def port_model(num_classes: int = 3, seed: int = 0,
               compute_dtype: str = "float32") -> torch.nn.Module:
    """The port's tiny TransUNet on :func:`jax_state`'s weights, eval."""
    _, mcfg = model_cfgs(num_classes, compute_dtype)
    m = build_model(mcfg)
    m.load_state_dict(bridge.from_flax(jax_state(num_classes, seed)[2]),
                      strict=True)
    return m.eval()


def jax_forward(num_classes: int = 3, seed: int = 0):
    model, state, _ = jax_state(num_classes, seed)
    fwd = jstep.make_forward(model)
    return lambda x: fwd(state, x)


def port_forward(num_classes: int = 3, seed: int = 0):
    m = port_model(num_classes, seed)
    return torch.no_grad()(lambda x: m(x))


def frames(n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, H, W, 10)).astype(
        np.float32)


def test_cascade_matches_jax():
    """The brain model's class-0 map rounded half to even, the input zeroed
    where it rounds to 1, then the bleed model: the same masks and bleed
    probabilities as JAX's ``make_cascade`` on the same models.

    Band rule: a pixel whose JAX p0 lies within 2e-5 of 0.5 may round
    either way, since the two forwards agree only to 2e-5 there.  Such
    pixels are counted and left out of the mask comparison; a frame with
    any of them that the two masks round differently has different bleed
    inputs, so its bleed probabilities are not compared.  Every other pixel
    must agree exactly, and every other frame within 2e-5."""
    x = frames(4)
    jcascade = jev.make_cascade(jax_forward(2, 2), jax_forward(3, 3),
                                return_mask=True)
    jprobs, jmask = (np.asarray(a) for a in jcascade(jnp.asarray(x)))
    jp0 = np.asarray(jax_forward(2, 2)(jnp.asarray(x)))[..., 0]
    brain, bleed = port_forward(2, 2), port_forward(3, 3)
    cascade = ev.make_cascade(brain, bleed, return_mask=True)
    tprobs, tmask = (t.numpy() for t in cascade(torch.from_numpy(x)))
    tp0 = brain(torch.from_numpy(x)).numpy()[..., 0]

    assert np.abs(tp0 - jp0).max() <= TOL      # the brain forward itself
    assert tmask.shape == jmask.shape == (4, H, W)
    assert set(np.unique(tmask)) <= {0.0, 1.0}
    assert 0.0 < jmask.mean() < 1.0, "the mask must keep and zero pixels"
    band = np.abs(jp0 - 0.5) <= TOL
    differ = tmask != jmask
    assert not (differ & ~band).any()
    print(f"cascade: {int(band.sum())} of {band.size} pixels in the 2e-5 band "
          f"around p0 = 0.5, {int(differ.sum())} rounded differently")
    same = ~differ.reshape(4, -1).any(1)
    assert same.sum() >= 1
    np.testing.assert_allclose(tprobs[same], jprobs[same], rtol=0, atol=TOL)
    assert tprobs.shape == (4, H, W, 3)


def test_cascade_without_mask_and_composite():
    x = torch.from_numpy(frames(2, seed=4))
    brain, bleed = port_forward(2, 2), port_forward(3, 3)
    probs = ev.make_cascade(brain, bleed)(x)
    with_mask, mask = ev.make_cascade(brain, bleed, return_mask=True)(x)
    assert torch.equal(probs, with_mask)
    want = np.asarray(jev.composite_probability(jnp.asarray(probs.numpy())))
    np.testing.assert_allclose(ev.composite_probability(probs).numpy(), want,
                               rtol=0, atol=1e-7)


def test_run_and_cardiac_inference_match_jax():
    """Per-scan groups of 3 and 1 frames at batch size 2: the final batch of
    each is zero-padded, and the probabilities match JAX's."""
    x = frames(4, seed=5)
    paths = np.array([["scanA"], ["scanA"], ["scanA"], ["scanB"]])
    got = ev.cardiac_inference(port_forward(), x, paths, batch_size=2,
                               device="cpu")
    want = jev.cardiac_inference(jax_forward(), x, paths, batch_size=2)
    assert [(p, a.shape) for p, a in got] == [(p, a.shape) for p, a in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    whole = ev.run_inference(port_forward(), x, batch_size=3, device="cpu")
    np.testing.assert_allclose(
        whole, np.concatenate([a for _, a in got]), rtol=0, atol=1e-6)


def test_run_inference_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev.run_inference(port_forward(), frames(1))


@pytest.mark.parametrize("num_classes", [2, 3])
def test_class_counts_equal_jax(num_classes):
    rng = np.random.default_rng(num_classes)
    probs = rng.random((H, W, num_classes)).astype(np.float32)
    truth = rng.choice([0.0, 0.4, 0.6, 0.96, 1.0, 1.04, 1.5, 1.6, 2.0],
                       size=(H, W)).astype(np.float32)
    got = ev.class_counts(probs, truth, num_classes)
    want = jev.class_counts(probs, truth, num_classes)
    assert got["pred_counts"] == want["pred_counts"]
    assert got["true_counts"] == want["true_counts"]
    assert got["confusion"].dtype == want["confusion"].dtype
    np.testing.assert_array_equal(got["confusion"], want["confusion"])


@pytest.mark.parametrize("shape", [(6, 1), (6,)])
def test_group_by_path_equals_jax(shape):
    paths = np.array(["a", "a", "b", "a", "c", "c"]).reshape(shape)
    assert ev.group_by_path(paths) == jev.group_by_path(paths)
    assert ev.group_by_path(paths) == [("a", 0, 2), ("b", 2, 3), ("a", 3, 4),
                                       ("c", 4, 6)]


def _raw(n: int = 3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(n, 1, 8, 6, 12)).astype(np.float32)
    raw[..., 0] = rng.uniform(0, 2, size=(n, 1, 8, 6))
    return raw


def test_split_eval_file_equals_jax():
    raw = _raw()
    for i in range(raw.shape[0]):
        for a, b in zip(ev.split_eval_file(raw, i), jev.split_eval_file(raw, i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_paths,five_d", [(True, True), (False, False)])
def test_load_archive_equals_jax(tmp_path, with_paths, five_d):
    raw = _raw(4, seed=1)
    np.save(tmp_path / "TestingData.npy", raw if five_d else raw[:, 0])
    if with_paths:
        np.save(tmp_path / "TestingPaths.npy",
                np.array([["p1"], ["p1"], ["p2"], ["p3"]]))
    got = ev.load_archive(str(tmp_path))
    want = jev.load_archive(str(tmp_path))
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == (4, 8, 6, 10)


def test_tiny_config_parses_the_same_on_both_sides():
    with tempfile.TemporaryDirectory() as d:
        path = write_toml(d)
        assert (dataclasses.asdict(tconfig.from_toml(path))
                == dataclasses.asdict(jconfig.from_toml(path)))
