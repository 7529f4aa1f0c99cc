"""PyTorch port vs the JAX package: the weight bridge and the TransUNet
forward at the tiny parity-pin config (benchmarks/make_parity_pins.py).

One jitted flax init serves the whole module; the port loads those exact
weights through ``utils/checkpoint.from_flax``.  On the CPU the port's
kernel wrappers run their plain PyTorch versions, so ``attn_impl='kernel'``
here exercises the serving dataflow (K4 at f32, K1 at bf16) with the
kernels' reference math."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.models import common as jax_common
from ultrasound_modeling_tpu.models.transunet import TransUNet as JaxTransUNet
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch.models.transunet import TransUNet
from ultrasound_modeling_tpu_torch.ops import kernels as K
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge

TINY = dict(num_classes=3, hidden_size=64, num_heads=4, num_layers=2,
            mlp_dim=128, grid=(4, 5), radix=2, kpaths=2)


@pytest.fixture(scope="module")
def pins():
    return np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "parity_pins.npz"))


@pytest.fixture(scope="module")
def flax_tiny(pins):
    """(flax model, variables, flat npz-layout dict) at PRNGKey(0), as the
    parity pin was made."""
    model = JaxTransUNet(**TINY)
    x = jnp.asarray(pins["transunet/x"])
    v = jax.jit(model.init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, False)
    flat = {k: np.asarray(a) for k, a in flatten_params(dict(v)).items()}
    return model, v, flat


def _port(flat, **kw):
    m = TransUNet(**TINY, **kw)
    m.load_state_dict(bridge.from_flax(flat), strict=True)
    return m.eval()


def test_bridge_round_trip_is_exact(flax_tiny):
    _, _, flat = flax_tiny
    back = bridge.to_flax(bridge.from_flax(flat))
    assert set(back) == set(flat)
    for k, a in flat.items():
        assert back[k].shape == a.shape, k
        assert np.array_equal(back[k], a), k


def test_bridge_covers_every_leaf(flax_tiny):
    """218 params + 52 batch_stats leaves load strictly into the port's tree
    (no missing or unexpected keys), with the scan-stacked layers split."""
    _, _, flat = flax_tiny
    assert sum(k.startswith("params/") for k in flat) == 218
    assert sum(k.startswith("batch_stats/") for k in flat) == 52
    sd = bridge.from_flax(flat)
    assert set(sd) == set(TransUNet(**TINY).state_dict())
    assert sd["encoder.blocks.1.attn.query.weight"].shape == (64, 64)
    assert np.array_equal(
        sd["encoder.blocks.1.attn.query.weight"].numpy(),
        flat["params/encoder/blocks/block/attn/query_kernel"][1].T)


def test_npz_save_load_round_trip(flax_tiny, tmp_path):
    _, _, flat = flax_tiny
    sd = bridge.from_flax(flat)
    path = str(tmp_path / "p.npz")
    bridge.save_params_npz(sd, path)
    with np.load(path) as arch:
        assert set(arch.files) == set(flat)
    again = bridge.load_params_npz(path)
    for k, t in sd.items():
        assert torch.equal(again[k], t), k


@pytest.mark.parametrize("attn_impl", ["kernel", "composed"])
def test_f32_forward_reproduces_parity_pin(flax_tiny, pins, attn_impl):
    """f32 slice on the bridged PRNGKey(0) params against the committed
    golden output, atol 2e-5 (the f32 conditioning bound of the flagship
    is 8.8e-6; this tiny config reproduces to ~5e-7)."""
    _, _, flat = flax_tiny
    with torch.inference_mode():
        got = _port(flat, attn_impl=attn_impl)(
            torch.from_numpy(pins["transunet/x"])).numpy()
    want = pins["transunet/y"]
    assert got.shape == want.shape == (1, 64, 80, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_bf16_forward_matches_jax_fused_stack(flax_tiny, pins):
    """bf16 slice (K1 stack with folded encoder_norm, plain version on the
    CPU) against the JAX bf16 forward through transformer_stack_fused in
    interpret mode: max abs probability difference <= 0.02."""
    _, v, flat = flax_tiny
    x = pins["transunet/x"]
    jmodel = JaxTransUNet(**TINY, attn_impl="pallas")
    jax_common.set_compute_dtype("bfloat16")
    try:
        want = np.asarray(jax.jit(jmodel.apply, static_argnums=(2,))(
            v, jnp.asarray(x), False), np.float32)
    finally:
        jax_common.set_compute_dtype(None)
    with torch.inference_mode():
        got = _port(flat, attn_impl="kernel",
                    compute_dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.02


def test_kernel_and_plain_routes_agree_on_cpu(flax_tiny, pins):
    """On CPU tensors the kernel wrappers run their plain versions: the
    kernel route and the same model under kernels.plain_versions() must be
    bitwise equal, in f32 and bf16."""
    _, _, flat = flax_tiny
    x = torch.from_numpy(pins["transunet/x"])
    for dt in (torch.float32, torch.bfloat16):
        with torch.inference_mode():
            m = _port(flat, attn_impl="kernel", compute_dtype=dt)
            a = m(x)
            with K.plain_versions():
                b = m(x)
        assert torch.equal(a, b), dt


def test_random_flax_variables_cover_the_tree():
    """The seeded stand-in for a checkpoint has the flax tree of the model
    and loads strictly; probabilities are finite and sum to 1."""
    m = TransUNet(**TINY)
    flat = bridge.random_flax_variables(m, seed=3)
    assert set(flat) == set(bridge.to_flax(m.state_dict()))
    again = bridge.random_flax_variables(m, seed=3)
    assert all(np.array_equal(flat[k], again[k]) for k in flat)
    m.load_state_dict(bridge.from_flax(flat), strict=True)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 64, 80, 10)).astype(np.float32))
    with torch.inference_mode():
        p = m.eval()(x)
    assert p.shape == (2, 64, 80, 3)
    assert torch.isfinite(p).all()
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 64, 80))
