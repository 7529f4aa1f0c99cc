"""PyTorch port vs the JAX package: int8 weight-only serving
(``infer/quantize.py``).  ``quantize_params`` on the same flax tree gives
bit-equal ``q`` and ``scale`` (the tiny TransUNet's scan-stacked encoder
kernels and its ResNeSt stages' 6-D kernels included), the int8 forward
matches JAX's ``make_quantized_forward`` within 2e-5, the device holds int8
kernels, the exported int8 forward (symbolic and static batch) matches the
eager one and JAX's int8 artifact, and the bridge's tensor layouts equal its
numpy ones for every family."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.infer import quantize as jqz
from ultrasound_modeling_tpu.utils.checkpoint import flatten_params
from ultrasound_modeling_tpu_torch.config import default_config
from ultrasound_modeling_tpu_torch.infer import quantize as qz
from ultrasound_modeling_tpu_torch.models.registry import build_model
from ultrasound_modeling_tpu_torch.utils import checkpoint as bridge
from test_torch_evaluate import (  # noqa: F401  (two_threads: autouse)
    TOL, frames, jax_state, port_model, two_threads)
from test_torch_export import STATIC, check_round_trip


def _params_flat():
    _, state, flat = jax_state()
    return state, {k: v for k, v in flat.items() if k.startswith("params/")}


def test_quantize_params_bit_equal_to_jax():
    state, flat = _params_flat()
    want = {k: np.asarray(v) for k, v in flatten_params(
        {"params": jqz.quantize_params(state.params)}).items()}
    got = {}
    for k, v in qz.quantize_params(flat).items():
        if qz._is_qleaf(v):
            got[k + "/q"], got[k + "/scale"] = v["q"], v["scale"]
        else:
            got[k] = v
    assert set(got) == set(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert np.array_equal(got[k], a), k
    quantized = {k[:-2] for k in got if k.endswith("/q")}
    # a scan-stacked kernel shares one scale per column over its layers
    assert "params/encoder/blocks/block/attn/query_kernel" in quantized
    assert want["params/encoder/blocks/block/attn/query_kernel/scale"].shape == (
        1, 1, 64)
    assert any(flat[k].ndim == 6 for k in quantized)      # [K, R, kh, kw, in, out]


def test_quantized_fraction_equals_jax():
    state, flat = _params_flat()
    got = qz.quantized_fraction(qz.quantize_params(flat))
    want = jqz.quantized_fraction(jqz.quantize_params(state.params))
    assert got == want
    assert got > 0.8


def test_quantize_leaf_error_bounded():
    w = np.random.default_rng(0).normal(size=(3, 3, 32, 64)).astype(np.float32)
    q = qz._quantize_leaf(w)
    assert q["q"].dtype == np.int8 and q["scale"].shape == (1, 1, 1, 64)
    deq = q["q"].astype(np.float32) * q["scale"]
    assert np.all(np.abs(deq - w) <= q["scale"] * 0.5 + 1e-7)


def test_int8_forward_matches_jax():
    model, state, _ = jax_state()
    x = frames(2, seed=6)
    want = np.asarray(jqz.make_quantized_forward(model, state)(jnp.asarray(x)))
    fwd = qz.make_quantized_forward(port_model(), torch.device("cpu"))
    got = fwd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # and it is not the f32 forward
    with torch.no_grad():
        f32 = port_model()(torch.from_numpy(x)).numpy()
    assert np.abs(got - f32).max() > 1e-4


def test_int8_forward_holds_int8_kernels_on_the_device():
    """The module's buffers are all it holds: int8 kernels with their
    scales, the small leaves in f32; its weights() rebuild exactly the
    model's state_dict names and shapes, the model's own tensors untouched."""
    model = port_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qf = qz.QuantizedForward(model, torch.device("cpu"))
    q = [b for n, b in qf.named_buffers() if n.startswith("q")]
    assert q and all(b.dtype == torch.int8 for b in q)
    f32_bytes = sum(v.numel() * 4 for v in before.values())
    assert qf.resident_bytes() < 0.45 * f32_bytes
    w = qf.weights()
    sd = model.state_dict()
    assert set(w) == set(sd)
    for k, v in sd.items():
        assert w[k].shape == v.shape and w[k].is_contiguous(), k
        assert torch.equal(v, before[k]), k
    # q * scale on the device, moved by the tensor layouts, equals q *
    # scale on the host moved by the numpy bridge
    qd = qz.quantize_params(bridge.to_flax(sd))
    deq = bridge.from_flax({k: (v["q"].astype(np.float32) * v["scale"]
                                if qz._is_qleaf(v) else v)
                            for k, v in qd.items()})
    for k, v in deq.items():
        assert torch.equal(w[k], v), k


@pytest.mark.parametrize("batch", [None, STATIC])
def test_exported_int8_forward_round_trip(tmp_path, batch):
    check_round_trip(tmp_path, batch, "int8")


def _tiny_model(family: str):
    mc = default_config(family).model
    small = {"transunet": dict(hidden_size=64, num_layers=2, num_heads=2,
                               mlp_dim=64, grid=(4, 5), img_size=(64, 80)),
             "vit": dict(vit_hidden=128, vit_layers=2, vit_heads=2, mlp_dim=64,
                         vit_grid=(8, 5), img_size=(64, 80)),
             "swin": dict(swin_embed_dim=16, swin_depths=(2, 2),
                          swin_heads=(2, 4), img_size=(64, 80)),
             "resnest_unet": dict(radix=2, kpaths=2),
             "mobileunet": {}}[family]
    return build_model(dataclasses.replace(mc, **small))


@pytest.mark.parametrize("family", ["transunet", "vit", "swin",
                                    "resnest_unet", "mobileunet"])
def test_bridge_tensor_layouts_equal_the_numpy_ones(family):
    """bridge_leaf's tensor layouts (the int8 forward's per-call mapping, and
    from_flax's) invert to_flax's numpy ones bit for bit: each leaf of a
    state_dict taken to the flax layout on the host and back through
    bridge_leaf comes back as it was, stacked blocks included."""
    model = _tiny_model(family)
    want = bridge.from_flax(bridge.random_flax_variables(model, seed=3), family)
    got = {}
    for k, a in bridge.to_flax(want, family).items():
        for name, t in bridge.bridge_leaf(k, torch.from_numpy(a), family):
            got[name] = t.contiguous()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_int8_forward_under_bf16_runs_the_k1_stack():
    """Under bfloat16 the model casts the dequantized f32 weights as it
    always does: the int8 forward takes the K1 route (its plain version on
    the CPU) and stays close to the bf16 forward."""
    model = port_model(compute_dtype="bfloat16")
    x = torch.from_numpy(frames(2, seed=7))
    fwd = qz.make_quantized_forward(model, torch.device("cpu"))
    got = fwd(x)
    with torch.no_grad():
        want = model(x)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 80, 3)
    assert torch.isfinite(got).all()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    assert agree > 0.95
