"""PyTorch port vs the JAX package: serving export (``infer/export.py``).

The tiny TransUNet's eval forward, exported with ``torch.export`` (symbolic
and static batch), saved, loaded back and run: equal to the port's eager
forward within 1e-6 at batches 1 and 3 (a static artifact at its pinned
batch), and within 2e-5 of the JAX package's exported artifact of the same
weights (at batch 3, or the pinned one) (:func:`check_round_trip`; ``test_torch_quantize.py`` runs it on
the int8 forward).  The program keeps K1 and K4's forward as custom-op
nodes, and K2's forward (the split-attention branches' eval norm) too,
which an artifact loaded on the card runs as kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu.infer import export as jex
from ultrasound_modeling_tpu_torch.infer import export as ex
from ultrasound_modeling_tpu_torch.infer import quantize as qz
from test_torch_evaluate import (  # noqa: F401  (two_threads: autouse)
    H, TOL, W, frames, jax_state, model_cfgs, port_model, two_threads)

SAMPLE = (H, W, 10)
STATIC = 2


def _kernel_ops(exported):
    return sorted({str(n.target) for n in exported.graph.nodes
                   if str(n.target).startswith("ultrasound_port.")})


def check_round_trip(tmp_path, batch, quantize):
    """Export, save, load and run the tiny TransUNet's forward; hold it
    against the eager forward and the JAX package's artifact."""
    model = port_model()
    _, mcfg = model_cfgs()
    exported = ex.export_forward(mcfg, model, SAMPLE, batch=batch,
                                 quantize=quantize)
    assert _kernel_ops(exported) == ["ultrasound_port.group_flat_norm.default",
                                     "ultrasound_port.window_attention.default"]
    path = str(tmp_path / "m.pt2")
    ex.save_exported(exported, path)
    fn, shape, pinned = ex.load_exported_meta(path, torch.device("cpu"))
    assert shape == SAMPLE and pinned == batch

    eager = (qz.make_quantized_forward(model, torch.device("cpu")) if quantize
             else torch.no_grad()(model))
    _, jstate, _ = jax_state()
    jcfg, _ = model_cfgs()
    jpath = str(tmp_path / "m.stablehlo")
    jex.save_exported(jex.export_forward(jcfg, jstate, SAMPLE, batch=batch,
                                         quantize=quantize), jpath)
    jfn = jex.load_exported(jpath)
    for b in ((1, 3) if batch is None else (batch,)):
        x = frames(b, seed=10 + b)
        got = fn(torch.from_numpy(x)).numpy()
        assert got.shape == (b, H, W, 3)
        np.testing.assert_allclose(got, eager(torch.from_numpy(x)).numpy(),
                                   rtol=0, atol=1e-6)
    # JAX's artifact at the last batch (each new batch is a JAX compile)
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))),
                               rtol=0, atol=TOL)
    if batch is not None:
        with pytest.raises(Exception):
            fn(torch.from_numpy(frames(batch + 1)))


@pytest.mark.parametrize("batch", [None, STATIC])
def test_exported_forward_round_trip(tmp_path, batch):
    check_round_trip(tmp_path, batch, None)


def test_bf16_export_keeps_the_k1_op(tmp_path):
    """Under bfloat16 the program calls K1 (one node a layer) and K2's
    forward (two nodes a split-attention stage), and its output equals the
    eager bf16 forward."""
    model = port_model(compute_dtype="bfloat16")
    _, mcfg = model_cfgs(compute_dtype="bfloat16")
    exported = ex.export_forward(mcfg, model, SAMPLE)
    assert _kernel_ops(exported) == ["ultrasound_port.group_flat_norm.default",
                                     "ultrasound_port.transformer_block.default"]
    assert sum(str(n.target) == "ultrasound_port.transformer_block.default"
               for n in exported.graph.nodes) == 2
    path = str(tmp_path / "bf16.pt2")
    ex.save_exported(exported, path)
    fn = ex.load_exported(path, torch.device("cpu"))
    x = torch.from_numpy(frames(3, seed=20))
    with torch.no_grad():
        want = model(x)
    np.testing.assert_allclose(fn(x).numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_cpu_artifact_refuses_the_card(tmp_path):
    """An artifact exported on the CPU holds its weights there and would run
    the kernels' plain versions on the CPU: loading it to serve on the card
    raises instead (no card is touched before the refusal)."""
    model = port_model()
    _, mcfg = model_cfgs()
    path = str(tmp_path / "cpu.pt2")
    ex.save_exported(ex.export_forward(mcfg, model, SAMPLE), path)
    with pytest.raises(ValueError, match="cannot run on cuda"):
        ex.load_exported_meta(path, torch.device("cuda"))
    with pytest.raises(ValueError, match="export it again with --device cuda"):
        ex.load_exported(path, "cuda")


def test_forward_ops_refuse_a_backward():
    """K1 and K4's forward ops have no gradient: with one being taken, their
    result raises on a backward instead of giving autograd's fallback's
    wrong gradients; without one, nothing changes."""
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    g = torch.Generator().manual_seed(0)
    c, heads = 16, 2
    x = torch.randn(3, 5, c, generator=g)
    qkv_w = torch.randn(3 * c, c, generator=g).requires_grad_()
    proj_w = torch.randn(c, c, generator=g)
    y = K.window_attention(x, qkv_w, None, proj_w, None, heads)
    with pytest.raises(RuntimeError, match="window_attention is a forward op"):
        y.sum().backward()
    with torch.no_grad():
        want = K.window_attention(x, qkv_w, None, proj_w, None, heads)
    assert torch.equal(y.detach(), want) and not want.requires_grad
    w = K.BlockWeights(*(t.to(torch.bfloat16) if t.ndim == 2 else t for t in (
        torch.ones(c), torch.zeros(c), torch.randn(3 * c, c, generator=g),
        torch.zeros(3 * c), torch.randn(c, c, generator=g), torch.zeros(c),
        torch.ones(c), torch.zeros(c), torch.randn(2 * c, c, generator=g),
        torch.zeros(2 * c), torch.randn(c, 2 * c, generator=g),
        torch.zeros(c))))
    xb = torch.randn(2, 4, c, generator=g).to(torch.bfloat16).requires_grad_()
    out = K.transformer_block(xb, w, heads, 0.5, 1e-6)
    with pytest.raises(RuntimeError, match="transformer_block is a forward op"):
        out.float().sum().backward()
